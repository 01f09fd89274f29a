"""The port's expert-parallel MoE (`repro_torch.models.moe_sharded`, the
`launch.mesh.ModelMesh` it runs over, `interop.place_expert_tables`)
against the reference's (`repro.models.moe_sharded`).

The reference's schedule is a `shard_map` over a real device mesh, so it
runs once per module in a subprocess with 4 forced host devices (as
`tests/test_perf_paths.py::test_shard_map_ep_matches_dense_moe` runs it),
which reads the inputs this file draws from a numpy seed and writes its
results to `tmp_path`.  The port's mesh is 4 times the host in this
process.  At the reference test's sizes (E 4, D 16, F 32, T 64, top-2,
swiglu) over the meshes (data, model) = (2, 2), (4, 1) and (1, 4): `y`
within 1e-4 (the reference's own bound for this module), `aux` (the mean
of the token shards' losses) within 1e-6, each shard's integer slots and
keep flags equal, both with capacity enough for every choice and with
capacity 16 (C_loc = 8: choices drop, and the dense MoE is another
function, so only the reference decides); the gradients of a scalar of `y`
for `x` and every table against `jax.grad` within 1e-4 of max(1, max).
The whole `transformer.forward` of llama4-maverick-400b-a17b and
jamba-1.5-large-398b at `reduced()` with `sharding_mode="ep_tp"` under
`use_mesh(make_model_mesh(2, 2, "cpu"))` against the reference's forward
under its (2, 2) mesh, its parameters carried across.  Port only: placed
tables give the unplaced tables' bits, each member's block is (E / ep, D,
F / tp) and a view on one device, the bytes split over the members, a
train step updates the placed blocks, and the refusals."""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import lm_params_from_numpy, place_expert_tables  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    ambient_mesh,
    axis_size,
    batch_axes,
    make_model_mesh,
    use_mesh,
)
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe_sharded as tms  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.layers import Init  # noqa: E402
from repro_torch.models.moe import moe_apply, moe_init, router_topk  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

E, D, F, T, K = 4, 16, 32, 64, 2
MESHES = [(2, 2), (4, 1), (1, 4)]
# capacity 80: the reference test's (twice moe_capacity(64, 2, 4, multiple=8)),
# room for every choice; 16: C_loc = max(8, 16 // ep) = 8 (16 at ep = 1) drops
CAPACITIES = {"no drops": 80, "drops": 16}
LM_ARCHS = ["llama4-maverick-400b-a17b", "jamba-1.5-large-398b"]
Y_ATOL = 1e-4               # tests/test_perf_paths.py's bound for this module
AUX_ATOL = 1e-6
GRAD_RTOL = 1e-4            # of max(1, max |want|)
LOGIT_RTOL = 1e-4           # of the largest |logit|, as tests/test_torch_lm.py

_REFERENCE = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS
from repro.launch.mesh import make_host_mesh, use_mesh
from repro.models import transformer as jt
from repro.models.moe import router_topk
from repro.models.moe_sharded import _local_dispatch, moe_apply_shard_map

inp = pickle.load(open(sys.argv[1], "rb"))
E, D, K = inp["E"], inp["D"], inp["K"]
p = {k: jnp.asarray(v) for k, v in inp["p"].items()}
x, r = jnp.asarray(inp["x"]), jnp.asarray(inp["r"])
out = {}
for dm, mm in inp["meshes"]:
    mesh = make_host_mesh(dm, mm)
    for name, cap in inp["capacities"].items():
        def f(p, x, cap=cap):
            return moe_apply_shard_map("swiglu", p, x, top_k=K, capacity=cap)
        with use_mesh(mesh):
            y, aux = jax.jit(f)(p, x)
            if name == "drops":
                gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x)[0] * r),
                                          argnums=(0, 1)))(p, x)
        C_loc = max(8, cap // dm)
        xt = x.reshape(-1, D)
        T_loc = xt.shape[0] // dm
        shards = []
        for s in range(dm):
            xs = xt[s * T_loc:(s + 1) * T_loc]
            gates, idx = router_topk(xs.astype(jnp.float32) @ p["router"], K)
            _, slot, keep = _local_dispatch(xs, gates, idx, E, C_loc, K)
            shards.append((np.asarray(slot), np.asarray(keep)))
        out[(dm, mm, name)] = {"y": np.asarray(y), "aux": float(aux), "shards": shards}
        if name == "drops":
            out[(dm, mm, name)]["grads"] = dict(
                {k: np.asarray(v) for k, v in gp.items()}, x=np.asarray(gx))
for arch in inp["archs"]:
    cfg = dataclasses.replace(ARCHS[arch].reduced(), sharding_mode="ep_tp")
    params = jt.init_params(cfg, jax.random.PRNGKey(1))
    toks = jnp.asarray(inp["tokens"])
    with use_mesh(make_host_mesh(2, 2)):
        logits, _, aux = jax.jit(lambda q, t: jt.forward(cfg, q, tokens=t))(params, toks)
    out[arch] = {"params": jax.tree.map(np.asarray, params),
                 "logits": np.asarray(logits), "aux": float(aux)}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _inputs() -> dict:
    rng = np.random.default_rng(7)
    p = {"router": rng.standard_normal((D, E)) / D ** 0.5,
         "w_gate": rng.standard_normal((E, D, F)) / D ** 0.5,
         "w_up": rng.standard_normal((E, D, F)) / D ** 0.5,
         "w_down": rng.standard_normal((E, F, D)) / F ** 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return {"E": E, "D": D, "K": K, "p": p,
            "x": rng.standard_normal((8, 8, D)).astype(np.float32),
            "r": rng.standard_normal((8, 8, D)).astype(np.float32),
            "meshes": MESHES, "capacities": CAPACITIES, "archs": LM_ARCHS,
            "tokens": rng.integers(0, 512, size=(2, 16)).astype(np.int32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs, and the reference's results over its 4-device meshes."""
    root = tmp_path_factory.mktemp("moe_sharded")
    inp = _inputs()
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(root / "inputs.pkl"),
                           str(root / "outputs.pkl")], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(root / "outputs.pkl", "rb") as f:
        return inp, pickle.load(f)


def _params(inp, requires_grad=False) -> dict:
    return {k: torch.from_numpy(v).requires_grad_(requires_grad) for k, v in inp["p"].items()}


def _port(inp, mesh_shape, cap, params=None, x=None):
    p = _params(inp) if params is None else params
    x = torch.from_numpy(inp["x"]) if x is None else x
    with use_mesh(make_model_mesh(*mesh_shape, "cpu")):
        return tms.moe_apply_shard_map("swiglu", p, x, top_k=K, capacity=cap)


@pytest.mark.parametrize("case", list(CAPACITIES))
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_moe_apply_shard_map_matches_the_reference(reference, mesh_shape, case):
    inp, out = reference
    want = out[(*mesh_shape, case)]
    y, aux = _port(inp, mesh_shape, CAPACITIES[case])
    assert y.shape == want["y"].shape
    assert float((y - torch.from_numpy(want["y"])).abs().max()) <= Y_ATOL
    assert abs(float(aux) - want["aux"]) <= AUX_ATOL


@pytest.mark.parametrize("case", list(CAPACITIES))
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_local_dispatch_slots_equal_the_reference(reference, mesh_shape, case):
    inp, out = reference
    ep, cap = mesh_shape[0], CAPACITIES[case]
    C_loc = max(8, cap // ep)
    xt = torch.from_numpy(inp["x"]).reshape(-1, D)
    T_loc = xt.shape[0] // ep
    router = torch.from_numpy(inp["p"]["router"])
    kept = 0
    for s, (slot, keep) in enumerate(out[(*mesh_shape, case)]["shards"]):
        xs = xt[s * T_loc:(s + 1) * T_loc]
        gates, idx = router_topk(xs @ router, K)
        buf, got_slot, got_keep = tms._local_dispatch(xs, gates, idx, E, C_loc, K)
        assert buf.shape == (E, C_loc, D)
        np.testing.assert_array_equal(got_slot.numpy(), slot)
        np.testing.assert_array_equal(got_keep.numpy(), keep)
        kept += int(keep.sum())
    total = xt.shape[0] * K
    assert (kept < total) == (case == "drops"), (kept, total)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_gradients_match_jax_grad(reference, mesh_shape):
    inp, out = reference
    want = out[(*mesh_shape, "drops")]["grads"]
    p = _params(inp, requires_grad=True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y, _ = _port(inp, mesh_shape, CAPACITIES["drops"], p, x)
    (y * torch.from_numpy(inp["r"])).sum().backward()
    got = {k: v.grad for k, v in p.items()}
    got["x"] = x.grad
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = torch.from_numpy(want[k])
        assert float((g - w).abs().max()) <= GRAD_RTOL * max(1.0, float(w.abs().max())), k


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_under_ep_tp_matches_the_reference(reference, arch):
    inp, out = reference
    want = out[arch]
    cfg = dataclasses.replace(ARCHS[arch].reduced(), sharding_mode="ep_tp")
    params = lm_params_from_numpy(want["params"], "cpu")
    toks = torch.from_numpy(inp["tokens"]).long()
    calls = []
    real = tms.moe_apply_shard_map

    def counted(*args, **kwargs):
        calls.append(kwargs["batch_axes"])
        return real(*args, **kwargs)
    with use_mesh(make_model_mesh(2, 2, "cpu")), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "moe_apply_shard_map", counted)
        logits, _, aux = tt.forward(cfg, params, tokens=toks)
    assert calls and all(b == ("data",) for b in calls)
    w = torch.from_numpy(want["logits"])
    assert float((logits - w).abs().max()) <= LOGIT_RTOL * float(w.abs().max())
    assert abs(float(aux) - want["aux"]) <= AUX_ATOL


# --------------------------------------------------------------------------- #
# the port alone: placement, the dense fallback, training, refusals
# --------------------------------------------------------------------------- #

def _lm(arch="llama4-maverick-400b-a17b"):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), sharding_mode="ep_tp")
    return cfg, tt.init_params(cfg, seed=0, device="cpu")


def _moe_layers(tree):
    if isinstance(tree, dict):
        if "router" in tree:
            yield tree
        else:
            for v in tree.values():
                yield from _moe_layers(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _moe_layers(v)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_placed_blocks_are_each_members_share(mesh_shape):
    cfg, params = _lm("jamba-1.5-large-398b")
    mesh = make_model_mesh(*mesh_shape, "cpu")
    placed = place_expert_tables(params, mesh)
    ep, tp = mesh_shape
    layers = list(zip(_moe_layers(params), _moe_layers(placed)))
    assert layers
    for table, blocks in layers:
        assert blocks["router"] is table["router"]
        for name in tms.EXPERT_TABLES:
            w, bl = table[name], blocks[name]
            assert isinstance(bl, list) and len(bl) == ep * tp
            lead, (E_, a, b) = w.shape[:-3], w.shape[-3:]
            want = (*lead, E_ // ep, a, b // tp) if name != "w_down" \
                else (*lead, E_ // ep, a // tp, b)
            for i, blk in enumerate(bl):
                d, t = divmod(i, mesh.model)
                assert blk.shape == want and blk.device == mesh.devices[i]
                # one device: a view of the table, no copy
                assert blk.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
                assert torch.equal(blk, tms.expert_block(w, name, d, t, ep, tp))
            sizes = {blk.numel() * blk.element_size() for blk in bl}
            assert sizes == {w.numel() * w.element_size() // (ep * tp)}
    # every other leaf is the same tensor
    assert placed["embed"] is params["embed"]


def test_placed_tables_give_the_unplaced_bits():
    cfg, params = _lm()
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 16))).long()
    mesh = make_model_mesh(2, 2, "cpu")
    with use_mesh(mesh):
        a = tt.forward(cfg, params, tokens=toks)[0]
        b = tt.forward(cfg, place_expert_tables(params, mesh), tokens=toks)[0]
    assert torch.equal(a, b)


def test_a_train_step_updates_the_placed_blocks():
    cfg, params = _lm()
    mesh = make_model_mesh(2, 2, "cpu")
    placed = place_expert_tables(params, mesh)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(2, 17))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = adamw(1e-3)
    step = tlm.make_train_step(cfg, opt)
    with use_mesh(mesh):
        loss_a, new_a, _ = step(params, opt.init(params), batch)
        loss_b, new_b, state_b = step(placed, opt.init(placed), batch)
    assert torch.equal(loss_a, loss_b)
    assert len(tree_leaves(state_b)) > 0
    for before, table, blocks in zip(_moe_layers(params), _moe_layers(new_a),
                                     _moe_layers(new_b)):
        for name in tms.EXPERT_TABLES:
            assert not torch.equal(table[name], before[name])
            for i, blk in enumerate(blocks[name]):
                d, t = divmod(i, mesh.model)
                assert torch.equal(blk, tms.expert_block(table[name], name, d, t, 2, 2))


def test_ep_tp_without_a_fitting_mesh_runs_the_dense_moe():
    cfg, params = _lm()
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, 16))).long()
    dense = tt.forward(dataclasses.replace(cfg, sharding_mode="fsdp_tp"), params,
                       tokens=toks)[0]
    assert ambient_mesh() is None
    assert torch.equal(tt.forward(cfg, params, tokens=toks)[0], dense)
    with use_mesh(make_model_mesh(3, 1, "cpu")):     # 3 does not divide 4 experts
        assert torch.equal(tt.forward(cfg, params, tokens=toks)[0], dense)


def test_model_mesh_rules():
    mesh = make_model_mesh(2, 2, "cpu")
    assert mesh.shape == {"data": 2, "model": 2} and len(mesh.devices) == 4
    assert mesh.device(1, 0) == mesh.devices[2] and mesh.lead == torch.device("cpu")
    assert batch_axes(mesh) == ("data",) and axis_size(mesh, "pod") == 1
    assert tms.ambient_mesh_shape() == {}
    with use_mesh(mesh):
        assert tms.ambient_mesh_shape() == {"data": 2, "model": 2}
        with use_mesh(make_model_mesh(4, 1, "cpu")):
            assert tms.ambient_mesh_shape()["data"] == 4
        assert ambient_mesh() is mesh
    assert ambient_mesh() is None
    given = make_model_mesh(1, 2, ["cpu", "cpu"])
    assert given.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_model_mesh(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError):
        make_model_mesh(0, 1, "cpu")
    with pytest.raises(TypeError):
        with use_mesh((2, 2)):
            pass


def test_refusals():
    inp = _inputs()
    p = _params(inp)
    x = torch.from_numpy(inp["x"])
    with pytest.raises(ValueError, match="ambient mesh"):
        tms.moe_apply_shard_map("swiglu", p, x, top_k=K, capacity=80)
    with use_mesh(make_model_mesh(2, 2, "cpu")):
        with pytest.raises(ValueError, match="gated"):
            tms.moe_apply_shard_map("gelu", p, x, top_k=K, capacity=80)
        with pytest.raises(ValueError, match="batch_axes"):
            tms.moe_apply_shard_map("swiglu", p, x, top_k=K, capacity=80,
                                    batch_axes=("model",))
    with use_mesh(make_model_mesh(3, 1, "cpu")):
        with pytest.raises(ValueError, match="do not split"):
            tms.moe_apply_shard_map("swiglu", p, x, top_k=K, capacity=80)
    cfg, params = _lm()
    with pytest.raises(ValueError, match="do not split"):
        place_expert_tables(params, make_model_mesh(3, 1, "cpu"))
    plain = {"moe": moe_init(Init(torch.Generator().manual_seed(0), torch.device("cpu")),
                             "gelu", D, F, E, torch.float32)}
    with pytest.raises(ValueError, match="gated"):
        place_expert_tables(plain, make_model_mesh(2, 1, "cpu"))


def test_dense_and_expert_parallel_agree_where_nothing_drops():
    """With room for every choice in both, the GShard schedule computes the
    dense MoE's y (the reference test's claim); aux is the mean of the
    shards' losses, not the global one."""
    inp = _inputs()
    p = _params(inp)
    x = torch.from_numpy(inp["x"])
    dense, _ = moe_apply("swiglu", p, x, top_k=K, capacity=CAPACITIES["no drops"] // 2)
    for mesh_shape in MESHES:
        y, _ = _port(inp, mesh_shape, CAPACITIES["no drops"])
        assert float((y - dense).abs().max()) <= Y_ATOL
