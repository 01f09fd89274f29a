"""Placed expert tables (`interop.place_expert_tables`) made whole again:
`interop.unplace_expert_tables`, decoding (`models/lm.py`) and trainer
checkpoints (`checkpoint/io.py`).

The reference's ep-sharded arrays are whole arrays, so its decode and its
checkpoints take a trained tree as it is.  The port's placed tables are
lists of member blocks; these tests hold the port to the reference's
behaviour on llama4-maverick-400b-a17b's and jamba-1.5-large-398b's
`reduced()` under `sharding_mode="ep_tp"`, at the meshes (data, model) =
(2, 2), (4, 1) and (1, 4) of host members: unplacing inverts placing bit
for bit, leaf by leaf; `greedy_generate` on placed tables, before (at
one mesh) and after one AdamW step on them, gives the tokens of the
unplaced tables after the same step; a `save_trainer_state` / `restore_trainer_state`
round trip of the placed, trained tree gives whole tables in the shapes of
the reference's parameter tree (`jax.eval_shape` of its `init_params`),
parameters and AdamW moments alike, equal bit for bit to the unplaced
step's; a serve step unplaces once, not per token; placed tables with no
ambient mesh raise a ValueError that says so."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.checkpoint.io import restore_trainer_state, save_trainer_state  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import place_expert_tables, unplace_expert_tables  # noqa: E402
from repro_torch.launch.mesh import make_model_mesh, use_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe_sharded as tms  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

MESHES = [(2, 2), (4, 1), (1, 4)]
LM_ARCHS = ["llama4-maverick-400b-a17b", "jamba-1.5-large-398b"]
CASES = [(arch, mesh) for arch in LM_ARCHS for mesh in MESHES]
IDS = [f"{arch.split('-')[0]}-{d}x{m}" for arch, (d, m) in CASES]
PROMPT, NEW, SEQ = 2, 3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' tensors are small: one intra-op thread each.
    Under the suite's parallel workers the default (one thread per core in
    every worker) oversubscribes the cores; this file took 664 s instead of
    12 s with five other busy workers beside it on 8 cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lm(arch):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), sharding_mode="ep_tp")
    return cfg, tt.init_params(cfg, seed=0, device="cpu")


def _flat(tree, path=""):
    """{path: leaf} of nested dicts and lists (sorted keys), any leaf type."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: tree}


def _assert_bits_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for path, x in w.items():
        y = g[path]
        if not isinstance(x, torch.Tensor):
            assert y == x, path
            continue
        assert isinstance(y, torch.Tensor), path
        assert y.shape == x.shape and y.dtype == x.dtype and y.device == x.device, path
        assert torch.equal(y, x), path


def _batch(cfg, seed):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(2, 17))).long()
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def trained(request):
    """One AdamW step on the placed tables and on the same tables unplaced,
    under the mesh: (arch, cfg, mesh, placed (params, state), whole
    (params, state)).  Module-scoped, so each case's steps run once for the
    tests that read them, which pytest runs together."""
    arch, mesh_shape = request.param
    cfg, params = _lm(arch)
    mesh = make_model_mesh(*mesh_shape, "cpu")
    placed = place_expert_tables(params, mesh)
    opt = adamw(1e-2)
    step = tlm.make_train_step(cfg, opt)
    batch = _batch(cfg, 4)
    with use_mesh(mesh):
        _, p_placed, s_placed = step(placed, opt.init(placed), batch)
        _, p_whole, s_whole = step(params, opt.init(params), batch)
    return arch, cfg, mesh, (p_placed, s_placed), (p_whole, s_whole)


def _prompt(cfg):
    return torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, PROMPT))).long()


@pytest.mark.parametrize(("arch", "mesh_shape"), CASES, ids=IDS)
def test_unplace_inverts_place(arch, mesh_shape):
    cfg, params = _lm(arch)
    mesh = make_model_mesh(*mesh_shape, "cpu")
    placed = place_expert_tables(params, mesh)
    assert tms.holds_placed_tables(placed) and not tms.holds_placed_tables(params)
    whole = unplace_expert_tables(placed, mesh)
    _assert_bits_equal(whole, params)
    assert not tms.holds_placed_tables(whole)
    # dense tables pass through as the same tensors
    again = unplace_expert_tables(params, mesh)
    assert all(a is b for a, b in zip(_flat(again).values(), _flat(params).values()))


def test_decode_of_placed_trained_tables(trained):
    _, cfg, mesh, (p_placed, _), (p_whole, _) = trained
    prompt = _prompt(cfg)
    with use_mesh(mesh):
        got = tlm.greedy_generate(cfg, p_placed, prompt, NEW, SEQ)
    want = tlm.greedy_generate(cfg, p_whole, prompt, NEW, SEQ)
    assert got.shape == (2, PROMPT + NEW) and torch.equal(got, want)


def test_decode_of_placed_untrained_tables():
    cfg, params = _lm(LM_ARCHS[1])
    mesh = make_model_mesh(2, 2, "cpu")
    prompt = _prompt(cfg)
    with use_mesh(mesh):
        got = tlm.greedy_generate(cfg, place_expert_tables(params, mesh), prompt, NEW, SEQ)
    assert torch.equal(got, tlm.greedy_generate(cfg, params, prompt, NEW, SEQ))


def test_checkpoint_of_placed_trained_tables(trained, tmp_path):
    arch, cfg, mesh, (p_placed, s_placed), (p_whole, s_whole) = trained
    path = str(tmp_path / "trainer.ckpt")
    with use_mesh(mesh):
        save_trainer_state(path, p_placed, s_placed, 1, {"arch": arch})
    params, state, round_idx, extra = restore_trainer_state(path, "cpu")
    assert round_idx == 1 and extra == {"arch": arch}
    assert not tms.holds_placed_tables(params) and not tms.holds_placed_tables(state)
    _assert_bits_equal(params, p_whole)
    _assert_bits_equal(state, s_whole)
    # the reference's layout: its parameter tree's shapes, which its AdamW
    # moments mirror
    ref = jax.eval_shape(lambda: jt.init_params(dataclasses.replace(
        JARCHS[arch].reduced(), sharding_mode="ep_tp"), jax.random.PRNGKey(0)))
    want = {k: tuple(v.shape) for k, v in _flat(ref).items()}
    for tree in (params, state["m"], state["v"]):
        assert {k: tuple(v.shape) for k, v in _flat(tree).items()} == want
    # the caller places the restored tables again
    again = place_expert_tables(params, mesh)
    _assert_bits_equal(again, place_expert_tables(p_whole, mesh))


def test_serve_step_unplaces_once(monkeypatch):
    cfg, params = _lm(LM_ARCHS[0])
    mesh = make_model_mesh(2, 2, "cpu")
    placed = place_expert_tables(params, mesh)
    calls = []
    real = tlm.whole_expert_tables

    def counted(tree, what):
        calls.append(what)
        return real(tree, what)
    monkeypatch.setattr(tlm, "whole_expert_tables", counted)
    tok = _prompt(cfg)[:, :1]
    step = tlm.make_serve_step(cfg)
    dense = tlm.make_serve_step(cfg)
    cache, cache_d = (tlm.init_cache(cfg, 2, SEQ, device="cpu") for _ in range(2))
    with use_mesh(mesh):
        for _ in range(3):
            logits, cache = step(placed, cache, tok)
            want, cache_d = dense(params, cache_d, tok)
            assert torch.equal(logits, want)
        assert len(calls) == 1
        step(place_expert_tables(params, mesh), cache, tok)     # new blocks
        assert len(calls) == 2
        tlm.greedy_generate(cfg, placed, _prompt(cfg), NEW, SEQ)
        assert len(calls) == 3              # once before the loop, none a token


def test_placed_tables_without_a_mesh_raise(tmp_path):
    cfg, params = _lm(LM_ARCHS[0])
    placed = place_expert_tables(params, make_model_mesh(2, 2, "cpu"))
    prompt = _prompt(cfg)
    with pytest.raises(ValueError, match="ambient mesh"):
        tlm.greedy_generate(cfg, placed, prompt, NEW, SEQ)
    with pytest.raises(ValueError, match="ambient mesh"):
        tlm.make_serve_step(cfg)(placed, tlm.init_cache(cfg, 2, SEQ, device="cpu"),
                                 prompt[:, :1])
    opt = adamw(1e-3)
    with pytest.raises(ValueError, match="ambient mesh"):
        save_trainer_state(str(tmp_path / "t.ckpt"), placed, opt.init(params), 0)
    with pytest.raises(ValueError, match="ambient mesh"):
        save_trainer_state(str(tmp_path / "t.ckpt"), params, opt.init(placed), 0)
    # whole tables need no mesh
    save_trainer_state(str(tmp_path / "t.ckpt"), params, opt.init(params), 0)


def test_unplace_refuses_blocks_that_do_not_fit_the_mesh():
    cfg, params = _lm(LM_ARCHS[1])
    placed = place_expert_tables(params, make_model_mesh(2, 2, "cpu"))
    with pytest.raises(ValueError, match="placed blocks"):
        unplace_expert_tables(placed, make_model_mesh(2, 1, "cpu"))
    with pytest.raises(ValueError, match="do not split"):
        unplace_expert_tables(placed, make_model_mesh(3, 1, "cpu"))
