"""The pod-scale PAA target (`repro_torch.launch.fl_target`) against the
reference's (`repro.launch.fl_target`) on the CPU, at a small width:
12 clients in 3 planted groups (each group's base tower from the
reference's `init_client_params`, each client that base plus noise at 1%
of each leaf's standard deviation), carried across as numpy.  For each
`agg_method` the port's `fl_round_step` gives the reference's labels and
cluster sizes, its new params within 1e-6, and `paa_round` with the port's
`embed_fn` gives the reference's Pearson matrix within 1e-5 and its
prototypes within 1e-6 (the tolerances of `tests/test_torch_paa.py`).
`round_cost` at the defaults equals the dry-run's terms computed by hand,
`stacked_param_shapes` the reference's `stacked_param_specs` shapes, and
`init_client_params` raises without CUDA unless the CPU is named."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregation as jagg  # noqa: E402
from repro.launch import fl_target as jfl  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import fl_target as tfl  # noqa: E402

ATOL = 1e-6
CORR_ATOL = 1e-5
GROUPS = 3
NOISE = 0.01          # of each leaf's standard deviation (1 / a) ** 0.5
SMALL = dict(n_clients=12, in_dim=16, hidden=32, rep_dim=8, psi=8, n_clusters=3)


def _planted(jcfg, seed=0):
    """(stacked numpy params, probe): client i is group i % GROUPS's base
    tower (the reference's init_client_params) plus noise."""
    bases = [jax.tree.map(np.asarray, jfl.init_client_params(jcfg, jax.random.PRNGKey(g)))
             for g in range(GROUPS)]
    rng = np.random.default_rng(seed)
    stacked = {}
    for k in tfl.LEAVES:
        a = bases[0][k].shape[0]
        rows = [bases[i % GROUPS][k] + NOISE * (1 / a) ** 0.5
                * rng.standard_normal(bases[0][k].shape).astype(np.float32)
                for i in range(jcfg.n_clients)]
        stacked[k] = np.stack(rows).astype(np.float32)
    probe = rng.standard_normal((jcfg.psi, jcfg.in_dim)).astype(np.float32)
    return stacked, probe


@pytest.mark.parametrize("method", ["mix", "two_step"])
def test_fl_round_step_matches_reference(method):
    jcfg = jfl.FLTargetConfig(**SMALL, agg_method=method)
    cfg = tfl.FLTargetConfig(**SMALL, agg_method=method)
    stacked, probe = _planted(jcfg)
    jstacked = {k: jnp.asarray(v) for k, v in stacked.items()}
    want_new, want_labels, want_sizes = jfl.fl_round_step(jcfg, jstacked, jnp.asarray(probe))
    want = jagg.paa_round(jfl.embed_fn, jstacked, jnp.asarray(probe), jcfg.n_clusters,
                          agg_method=method)

    tstacked = params_from_numpy(stacked, device="cpu")
    tprobe = torch.from_numpy(probe)
    new, labels, sizes = tfl.fl_round_step(cfg, tstacked, tprobe)
    got = tagg.paa_round(tfl.embed_fn, tstacked, tprobe, cfg.n_clusters, agg_method=method)

    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    assert len(set(labels.tolist())) == GROUPS
    # the planted groups, up to renaming
    planted = np.arange(cfg.n_clients) % GROUPS
    assert len(set(zip(planted, labels.tolist()))) == GROUPS
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    assert int(sizes.sum()) == cfg.n_clients
    np.testing.assert_array_equal(got.labels.numpy(), labels.numpy())
    np.testing.assert_allclose(got.corr.numpy(), np.asarray(want.corr), rtol=0, atol=CORR_ATOL)
    np.testing.assert_allclose(got.prototypes.numpy(), np.asarray(want.prototypes),
                               rtol=0, atol=ATOL)
    assert sorted(new) == sorted(want_new)
    for k in tfl.LEAVES:
        assert new[k].dtype == torch.float32 and new[k].shape == stacked[k].shape
        np.testing.assert_allclose(new[k].numpy(), np.asarray(want_new[k]), rtol=0, atol=ATOL)


def test_round_cost_at_the_defaults():
    cost = tfl.round_cost(tfl.FLTargetConfig())
    assert cost == {"n_params": 83_886_080, "fwd": 687_194_767_360,
                    "mixmm": 687_194_767_360, "flops_total": 2 * 687_194_767_360,
                    "hbm_bytes": 42_949_672_960}
    # 64 stacked float32 towers: 21.47 GB, read once and written once
    assert 64 * cost["n_params"] * 4 * 2 == cost["hbm_bytes"]


@pytest.mark.parametrize("fields", [{}, SMALL], ids=["defaults", "small"])
def test_stacked_param_shapes_match_reference(fields):
    want = jfl.stacked_param_specs(jfl.FLTargetConfig(**fields))
    got = tfl.stacked_param_shapes(tfl.FLTargetConfig(**fields))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k]) == want[k].shape and want[k].dtype == jnp.float32


def test_config_fields_match_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(tfl.FLTargetConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(jfl.FLTargetConfig)]


def test_init_client_params_distribution():
    cfg = tfl.FLTargetConfig(in_dim=256, hidden=512, rep_dim=128)
    params = tfl.init_client_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} \
        == {"w0": (256, 512), "w1": (512, 512), "w2": (512, 128)}
    for k, x in params.items():
        assert x.dtype == torch.float32 and x.device.type == "cpu"
        want = (1 / x.shape[0]) ** 0.5
        assert abs(float(x.std()) / want - 1) < 0.02, k
        assert abs(float(x.mean())) < 0.01 * want, k


def test_entry_point_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfl.init_client_params(tfl.FLTargetConfig(**SMALL), torch.Generator())
