"""The pod-scale PAA target on the card (`cuda`-marked; each test decides
inside itself whether there is a card, and skips without one).  No JAX
here: the card is held against the port's own plain path on the CPU.

  * `fl_round_step` at a cut width (16 clients in 4 planted groups, 64 ->
    256 -> 256 -> 64) on the card against the same round on the CPU, for
    both `agg_method`s: labels equal, the Pearson matrix (the kernel on the
    card) within 1e-5, prototypes and new params within 1e-6;
  * the cluster-aggregation kernel bit for bit against `cluster_agg_plain`
    at (64, 2^22) float32 rows in 8 planted clusters."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.kernels import cluster_agg as ca  # noqa: E402
from repro_torch.kernels import pearson as pe  # noqa: E402
from repro_torch.launch import fl_target as tfl  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

ATOL = 1e-6
CORR_ATOL = 1e-5
NOISE = 0.01          # of each leaf's standard deviation (1 / a) ** 0.5
CUT = tfl.FLTargetConfig(n_clients=16, in_dim=64, hidden=256, rep_dim=64, psi=16,
                         n_clusters=4)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _planted(cfg, gen):
    """Stacked CPU params: client i is group i % n_clusters's base tower
    plus noise, and a probe batch."""
    bases = [tfl.init_client_params(cfg, gen, device="cpu") for _ in range(cfg.n_clusters)]
    stacked = {}
    for k, shape in tfl.stacked_param_shapes(cfg).items():
        noise = torch.randn(shape, generator=gen) * (NOISE * (1 / shape[1]) ** 0.5)
        stacked[k] = torch.stack([bases[i % cfg.n_clusters][k]
                                  for i in range(cfg.n_clients)]) + noise
    return stacked, torch.randn((cfg.psi, cfg.in_dim), generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["mix", "two_step"])
def test_cuda_fl_round_step_equals_cpu(method):
    dev = _cuda()
    cfg = dataclasses.replace(CUT, agg_method=method)
    stacked, probe = _planted(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda x: x.to(dev), stacked)
    before = pe.launches
    new, labels, sizes = tfl.fl_round_step(cfg, card, probe.to(dev))
    torch.cuda.synchronize()
    assert pe.launches - before == 1
    want_new, want_labels, want_sizes = tfl.fl_round_step(cfg, stacked, probe)
    assert torch.equal(labels.cpu(), want_labels)
    assert torch.equal(sizes.cpu(), want_sizes) and int(sizes.sum()) == cfg.n_clients
    assert len(set(labels.tolist())) == cfg.n_clusters
    got = tagg.paa_round(tfl.embed_fn, card, probe.to(dev), cfg.n_clusters,
                         agg_method=method)
    want = tagg.paa_round(tfl.embed_fn, stacked, probe, cfg.n_clusters, agg_method=method)
    assert float((got.corr.cpu() - want.corr).abs().max()) <= CORR_ATOL
    assert float((got.prototypes.cpu() - want.prototypes).abs().max()) <= ATOL
    for k in tfl.LEAVES:
        assert float((new[k].cpu() - want_new[k]).abs().max()) <= ATOL, k


@pytest.mark.cuda
def test_cuda_cluster_agg_bit_for_bit_at_a_wide_leaf():
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randn((64, 1 << 22), generator=gen, device=dev)
    labels = torch.arange(64, device=dev) % 8
    wo, denom = ca.cluster_weights(labels, 8)
    got = ca.cluster_agg_cuda(rows, labels, wo, denom)
    want = ca.cluster_agg_plain(rows, labels, wo, denom)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
