"""Batched multi-model serving engine: one forward answers a mixed batch.

Port of ``repro.serve.engine``.  The forward runs ``classifier.apply_stacked``
over all K cluster models and routes a mixed batch — each request bound for
a different cluster model — with a per-request gather over the ``(K, B, C)``
stacked logits.

  * **replayable**: no clocks, no RNG, no host round-trips inside the
    forward; each request's output depends only on its own row and its
    routed model — bit for bit, whatever the batch size, because the
    classifier sums every product in a fixed order
    (``classifier.matmul_fixed_order``);
  * **provenance-gated**: construction runs :func:`verify_bank` against the
    chain — a bank that fails the refuse-to-serve gate never serves.

The reference's compile-cache audit (``cache_sizes`` / ``entry_names`` /
``lower_entry``) has no counterpart: PyTorch runs eagerly.  Where the
reference's forward reports its jit cache to the recorder, this one
reports the kernel libraries loaded (``kernels._build.load_counts``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import load_counts
from repro_torch.models import classifier as clf
from repro_torch.obs import NULL_RECORDER
from repro_torch.serve.snapshot import ModelBank, ProvenanceError, verify_bank


class ServingEngine:
    """Chain-verified multi-model forward over a :class:`ModelBank`, on the
    device the bank lives on.

    ``chain`` is required unless ``verify=False`` (reserved for analysis
    probes and oracle paths that state why they skip the gate).
    """

    def __init__(self, bank: ModelBank, chain=None, *, verify: bool = True,
                 obs=NULL_RECORDER):
        if verify:
            if chain is None:
                raise ProvenanceError(
                    "refusing to serve: ServingEngine needs the chain to "
                    "verify the bank's release (pass verify=False only for "
                    "non-serving probes)")
            verify_bank(bank, chain, obs=obs)
        self.bank = bank
        self.obs = obs
        self._models = bank.layout.unflatten(bank.data)   # views of the bank
        obs.set_gauge("serve.bank_bytes", bank.nbytes)

    def _inputs(self, x, cids) -> tuple[torch.Tensor, torch.Tensor]:
        dev = self.bank.data.device
        return (torch.as_tensor(x, dtype=torch.float32, device=dev),
                torch.as_tensor(cids, dtype=torch.long, device=dev))

    def forward(self, x, cids) -> torch.Tensor:
        """Answer a mixed batch: ``x`` (B, in_dim) requests, ``cids`` (B,)
        cluster routing — returns (B, num_classes) logits."""
        with self.obs.span("serve.batch", cat="serve") as sp:
            x, cids = self._inputs(x, cids)
            logits = clf.apply_stacked(self.bank.mcfg, self._models, x)  # (K, B, C)
            out = logits[cids, torch.arange(x.shape[0], device=x.device)]
            sp.set(batch=int(out.shape[0]))
        self.obs.inc("serve.batches")
        self.obs.compile_delta(load_counts())
        return out

    def forward_per_request(self, x, cids) -> torch.Tensor:
        """Reference path: route every request ALONE through its cluster
        model (one plain ``classifier.apply`` per request).  The oracle for
        the fused mixed-batch forward — test/bench use only."""
        x, cids = self._inputs(x, cids)
        rows = [clf.apply(self.bank.mcfg, self.bank.model_pytree(int(c)),
                          x[i:i + 1])[0]
                for i, c in enumerate(cids.tolist())]
        return torch.stack(rows)
