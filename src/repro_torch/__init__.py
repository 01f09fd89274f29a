"""`repro_torch` — the PyTorch/CUDA port of the BFLN reproduction.

A sibling of the JAX package `repro`, laid out module for module like it
(``repro_torch/serve/snapshot.py`` is the port of
``repro/serve/snapshot.py``, and so on).  The port imports ``torch`` and
numpy only — never ``jax`` and nothing of ``repro``; what it needs of a
host-only ``repro`` module it keeps as its own copy.  Every TPU kernel on a
ported path is a hand-written Hopper kernel under ``kernels/csrc``, built
at first use (``repro_torch.kernels._build``).

Devices are explicit: an entry point given ``device=None`` runs on the
card and raises when there is none (``repro_torch.device``); the CPU runs
only when the caller asks for it, as the tests do.

Ported so far: the serving path (``repro_torch.serve``) with everything it
reaches — arena, fingerprint kernel, classifier, chain, virtual clock; the
BFLN training round (``repro_torch.api.run``) with the Pearson and
cluster-aggregation kernels; and the LM zoo's inference path
(``repro_torch.models.{transformer,decode,lm}``, ``repro_torch.configs``)
with the flash-attention and RWKV6 wkv kernels.
"""
