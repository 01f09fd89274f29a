"""`ObsSpec` — declarative observability configuration.

Copy of ``repro.obs.spec``: field names, defaults and validation are the
reference's, so an ``ExperimentSpec`` hashes to the same ``config_digest``
in both packages.  ``run`` acts on it as the reference's does: with
``enabled`` the simulator binds a ``FlightRecorder``
(``repro_torch.obs.recorder``) and the run writes its trace.  The one
difference is ``profile_dir``: the port wraps the run in
``torch.profiler.profile`` and writes ``torch_trace.json`` there, where the
reference wraps it in ``jax.profiler.trace``.

Observability is *out of band* by contract: it may time and count but never
perturb, so ``ObsSpec`` is deliberately excluded from
``ExperimentSpec.config_digest()`` — trace-on and trace-off runs of the same
experiment share a replay recipe (and the invariance tests pin that their
event logs, block hashes and balances are bit-identical).
"""
from __future__ import annotations

from dataclasses import dataclass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class ObsSpec:
    """Flight-recorder configuration (``ExperimentSpec.obs``).

    ``enabled`` is the master switch: when False (the default) the simulator
    binds the shared no-op recorder and the hot path pays only a handful of
    no-op method calls per round (< 0.1% of a steady round).
    """
    enabled: bool = False
    trace_path: str = "trace.jsonl"   # JSONL sink; sha256 lands in the manifest
    chrome_path: str | None = None    # optional Chrome/Perfetto trace export
    console: bool = False             # print the per-phase summary table
    block_until_ready: bool = True    # sync device inside timed spans so a
                                      # span's wall time covers the device work
                                      # it launched (timing only — never values)
    profile_dir: str | None = None    # wrap the run in torch.profiler
    sample_cap: int = 2048            # streaming-summary reservoir size

    def __post_init__(self):
        _check(isinstance(self.trace_path, str) and self.trace_path != "",
               "trace_path must be a non-empty string")
        _check(self.sample_cap >= 8,
               f"sample_cap must be >= 8, got {self.sample_cap}")
        for name in ("chrome_path", "profile_dir"):
            v = getattr(self, name)
            _check(v is None or (isinstance(v, str) and v != ""),
                   f"{name} must be None or a non-empty string, got {v!r}")
