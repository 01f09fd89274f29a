"""Metrics registry: counters, gauges, and streaming quantile summaries.

Copy of ``repro.obs.metrics``, line for line: the same observations give
the same ``Summary.snapshot()`` in both packages.  Pure Python / stdlib.
A :class:`Summary` keeps exact count/sum/min/max plus a bounded, deterministically-thinned sample reservoir
for p50/p90/p99 estimates: when the reservoir fills, every other kept sample
is dropped and the keep stride doubles, so memory stays O(cap) over
arbitrarily long runs while the kept samples remain an even systematic
sample of the stream (no RNG — observability must never touch a seeded
generator).
"""
from __future__ import annotations

from dataclasses import dataclass, field


class Summary:
    """Streaming distribution summary for one metric series."""

    __slots__ = ("cap", "count", "total", "min", "max", "_samples", "_stride",
                 "_phase")

    def __init__(self, cap: int = 2048):
        if cap < 8:
            raise ValueError(f"cap must be >= 8, got {cap}")
        self.cap = int(cap)
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._samples: list[float] = []
        self._stride = 1          # keep every _stride-th observation
        self._phase = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._phase += 1
        if self._phase < self._stride:
            return
        self._phase = 0
        self._samples.append(v)
        if len(self._samples) >= self.cap:
            self._samples = self._samples[::2]     # systematic thinning
            self._stride *= 2

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile over the kept reservoir."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        pos = q * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    def snapshot(self) -> dict:
        """JSON-able summary record body (the JSONL ``summary`` kind)."""
        return {
            "count": self.count,
            "sum": round(self.total, 6),
            "mean": round(self.mean, 6),
            "min": round(self.min, 6) if self.min is not None else 0.0,
            "max": round(self.max, 6) if self.max is not None else 0.0,
            "p50": round(self.quantile(0.50), 6),
            "p90": round(self.quantile(0.90), 6),
            "p99": round(self.quantile(0.99), 6),
        }


@dataclass
class MetricsRegistry:
    """Named counters / gauges / summaries for one run."""

    sample_cap: int = 2048
    counters: dict[str, float] = field(default_factory=dict)
    gauges: dict[str, float] = field(default_factory=dict)
    summaries: dict[str, Summary] = field(default_factory=dict)

    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        s = self.summaries.get(name)
        if s is None:
            s = self.summaries[name] = Summary(self.sample_cap)
        s.observe(value)

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "summaries": {k: v.snapshot()
                          for k, v in sorted(self.summaries.items())},
        }
