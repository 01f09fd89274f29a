"""`FlightRecorder` — the always-out-of-band span tracer + metrics hub.

Port of ``repro.obs.recorder``: the same surface and the same record
layout, so a port trace reads like a reference trace.  One recorder rides
along one experiment run.  Instrumented code never checks whether tracing
is on: it calls ``obs.span(...)`` / ``obs.inc(...)`` unconditionally, and
when observability is disabled those calls land on the module-level
:data:`NULL_RECORDER` whose methods are no-ops.

Hard invariant (tested): the recorder only *times and counts*.  It never
draws from a seeded generator, never mutates simulation state, and never
forces a value that wasn't already being materialised — ``ready()`` may
wait for the card (so a span's wall time covers the kernels it launched:
CUDA launches return before the work is done) but waiting changes no bits.

Span records carry two clocks: host wall time (``ts_us``/``dur_us``,
microseconds since trace start) and the simulator's *virtual* clock (``vt``
at span close, plus a ``vt_dur`` attr when virtual time advanced inside the
span) — so a trace shows both where a round's milliseconds go and where its
simulated seconds go.

Compile events (:meth:`FlightRecorder.compile_delta`) take a dict of counts
per entry and emit one ``compile`` event per entry that grew.  The port has
no jit caches; what it feeds in is ``kernels._build.load_counts()``, one
count per CUDA library loaded (and built first, if its build was stale), so
a ``compile`` event names the kernel source that a round paid to load.  A
run on the CPU loads no library and records none.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spec import ObsSpec


def _cuda_devices(x: Any) -> list[torch.device]:
    """The distinct devices of the CUDA tensors among ``x``'s leaves, in
    the order first met (a mesh's outputs lie on several cards)."""
    if isinstance(x, torch.Tensor):
        return [x.device] if x.is_cuda else []
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (tuple, list)):
        return []
    out: list[torch.device] = []
    for leaf in x:
        out.extend(d for d in _cuda_devices(leaf) if d not in out)
    return out


class _Span:
    """A timed phase.  ``with rec.span("round.step", round=r) as sp: ...``;
    ``sp.set(k=v)`` attaches attributes before close."""

    __slots__ = ("_rec", "name", "cat", "round", "attrs", "_t0", "_vt0")

    def __init__(self, rec: "FlightRecorder", name: str, cat: str,
                 round_idx: int | None, attrs: dict):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.round = round_idx
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self._vt0 = self._rec._vt()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        rec = self._rec
        vt1 = rec._vt()
        if self._vt0 is not None and vt1 is not None and vt1 != self._vt0:
            self.attrs["vt_dur"] = vt1 - self._vt0
        dur_us = (t1 - self._t0) / 1e3
        record = {"kind": "span", "name": self.name, "cat": self.cat,
                  "round": self.round,
                  "ts_us": round((self._t0 - rec._t0) / 1e3, 3),
                  "dur_us": round(dur_us, 3), "vt": vt1}
        if self.attrs:
            record["attrs"] = self.attrs
        rec.records.append(record)
        rec.metrics.observe(self.name, dur_us / 1e3)      # summary in ms
        return False


class _NullSpan:
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """Shared no-op recorder bound when observability is disabled.  Keeps the
    exact `FlightRecorder` surface so instrumented code never branches."""

    __slots__ = ()
    enabled = False
    spec = ObsSpec()

    def span(self, name: str, *, cat: str = "round",
             round: int | None = None, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, *, round: int | None = None, **attrs) -> None:
        pass

    def point(self, name: str, value: float,
              round: int | None = None) -> None:
        pass

    def inc(self, name: str, value: float = 1.0) -> None:
        pass

    def set_gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def compile_delta(self, cache_sizes: dict,
                      round_idx: int | None = None) -> None:
        pass

    def ready(self, x: Any) -> Any:
        return x

    def bind_clock(self, clock: Callable[[], float] | None) -> None:
        pass

    def timing_summary(self) -> dict:
        return {}


NULL_RECORDER = NullRecorder()


class FlightRecorder:
    """Live recorder: spans/events/points into an in-memory record list,
    scalars into a :class:`MetricsRegistry`.  Sinks (`repro.obs.sinks`)
    serialise both at end of run."""

    enabled = True

    def __init__(self, spec: ObsSpec | None = None, *,
                 clock: Callable[[], float] | None = None):
        self.spec = spec if spec is not None else ObsSpec(enabled=True)
        self.records: list[dict] = []
        self.metrics = MetricsRegistry(sample_cap=self.spec.sample_cap)
        self._clock = clock
        self._t0 = time.perf_counter_ns()
        self._cache_prev: dict[str, int] = {}

    # -------------------------------------------------------------- #
    # clock plumbing
    # -------------------------------------------------------------- #

    def bind_clock(self, clock: Callable[[], float] | None) -> None:
        """Attach the simulator's virtual-clock reader (``lambda:
        clock.now``); spans then carry virtual time alongside wall time."""
        self._clock = clock

    def _vt(self) -> float | None:
        return self._clock() if self._clock is not None else None

    def _ts_us(self) -> float:
        return round((time.perf_counter_ns() - self._t0) / 1e3, 3)

    # -------------------------------------------------------------- #
    # recording surface (mirrored by NullRecorder)
    # -------------------------------------------------------------- #

    def span(self, name: str, *, cat: str = "round",
             round: int | None = None, **attrs) -> _Span:
        return _Span(self, name, cat, round, attrs)

    def event(self, name: str, *, round: int | None = None, **attrs) -> None:
        record = {"kind": "event", "name": name, "round": round,
                  "ts_us": self._ts_us()}
        if attrs:
            record["attrs"] = attrs
        self.records.append(record)

    def point(self, name: str, value: float,
              round: int | None = None) -> None:
        """One per-round metric observation, both recorded verbatim in the
        trace and folded into the streaming summary."""
        v = float(value)
        self.records.append({"kind": "point", "name": name, "round": round,
                             "value": v})
        self.metrics.observe(name, v)

    def inc(self, name: str, value: float = 1.0) -> None:
        self.metrics.inc(name, value)

    def set_gauge(self, name: str, value: float) -> None:
        self.metrics.set_gauge(name, value)

    def observe(self, name: str, value: float) -> None:
        self.metrics.observe(name, value)

    def compile_delta(self, cache_sizes: dict,
                      round_idx: int | None = None) -> None:
        """Emit a ``compile`` event per entry whose count grew since the
        last snapshot (``kernels._build.load_counts()``: a kernel library
        loaded)."""
        for entry, size in cache_sizes.items():
            d = size - self._cache_prev.get(entry, 0)
            if d > 0:
                self.event("compile", round=round_idx, entry=entry, n=d)
                self.inc("compiles", d)
        self._cache_prev = dict(cache_sizes)

    def ready(self, x: Any) -> Any:
        """Wait for the card (when configured) if ``x`` — a tensor, or a
        tuple / NamedTuple / list / dict of them — holds a CUDA tensor, so
        the enclosing span measures compute, not dispatch.  One
        ``torch.cuda.synchronize`` of each device that holds a leaf,
        however many leaves; CPU tensors and other values need none.  Reads
        no value: ``x`` is returned as the same object."""
        if self.spec.block_until_ready:
            for device in _cuda_devices(x):
                torch.cuda.synchronize(device)
        return x

    # -------------------------------------------------------------- #
    # derived readouts
    # -------------------------------------------------------------- #

    def timing_summary(self) -> dict:
        """The one-line readout: steady round latency, chain-overhead share,
        compile count — sourced purely from the metrics registry."""
        s = self.metrics.summaries
        total = s.get("round.total") or s.get("flush.total")
        chain = s.get("round.chain") or s.get("flush.chain")
        out = {"compiles": int(self.metrics.counters.get("compiles", 0))}
        if total is not None and total.count:
            out["rounds"] = total.count
            out["round_ms_p50"] = round(total.quantile(0.5), 3)
            out["round_ms_p99"] = round(total.quantile(0.99), 3)
            out["round_ms_mean"] = round(total.mean, 3)
        if chain is not None and total is not None and total.total > 0:
            out["chain_overhead_pct"] = round(
                100.0 * chain.total / total.total, 2)
        return out
