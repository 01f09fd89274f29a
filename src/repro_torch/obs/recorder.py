"""The no-op recorder bound when observability is off.

Copy of ``repro.obs.recorder.NullRecorder``: instrumented code calls
``obs.span(...)`` / ``obs.inc(...)`` unconditionally, and with tracing off
those calls land here and do nothing.  Any object with the same surface
(the reference's ``FlightRecorder``, for one) can be passed as ``obs``
instead.  The port's own flight recorder comes with a later slice.
"""
from __future__ import annotations


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
    """Shared no-op recorder."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, *, cat: str = "round",
             round: int | None = None, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, *, round: int | None = None, **attrs) -> None:
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


NULL_RECORDER = NullRecorder()
