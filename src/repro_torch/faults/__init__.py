"""Fault injection: the seeded schedule (``faults.spec``) and the injector
that executes it (``faults.injector``)."""
from repro_torch.faults.injector import (  # noqa: F401
    NULL_INJECTOR,
    FaultInjector,
    InjectedCrash,
    NullInjector,
)
from repro_torch.faults.spec import CRASH_MODES, CRASH_PHASES, FaultSpec  # noqa: F401
