"""`repro_torch.sim` — the event-driven federation simulator (port of
``repro.sim``; the driver is ``repro_torch.sim.driver``)."""
from repro_torch.sim.async_agg import (  # noqa: F401
    BufferedAggregator,
    BufferedUpdate,
    MergeResult,
    staleness_weight,
    weighted_delta_mean,
)
from repro_torch.sim.clock import LatencyModel, VirtualClock, make_speed_profile  # noqa: F401
from repro_torch.sim.events import Event, EventQueue  # noqa: F401
from repro_torch.sim.population import ClientPopulation, PopulationSpec  # noqa: F401
from repro_torch.sim.sampler import SAMPLERS, SamplerState, get_sampler  # noqa: F401
