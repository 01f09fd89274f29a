from repro_torch.sim.clock import VirtualClock  # noqa: F401
