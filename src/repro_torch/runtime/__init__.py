from repro_torch.runtime.arena import (  # noqa: F401
    ArenaLayout,
    ParamArena,
    bitcast_u32,
)
