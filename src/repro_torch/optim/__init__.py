from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adam,
    adamw,
    clip_by_global_norm,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    cosine_decay_schedule,
    warmup_cosine_schedule,
)
