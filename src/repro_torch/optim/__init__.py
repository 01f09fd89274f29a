from repro_torch.optim.optimizers import Optimizer, adam  # noqa: F401
