"""Crash-consistent checkpoint/resume: the spec (``checkpoint.spec``), the
hardened snapshot files (``checkpoint.io``) and the capture and restore of
a run's complete state (``checkpoint.state``)."""
from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointError,
    checkpoint_path,
    list_checkpoints,
    load_latest,
    load_pytree,
    restore_trainer_state,
    save_checkpoint,
    save_pytree,
    save_trainer_state,
)
from repro_torch.checkpoint.spec import CheckpointSpec  # noqa: F401
from repro_torch.checkpoint.state import (  # noqa: F401
    capture_experiment_state,
    restore_experiment_state,
)
