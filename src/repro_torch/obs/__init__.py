from repro_torch.obs.recorder import NULL_RECORDER, NullRecorder  # noqa: F401
