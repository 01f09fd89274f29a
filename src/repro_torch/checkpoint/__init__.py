"""Checkpoint/resume configuration: the spec only, as data (``checkpoint.spec``)."""
