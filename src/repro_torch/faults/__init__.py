"""Fault-injection schedule: the spec only, as data (``faults.spec``)."""
