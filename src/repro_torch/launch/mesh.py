"""The client-axis device mesh of the sharded parameter arena.

Port of ``repro.launch.mesh``'s ``CLIENT_AXIS`` / ``make_client_mesh``.
The reference's mesh is one process driving S devices through GSPMD; the
port's is one process driving a tuple of S ``torch.device``s, with every
move between them an explicit copy (no ``torch.distributed``, no process
group).  The rest of ``repro.launch.mesh`` is GSPMD set-up and is not
ported.
"""
from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device

CLIENT_AXIS = "clients"


@dataclass(frozen=True)
class ClientMesh:
    """S devices along the client axis.  Shard ``j`` of the arena and slice
    ``j`` of every cohort live on ``devices[j]``; the cross-slot combine
    runs on ``lead`` (``devices[0]``).  Devices may repeat: S shards on one
    card, or S times the host."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a client mesh needs at least one device")

    @property
    def shards(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def make_client_mesh(shards: int, device=None) -> ClientMesh:
    """A mesh of ``shards`` devices along the client axis.

    ``device`` is ``"cpu"`` (S times the host, the counterpart of the
    reference's forced host devices), ``None`` or ``"cuda"`` (``cuda:0`` ..
    ``cuda:S-1``; raises when fewer cards exist, as the reference raises
    when fewer devices exist), or a sequence of S devices taken as given
    (repeats allowed: S shards on one card).  Nothing picks the CPU on its
    own."""
    if not isinstance(shards, int) or shards < 1:
        raise ValueError(f"make_client_mesh needs shards >= 1, got {shards!r}")
    if isinstance(device, Sequence) and not isinstance(device, str):
        devices = tuple(resolve_device(d) for d in device)
        if len(devices) != shards:
            raise ValueError(f"make_client_mesh({shards}) got {len(devices)} "
                             f"devices: {[str(d) for d in devices]}")
        return ClientMesh(devices)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return ClientMesh((resolve_device("cpu"),) * shards)
    if dev.type == "cuda" and dev.index is None:
        resolve_device("cuda:0")              # raises without CUDA
        avail = torch.cuda.device_count()
        if shards > avail:
            raise ValueError(
                f"make_client_mesh({shards}) needs {shards} CUDA devices but "
                f"only {avail} exist; pass a sequence of {shards} devices to "
                "put several shards on one card")
        return ClientMesh(tuple(torch.device("cuda", j) for j in range(shards)))
    if shards == 1:
        return ClientMesh((resolve_device(dev),))
    raise ValueError(
        f"make_client_mesh({shards}) takes 'cpu', 'cuda' or a sequence of "
        f"{shards} devices, got the single device {dev}")
