"""Device meshes: the client axis of the sharded parameter arena, and the
(data, model) mesh of the expert-parallel MoE.

Port of ``repro.launch.mesh``'s ``CLIENT_AXIS`` / ``make_client_mesh``
(the arena's mesh) and ``make_host_mesh`` / ``use_mesh`` / ``batch_axes`` /
``axis_size`` (the LM's mesh, which ``models/moe_sharded.py`` runs its
GShard schedule over).  The reference's mesh is one process driving
devices through GSPMD; the port's is one process driving a tuple or grid
of ``torch.device``s, with every move between them an explicit copy (no
``torch.distributed``, no process group: NCCL cannot put two ranks on one
card).  Devices may repeat, so S shards run on one card or on the host.
The rest of ``repro.launch.mesh`` (the production pod meshes, abstract
meshes, the XLA shims) is GSPMD set-up and is not ported.
"""
from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Iterator, Sequence
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


MESH_AXES = ("data", "model")


@dataclass(frozen=True)
class ModelMesh:
    """A row-major ``(data, model)`` grid of devices: ``devices[d * model +
    t]`` is the member at data index ``d`` and model index ``t``.  Devices
    may repeat (S members on one card, or S times the host), as in
    :class:`ClientMesh`.  ``lead`` (``devices[0]``) holds what is not
    sharded."""

    data: int
    model: int
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if self.data < 1 or self.model < 1 or len(self.devices) != self.data * self.model:
            raise ValueError(f"a ({self.data}, {self.model}) mesh needs "
                             f"{self.data * self.model} devices, got {len(self.devices)}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return MESH_AXES

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        return {"data": self.data, "model": self.model}

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def device(self, d: int, t: int) -> torch.device:
        """The member at data index ``d``, model index ``t``."""
        return self.devices[d * self.model + t]


def make_model_mesh(data: int = 1, model: int = 1, device=None) -> ModelMesh:
    """A ``(data, model)`` mesh (``make_host_mesh``'s counterpart).

    ``device`` takes the forms of :func:`make_client_mesh`: ``"cpu"``
    (every member the host), ``None`` or ``"cuda"`` (``cuda:0`` ..
    ``cuda:S-1`` in row-major order, S = data * model; raises when fewer
    cards exist), or a sequence of S devices taken as given (repeats
    allowed).  Nothing picks the CPU on its own."""
    for name, n in (("data", data), ("model", model)):
        if not isinstance(n, int) or n < 1:
            raise ValueError(f"make_model_mesh needs {name} >= 1, got {n!r}")
    shards = data * model
    if isinstance(device, Sequence) and not isinstance(device, str):
        devices = tuple(resolve_device(d) for d in device)
        if len(devices) != shards:
            raise ValueError(f"make_model_mesh({data}, {model}) got {len(devices)} "
                             f"devices: {[str(d) for d in devices]}")
        return ModelMesh(data, model, devices)
    return ModelMesh(data, model, make_client_mesh(shards, device).devices)


_AMBIENT: contextvars.ContextVar[ModelMesh | None] = contextvars.ContextVar(
    "repro_torch_ambient_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: ModelMesh) -> Iterator[ModelMesh]:
    """Make ``mesh`` the ambient mesh inside the ``with`` block (the
    reference's ``jax.set_mesh``): ``models/transformer.py`` reads it to
    take the expert-parallel MoE under ``sharding_mode="ep_tp"``."""
    if not isinstance(mesh, ModelMesh):
        raise TypeError(f"use_mesh takes a ModelMesh, got {type(mesh).__name__}")
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh() -> ModelMesh | None:
    """The mesh of the innermost :func:`use_mesh` block, or None."""
    return _AMBIENT.get()


def batch_axes(mesh: ModelMesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh: ModelMesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1
