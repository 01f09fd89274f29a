"""Crash-consistent checkpoint files.

Port of ``repro.checkpoint.io``'s container (format v2):

    MAGIC "BFLNCKPT" | u32 format version | u64 header length
    | header JSON (payload sha256 + length) | npz payload

Durability: the file is staged to a temp file in the target directory,
``fsync``'d, atomically ``os.replace``'d into place, and the *directory* is
fsync'd afterwards — a crash (SIGKILL, power loss) at any point leaves
either the previous snapshot or the complete new one, never a torn file
under the final name.  On read the header's sha256 is checked before
anything is decoded, so a truncated or bit-flipped file raises a clean
:class:`CheckpointError`.

The payload holds numpy arrays and plain Python values only (dicts, lists,
tuples, numbers, strings, None): a tree of those whose arrays are stored
as npz members under their positions, its skeleton pickled beside them.
The caller brings tensors to the host first; encoding refuses anything
else, and decoding refuses any pickled object that is not a plain value
or a numpy array.  The reference's own files are not read.

Directory management (``save_checkpoint`` / ``load_latest``) keeps the
last K snapshots and falls back to the newest *readable* one when the
latest is corrupt.  ``save_trainer_state`` / ``restore_trainer_state`` keep
an LM trainer's tensors (parameters and optimizer state) in the same
container, a bfloat16 tensor as its uint16 bits tagged ``("bfloat16",
bits)``.
"""
from __future__ import annotations

import hashlib
import io as _io
import json
import os
import pickle
import re
import struct
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.moe_sharded import whole_expert_tables

Tree = Any

MAGIC = b"BFLNCKPT"
FORMAT_VERSION = 2
_HDR = struct.Struct("<IQ")           # format version, header length

_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.npz$")

_PLAIN = (bool, int, float, str, bytes, type(None), np.generic)
# what a payload's pickled skeleton may hold besides builtins' plain values
_NUMPY_NAMES = frozenset({"_reconstruct", "ndarray", "dtype", "scalar",
                          "_frombuffer"})


class CheckpointError(RuntimeError):
    """A checkpoint file is missing, truncated, corrupt, or incompatible."""


def _leaf_mark(x) -> bool:
    """A skeleton's placeholder for npz member ``leaf_<i>``:
    ``("__leaf__", i)``."""
    return isinstance(x, tuple) and len(x) == 2 and x[0] == "__leaf__"


class _PlainUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise CheckpointError(f"checkpoint payload holds {module}.{name}, "
                              "not a plain value")


# --------------------------------------------------------------------- #
# payload (npz) encode/decode
# --------------------------------------------------------------------- #


def _encode_payload(tree: Tree) -> bytes:
    arrays: dict[str, np.ndarray] = {}

    def skeleton(x):
        if isinstance(x, dict):
            return {k: skeleton(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            out = [skeleton(v) for v in x]
            return out if isinstance(x, list) else tuple(out)
        if isinstance(x, _PLAIN):
            return x                          # pickled in place
        if not isinstance(x, np.ndarray):
            raise TypeError(f"a checkpoint holds numpy arrays and plain values "
                            f"only, not {type(x).__name__}")
        i = len(arrays)
        arrays[f"leaf_{i}"] = x
        return ("__leaf__", i)

    meta = pickle.dumps(skeleton(tree))
    buf = _io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(meta, np.uint8), **arrays)
    return buf.getvalue()


def _decode_payload(payload: bytes) -> Tree:
    with np.load(_io.BytesIO(payload), allow_pickle=False) as z:
        meta = _PlainUnpickler(_io.BytesIO(z["__meta__"].tobytes())).load()

        def fill(x):
            if _leaf_mark(x):
                return z[f"leaf_{x[1]}"]
            if isinstance(x, dict):
                return {k: fill(v) for k, v in x.items()}
            if isinstance(x, list):
                return [fill(v) for v in x]
            if isinstance(x, tuple):
                return tuple(fill(v) for v in x)
            return x

        return fill(meta)


# --------------------------------------------------------------------- #
# hardened file container
# --------------------------------------------------------------------- #


def save_pytree(path: str, tree: Tree) -> int:
    """Write ``tree`` to ``path`` crash-consistently; returns bytes written.

    fsync(file) -> atomic rename -> fsync(directory): after this returns the
    checkpoint is durable, and a crash mid-write can never leave a torn
    file under ``path``.
    """
    payload = _encode_payload(tree)
    header = json.dumps({
        "format": FORMAT_VERSION,
        "payload_len": len(payload),
        "payload_sha256": hashlib.sha256(payload).hexdigest(),
    }, sort_keys=True).encode()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(MAGIC)
            f.write(_HDR.pack(FORMAT_VERSION, len(header)))
            f.write(header)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return len(MAGIC) + _HDR.size + len(header) + len(payload)


def load_pytree(path: str) -> Tree:
    """Read a checkpoint, verifying the header's payload sha256 first.

    Raises :class:`CheckpointError` on a missing, truncated, corrupt, or
    version-incompatible file.
    """
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CheckpointError(f"cannot read checkpoint {path!r}: {e}") from e
    if len(raw) < len(MAGIC) + _HDR.size or raw[: len(MAGIC)] != MAGIC:
        raise CheckpointError(
            f"{path!r} is not a checkpoint (bad magic / truncated header)")
    version, hdr_len = _HDR.unpack_from(raw, len(MAGIC))
    if version > FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint {path!r} has format v{version}; this build reads "
            f"<= v{FORMAT_VERSION}")
    body = len(MAGIC) + _HDR.size
    try:
        header = json.loads(raw[body: body + hdr_len])
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"checkpoint {path!r} has a corrupt header: {e}") from e
    payload = raw[body + hdr_len:]
    if len(payload) != header.get("payload_len", -1):
        raise CheckpointError(
            f"checkpoint {path!r} is truncated: payload {len(payload)} bytes,"
            f" header recorded {header.get('payload_len')}")
    digest = hashlib.sha256(payload).hexdigest()
    if digest != header.get("payload_sha256"):
        raise CheckpointError(
            f"checkpoint {path!r} failed its sha256 integrity check "
            f"(corrupt payload)")
    try:
        return _decode_payload(payload)
    except CheckpointError:
        raise
    except Exception as e:
        raise CheckpointError(f"checkpoint {path!r} payload does not decode "
                              f"despite a valid digest: {e}") from e


# --------------------------------------------------------------------- #
# directory management: numbered snapshots, keep-last-K, corrupt fallback
# --------------------------------------------------------------------- #


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")


def list_checkpoints(ckpt_dir: str) -> list[tuple[int, str]]:
    """``[(step, path)]`` ascending by step; empty for a missing directory."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(out)


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree,
                    keep_last: int = 3) -> tuple[str, int]:
    """Write snapshot ``step`` into ``ckpt_dir`` and prune to the newest
    ``keep_last`` snapshots; returns ``(path, bytes_written)``."""
    path = checkpoint_path(ckpt_dir, step)
    n_bytes = save_pytree(path, tree)
    if keep_last >= 1:
        for _, old in list_checkpoints(ckpt_dir)[:-keep_last]:
            try:
                os.unlink(old)
            except OSError:
                pass                        # pruning is best-effort
    return path, n_bytes


def load_latest(ckpt_dir: str) -> tuple[int, Tree]:
    """Load the newest *readable* snapshot in ``ckpt_dir``.

    A corrupt or truncated latest snapshot (e.g. injected via
    ``FaultSpec.corrupt_checkpoint_round``) falls back to the previous
    keep-last-K snapshot; raises :class:`CheckpointError` only when no
    snapshot in the directory is readable.
    """
    entries = list_checkpoints(ckpt_dir)
    if not entries:
        raise CheckpointError(f"no checkpoints found in {ckpt_dir!r}")
    errors = []
    for step, path in reversed(entries):
        try:
            return step, load_pytree(path)
        except CheckpointError as e:
            errors.append(str(e))
    raise CheckpointError(
        "every checkpoint in {!r} is unreadable:\n  {}".format(
            ckpt_dir, "\n  ".join(errors)))


# --------------------------------------------------------------------- #
# trainer state: parameters and optimizer state of tensors
# --------------------------------------------------------------------- #

_BF16_TAG = "bfloat16"


def _host_tree(x: Tree) -> Tree:
    """Tensors -> numpy arrays (bfloat16 as a tagged uint16 bit view);
    dicts, lists and plain values as they are."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return (_BF16_TAG, t.view(torch.int16).numpy().view(np.uint16).copy())
        return t.numpy().copy()
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host_tree(v) for v in x]
    return x


def _device_tree(x: Tree, device: torch.device) -> Tree:
    """The inverse of :func:`_host_tree`, tensors on ``device``."""
    if isinstance(x, tuple) and len(x) == 2 and x[0] == _BF16_TAG:
        return torch.from_numpy(x[1].view(np.int16).copy()).view(torch.bfloat16).to(device)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy()).to(device)
    if isinstance(x, dict):
        return {k: _device_tree(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_device_tree(v, device) for v in x]
    return x


def save_trainer_state(path: str, params: Tree, opt_state: Tree,
                       round_idx: int, extra: dict | None = None) -> None:
    """``{"params", "opt_state", "round_idx", "extra_json"}`` into one
    checkpoint file, as the reference writes it (tensors brought to the
    host first).  Expert tables placed over a mesh
    (``interop.place_expert_tables``), in the parameters and in the
    optimizer's moment trees alike, are written whole, in the reference's
    layout: unplaced under the ambient mesh
    (``models/moe_sharded.whole_expert_tables``; a ValueError without
    one).  A restore gives whole tables; the caller places them again."""
    params = whole_expert_tables(params, "save_trainer_state")
    opt_state = whole_expert_tables(opt_state, "save_trainer_state")
    save_pytree(path, {"params": _host_tree(params),
                       "opt_state": _host_tree(opt_state),
                       "round_idx": np.asarray(round_idx),
                       "extra_json": np.frombuffer(
                           json.dumps(extra or {}).encode(), np.uint8)})


def restore_trainer_state(path: str, device=None):
    """``(params, opt_state, round_idx, extra)`` from
    :func:`save_trainer_state`, every tensor on ``device`` (the card
    unless the caller names another); expert tables whole
    (``interop.place_expert_tables`` places them again)."""
    device = resolve_device(device)
    state = load_pytree(path)
    extra = json.loads(bytes(state["extra_json"]).decode())
    return (_device_tree(state["params"], device),
            _device_tree(state["opt_state"], device),
            int(state["round_idx"]), extra)
