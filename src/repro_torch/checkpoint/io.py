"""Checkpoint files: parameter trees and simulator state blobs, in msgpack.

The JAX package's ``checkpoint/io.py`` in PyTorch, file for file: a file
written by either package reads in the other.  Both formats are one
msgpack object:

* a parameter tree (:func:`save_pytree`): ``{"treedef": str, "leaves":
  [ndarray, ...]}``, the leaves in pytree order (sorted dict keys) and the
  structure as the string ``str(jax treedef)`` renders, e.g.
  ``PyTreeDef({'b1': *, 'conv1': *})``;
* a state blob (:func:`save_blob`): the plain nested dicts, lists, scalars,
  strings and numpy arrays of ``FLEngine.state_dict()`` or
  ``MultiTaskEngine.state_dict()``.

An ndarray travels as the map ``{b"__nd__": True, b"dtype": dtype.str,
b"shape": [...], b"data": raw bytes}`` (bytes keys pack as bin).  The
encoder below writes the bytes ``msgpack.packb(obj, default=...,
use_bin_type=True)`` writes (the smallest encoding of every integer,
Python floats as float64, tuples as arrays), and the decoder reads them as
``msgpack.unpackb`` does with ``raw=False`` (blobs) or ``raw=True`` (trees).
The port carries its own codec for that subset rather than depend on the
``msgpack`` package.

Tensors come back on the device the caller names: the card unless another
is named (``utils.tree.resolve_device``).
"""
from __future__ import annotations

import os
import struct
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import resolve_device

__all__ = ["packb", "unpackb", "save_pytree", "load_pytree", "save_blob",
           "load_blob", "load_sim_params"]


# ----------------------------------------------------------------------
# msgpack: the subset the checkpoints use
# ----------------------------------------------------------------------
def _encode(obj: Any) -> Any:
    """The ndarray hook (the JAX package's ``_encode``)."""
    if isinstance(obj, np.ndarray):
        return {b"__nd__": True, b"dtype": obj.dtype.str,
                b"shape": list(obj.shape), b"data": obj.tobytes()}
    return obj


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict) and obj.get(b"__nd__"):
        dtype = obj[b"dtype"]
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        return np.frombuffer(obj[b"data"], dtype=np.dtype(dtype)
                             ).reshape(obj[b"shape"]).copy()
    return obj


def _pack_int(n: int, out: List[bytes]) -> None:
    if n < -(1 << 5):
        if n < -(1 << 15):
            if n < -(1 << 31):
                if n < -(1 << 63):
                    raise OverflowError(f"{n} does not fit msgpack's int64")
                out.append(b"\xd3" + struct.pack(">q", n))
            else:
                out.append(b"\xd2" + struct.pack(">i", n))
        elif n < -(1 << 7):
            out.append(b"\xd1" + struct.pack(">h", n))
        else:
            out.append(b"\xd0" + struct.pack(">b", n))
    elif n < (1 << 7):
        out.append(struct.pack(">B", n & 0xFF))   # positive/negative fixint
    elif n < (1 << 16):
        if n < (1 << 8):
            out.append(b"\xcc" + struct.pack(">B", n))
        else:
            out.append(b"\xcd" + struct.pack(">H", n))
    elif n < (1 << 32):
        out.append(b"\xce" + struct.pack(">I", n))
    elif n < (1 << 64):
        out.append(b"\xcf" + struct.pack(">Q", n))
    else:
        raise OverflowError(f"{n} does not fit msgpack's uint64")


def _pack_len(n: int, fix: Optional[int], fix_max: int,
              codes: Tuple[Optional[int], int, int], out: List[bytes]
              ) -> None:
    """A length header: the fix form below ``fix_max``, then 8-, 16- and
    32-bit lengths (``codes``; None where the family has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack(">B", fix | n))
    elif codes[0] is not None and n < (1 << 8):
        out.append(struct.pack(">BB", codes[0], n))
    elif n < (1 << 16):
        out.append(struct.pack(">BH", codes[1], n))
    elif n < (1 << 32):
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack object of length {n} is too large")


def _pack(obj: Any, default: Optional[Callable], out: List[bytes]) -> None:
    used_default = False
    while True:
        if obj is None:
            out.append(b"\xc0")
        elif obj is True:
            out.append(b"\xc3")
        elif obj is False:
            out.append(b"\xc2")
        elif isinstance(obj, int):
            _pack_int(int(obj), out)
        elif isinstance(obj, float):
            out.append(b"\xcb" + struct.pack(">d", obj))
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            data = bytes(obj)
            _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
            out.append(data)
        elif isinstance(obj, str):
            data = obj.encode("utf-8")
            _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
            out.append(data)
        elif isinstance(obj, dict):
            _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
            for k, v in obj.items():
                _pack(k, default, out)
                _pack(v, default, out)
        elif isinstance(obj, (list, tuple)):
            _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
            for v in obj:
                _pack(v, default, out)
        elif default is not None and not used_default:
            obj = default(obj)
            used_default = True
            continue
        else:
            raise TypeError(f"can not serialize {type(obj).__name__!r} "
                            "object")
        return


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, default=_encode, use_bin_type=True)``."""
    out: List[bytes] = []
    _pack(obj, _encode, out)
    return b"".join(out)


# type byte -> value, number format, or length format (bin 0xc4-c6, str
# 0xd9-db, array 0xdc-dd, map 0xde-df)
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
            0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    """msgpack decoding over one buffer (``use_list=True``): maps become
    dicts passed through ``hook``; strings are ``str`` or, with ``raw``,
    ``bytes``; bin is ``bytes``."""

    def __init__(self, data: bytes, hook: Callable, raw: bool):
        self.data, self.pos, self.hook, self.raw = data, 0, hook, raw

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int) -> Any:
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> Any:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return self.hook(out)

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _LENGTHS:
            n = self.unpack(_LENGTHS[b])
            if b <= 0xC6:
                return self.take(n)
            if b <= 0xDB:
                return self.string(n)
            return self.array(n) if b <= 0xDD else self.map(n)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


def unpackb(data: bytes, raw: bool = False) -> Any:
    """``msgpack.unpackb(data, object_hook=_decode, raw=raw,
    strict_map_key=False)``."""
    r = _Reader(data, _decode, raw)
    out = r.read()
    if r.pos != len(data):
        raise ValueError("extra data after the msgpack object")
    return out


# ----------------------------------------------------------------------
# Parameter trees
# ----------------------------------------------------------------------
def _flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves in pytree order, the JAX treedef's string) of a tree of
    dicts (sorted keys), lists and tuples; None is an empty node."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            keys = sorted(node)
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in keys) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(v) for v in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in pytree order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


_TORCH_TO_NUMPY = {torch.float32: np.float32, torch.float64: np.float64,
                   torch.float16: np.float16, torch.int8: np.int8,
                   torch.int16: np.int16, torch.int32: np.int32,
                   torch.int64: np.int64, torch.uint8: np.uint8,
                   torch.bool: np.bool_}


def _dtype_shape(leaf: Any) -> Tuple[np.dtype, Tuple[int, ...]]:
    if isinstance(leaf, torch.Tensor):
        return np.dtype(_TORCH_TO_NUMPY[leaf.dtype]), tuple(leaf.shape)
    arr = np.asarray(leaf)
    return arr.dtype, arr.shape


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _restore(path: str, stored: List[Any], like: Any, device,
             what: str) -> Any:
    """``stored`` (numpy leaves) checked leaf by leaf against ``like`` and
    rebuilt in its structure as tensors on ``device``."""
    flat, _ = _flatten(like)
    if len(flat) != len(stored):
        raise ValueError(f"checkpoint at {path!r} holds {len(stored)} "
                         f"{what}, `like` has {len(flat)}")
    dev = resolve_device(device)
    out = []
    for i, (l, f) in enumerate(zip(stored, flat)):
        l = np.asarray(l)
        dtype, shape = _dtype_shape(f)
        name = "checkpoint leaf" if what == "leaves" else "weight leaf"
        if l.dtype != dtype:
            raise ValueError(f"{name} {i} dtype mismatch at {path!r}: "
                             f"stored {l.dtype}, expected {dtype}")
        if l.shape != shape:
            raise ValueError(f"{name} {i} shape mismatch at {path!r}: "
                             f"stored {l.shape}, expected {shape}")
        out.append(torch.from_numpy(np.array(l)).to(dev))
    return _unflatten(like, out)


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def save_pytree(path: str, tree: Any) -> None:
    """Write a tree of tensors or arrays: its treedef string and its leaves
    as host arrays, in pytree order."""
    flat, treedef = _flatten(tree)
    _write(path, packb({"treedef": treedef,
                        "leaves": [_encode(_host(l)) for l in flat]}))


def load_pytree(path: str, like: Any, device=None) -> Any:
    """Restore into the structure of ``like``, validating the stored
    treedef, per-leaf dtypes and shapes against it: a checkpoint written
    from another model structure fails loudly.  Leaves come back as
    tensors on ``device`` (the card unless another is named)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read(), raw=True)
    leaves = [_decode(l) for l in payload[b"leaves"]]
    _, treedef = _flatten(like)
    stored_treedef = payload[b"treedef"].decode()
    if stored_treedef != treedef:
        raise ValueError(
            f"checkpoint treedef mismatch at {path!r}:\n"
            f"  stored:   {stored_treedef}\n  expected: {treedef}")
    return _restore(path, leaves, like, device, "leaves")


# ----------------------------------------------------------------------
# Simulator state blobs
# ----------------------------------------------------------------------
def save_blob(path: str, obj: Any) -> None:
    """Write a ``state_dict()`` (plain dicts, lists, scalars, strings and
    numpy arrays) as one msgpack object."""
    _write(path, packb(obj))


def load_blob(path: str) -> Any:
    with open(path, "rb") as f:
        return unpackb(f.read(), raw=False)


def load_sim_params(path: str, like: Any, task: int = 0,
                    device=None) -> Any:
    """Global model weights out of a simulator checkpoint blob: an
    ``FLEngine.state_dict()`` blob (``core.server.w``) or a
    ``MultiTaskEngine.state_dict()`` blob (job ``task``'s
    ``tasks[task].server.w``).  The blob stores the weights as a flat leaf
    list in pytree order, so ``like`` (a tree with the training-time
    structure) supplies the structure; dtypes and shapes are validated
    against it as in :func:`load_pytree`.  Tensors on ``device`` (the card
    unless another is named)."""
    blob = load_blob(path)
    if "core" in blob:                      # FLEngine.state_dict
        leaves = blob["core"]["server"]["w"]
    elif "tasks" in blob:                   # MultiTaskEngine.state_dict
        jobs = blob["tasks"]
        if not 0 <= task < len(jobs):
            raise ValueError(f"fleet checkpoint at {path!r} holds "
                             f"{len(jobs)} tasks; task index {task} is out "
                             "of range")
        leaves = jobs[task]["server"]["w"]
    else:
        raise ValueError(f"{path!r} is not an engine or fleet checkpoint "
                         "blob (no 'core' or 'tasks' key)")
    return _restore(path, leaves, like, device, "weight leaves")
