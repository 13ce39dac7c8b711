"""Pluggable wire codecs: one seam for the paper's compression (Algs. 3-4).

* **Algorithm 3 (compress)** -- keep the top ``p_s`` fraction of each tensor
  by magnitude (``k = max(1, round(p_s * n))`` values), quantize the kept
  values to ``p_q`` bits (levels in ``[-L, L]``, ``L = 2**(p_q-1) - 1``,
  one f32 max-abs scale per tensor), and transmit ``(scale, values,
  indices)``.
* **Algorithm 4 (decompress)** -- dequantize ``level * scale / L`` and
  scatter the values back to their indices in a zero tensor.
* **Wire size** -- per tensor ``bits = k * (min(p_q, 32) + [k < n] *
  ceil(log2 n)) + 32``; a parameter dict travels as ONE bit-level
  concatenated stream of ``ceil(sum_bits / 8)`` bytes.

Codecs take and return parameter dicts (``dict[str, Tensor]``) and work on
the device the tensors lie on.  Stochastic rounding (``rng`` given) runs on
the host in numpy, in the JAX package's draw order, so that simulated
event timelines stay comparable between the two packages.  A deterministic
``packed`` encode (``rng is None``) goes through the fused kernel
(``repro_torch.kernels.ops.fused_wire_encode``): the CUDA kernel for CUDA
tensors, its plain version for CPU tensors.

Registered: :class:`IdentityCodec`, :class:`DenseRefCodec`,
:class:`ThresholdGraphCodec` (the cohort trainer's in-graph channel; on
the card kernel B's channel form) and :class:`PackedBitstreamCodec`.
"""
from __future__ import annotations

import abc
import dataclasses
import functools
from typing import Any, ClassVar, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core.compression import (FLOAT_BITS, compress_pytree,
                                          compress_tensor, decompress_pytree,
                                          decompress_tensor,
                                          expected_pytree_wire_bytes,
                                          expected_tensor_wire_bits,
                                          index_bits, pytree_dense_bytes,
                                          pytree_wire_bytes,
                                          sparsify_quantize_threshold,
                                          topk_count)
from repro_torch.kernels.bitpack import BitReader, pack_segments
from repro_torch.utils.tree import Params, leaves, paths, tree_map, unflatten


def _device_of(tree: Params) -> torch.device:
    return leaves(tree)[0].device


def _to_device(tree: Dict[str, np.ndarray], device) -> Params:
    return tree_map(lambda v: torch.from_numpy(
        np.ascontiguousarray(v)).to(device), tree)


@dataclasses.dataclass
class Wire:
    """One encoded transmission.

    ``payload`` is codec-specific (a parameter dict, a compressed-dict
    tree, or raw ``bytes`` for the packed codec); ``nbytes`` is the metered
    wire size.  ``meta`` carries receiver-known framing (leaf names,
    shapes, device) that is protocol-static and not billed to the channel.
    """
    codec: str
    payload: Any
    nbytes: int
    meta: Any = None


class Codec(abc.ABC):
    """encode/decode/price interface every wire implementation satisfies.
    ``p_s``/``p_q`` expose the operating point (1.0/32 = uncompressed)."""

    name: ClassVar[str] = ""
    p_s: float = 1.0
    p_q: int = FLOAT_BITS

    @abc.abstractmethod
    def encode(self, tree: Params, *,
               rng: Optional[np.random.RandomState] = None) -> Wire:
        """Compress ``tree`` for transmission.  ``rng`` enables stochastic
        (unbiased QSGD) rounding where the codec supports it."""

    @abc.abstractmethod
    def decode(self, wire: Wire) -> Params:
        """Reconstruct the (lossy) tree, on the encoded tree's device."""

    @abc.abstractmethod
    def wire_bytes(self, tree: Params) -> int:
        """Transmitted size for ``tree`` -- shape-only, so schedulers can
        price a transfer before training has produced the update."""

    def roundtrip(self, tree: Params, *,
                  rng: Optional[np.random.RandomState] = None
                  ) -> Tuple[Params, int]:
        """The lossy channel: encode -> wire bytes -> decode."""
        wire = self.encode(tree, rng=rng)
        return self.decode(wire), wire.nbytes


@dataclasses.dataclass(frozen=True)
class IdentityCodec(Codec):
    """No compression: dense f32 on the wire (TEA-Fed / FedAvg / FedAsync)."""

    name: ClassVar[str] = "identity"

    def encode(self, tree, *, rng=None) -> Wire:
        return Wire(self.name, tree, pytree_dense_bytes(tree))

    def decode(self, wire: Wire):
        return wire.payload

    def wire_bytes(self, tree) -> int:
        return pytree_dense_bytes(tree)


@dataclasses.dataclass(frozen=True)
class DenseRefCodec(Codec):
    """Reference Algs. 3-4 codec over ``compress_pytree`` /
    ``decompress_pytree`` (exact global Top-K, optional stochastic
    rounding, on the host); priced as the packed bitstream."""

    p_s: float = 1.0
    p_q: int = FLOAT_BITS

    name: ClassVar[str] = "dense"

    def encode(self, tree, *, rng=None) -> Wire:
        ctree = compress_pytree(tree, self.p_s, self.p_q, rng)
        return Wire(self.name, ctree, pytree_wire_bytes(ctree),
                    meta=_device_of(tree))

    def decode(self, wire: Wire):
        return _to_device(decompress_pytree(wire.payload), wire.meta)

    def wire_bytes(self, tree) -> int:
        return _packed_price(tree, self.p_s, self.p_q)


@dataclasses.dataclass(frozen=True)
class ThresholdGraphCodec(Codec):
    """The in-graph channel: bisection-threshold sparsification +
    deterministic quantization (``sparsify_quantize_threshold``), the
    operator the cohort trainer applies down and up.  ``apply_tree`` and
    ``encode`` run it through ``kernels.ops.threshold_channel_leaves``:
    kernel B's channel form on the card, its plain version on the CPU.
    ``encode`` ignores ``rng`` (the rounding is deterministic)."""

    p_s: float = 1.0
    p_q: int = FLOAT_BITS
    iters: int = 12               # threshold bisection steps

    name: ClassVar[str] = "threshold"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """The lossy operator on one tensor (shape-preserving)."""
        return sparsify_quantize_threshold(x, self.p_s, self.p_q, self.iters)

    def apply_tree(self, tree: Params) -> Params:
        """The operator on every leaf of a dict, each leaf one row."""
        from repro_torch.kernels.ops import threshold_channel_leaves
        names = paths(tree)
        xs = leaves(tree)
        out = threshold_channel_leaves([x.reshape(1, -1) for x in xs],
                                       self.p_s, self.p_q, self.iters)
        return unflatten(names, [o.view(x.shape) for o, x in zip(out, xs)])

    def encode(self, tree, *, rng=None) -> Wire:
        return Wire(self.name, self.apply_tree(tree), self.wire_bytes(tree))

    def decode(self, wire: Wire):
        return wire.payload

    def wire_bytes(self, tree) -> int:
        return expected_pytree_wire_bytes(tree, self.p_s, self.p_q)


def _packed_price(tree: Any, p_s: float, p_q: int) -> int:
    """Shape-only price of the packed stream WITHOUT the dense fast path of
    ``expected_pytree_wire_bytes``: the stream always carries the
    per-tensor f32 scale."""
    return (sum(expected_tensor_wire_bits(x.numel(), p_s, p_q)
                for x in leaves(tree)) + 7) // 8


@dataclasses.dataclass(frozen=True)
class PackedBitstreamCodec(Codec):
    """The real bit-packed wire format (Alg. 3 serialization).

    Per tensor, in stream order: ``[scale: 32b f32] [k values at
    min(p_q, 32) bits] [k delta-coded sorted indices at ceil(log2 n) bits,
    omitted when k == n]``.  Levels travel offset-binary (``level + L``);
    uncompressed values as raw f32 patterns.  Tensors are concatenated
    bit-level and the trailing partial byte is zero-filled, so
    ``len(encode(tree).payload) == expected_pytree_wire_bytes(tree)``.

    With ``fused=True`` (the default) a deterministic encode (``rng is
    None``) is kernel A, one launch for the whole dict on the card.  A
    stochastic encode always takes the host ``compress_tensor`` pipeline,
    in the shared draw order; ``fused=False`` keeps the host pipeline for
    deterministic encodes too, as the parity oracle."""

    p_s: float = 1.0
    p_q: int = FLOAT_BITS
    fused: bool = True

    name: ClassVar[str] = "packed"

    def __post_init__(self):
        if not 2 <= self.p_q:
            raise ValueError(f"p_q must be >= 2, got {self.p_q}")

    # -- encode -----------------------------------------------------------
    def encode(self, tree, *, rng=None) -> Wire:
        names = paths(tree)
        xs = leaves(tree)
        meta = (names, [tuple(x.shape) for x in xs], xs[0].device)
        if self.fused and rng is None:
            from repro_torch.kernels.ops import fused_wire_encode
            payload = fused_wire_encode(xs, self.p_s, self.p_q)
        else:
            segments: List[Tuple[np.ndarray, int]] = []
            for x in xs:
                c = compress_tensor(x, self.p_s, self.p_q, rng)
                segments.extend(self._tensor_segments(c))
            payload = pack_segments(segments)
        return Wire(self.name, payload, len(payload), meta=meta)

    @staticmethod
    def _tensor_segments(c: Dict[str, Any]) -> List[Tuple[np.ndarray, int]]:
        n, p_q = c["n"], c["p_q"]
        values, indices = c["values"], c["indices"]
        k = len(values)
        vbits = min(p_q, FLOAT_BITS)
        scale = np.asarray(c["scale"], np.float32).reshape(1).view(np.uint32)
        # sort by index for delta coding; the scatter in Alg. 4 is
        # order-invariant, so reordering values alongside is lossless
        order = np.argsort(indices, kind="stable")
        idx_s = np.asarray(indices)[order]
        vals_s = np.asarray(values)[order]
        if p_q < FLOAT_BITS:
            L = 2 ** (p_q - 1) - 1
            u_vals = (vals_s.astype(np.int64) + L).astype(np.uint32)
        else:
            u_vals = vals_s.astype(np.float32).view(np.uint32)
        segs = [(scale, FLOAT_BITS), (u_vals, vbits)]
        if k < n:
            deltas = np.empty(k, np.uint32)
            deltas[0] = idx_s[0]
            deltas[1:] = np.diff(idx_s)
            segs.append((deltas, index_bits(n)))
        return segs

    # -- decode -----------------------------------------------------------
    def decode(self, wire: Wire):
        names, shapes, device = wire.meta
        reader = BitReader(wire.payload)
        arrays = [self._read_tensor(reader, shape) for shape in shapes]
        return _to_device(unflatten(names, arrays), device)

    def _read_tensor(self, reader: BitReader, shape) -> np.ndarray:
        n = int(np.prod(shape)) if shape else 1
        k = topk_count(n, self.p_s)
        vbits = min(self.p_q, FLOAT_BITS)
        scale = float(reader.read(1, FLOAT_BITS).view(np.float32)[0])
        u_vals = reader.read(k, vbits)
        if self.p_q < FLOAT_BITS:
            L = 2 ** (self.p_q - 1) - 1
            values = (u_vals.astype(np.int64) - L).astype(np.int32)
        else:
            values = u_vals.view(np.float32)
        if k < n:
            indices = np.cumsum(reader.read(k, index_bits(n)).astype(np.int64))
        else:
            indices = np.arange(n, dtype=np.int64)
        return decompress_tensor({"values": values, "indices": indices,
                                  "scale": scale, "shape": tuple(shape),
                                  "p_q": self.p_q, "n": n})

    def wire_bytes(self, tree) -> int:
        return _packed_price(tree, self.p_s, self.p_q)


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
CODECS: Dict[str, Type[Codec]] = {
    cls.name: cls for cls in (IdentityCodec, DenseRefCodec,
                              ThresholdGraphCodec, PackedBitstreamCodec)
}


@functools.lru_cache(maxsize=256)
def _make_codec(name: str, p_s: float, p_q: int, iters: int) -> Codec:
    if name == "threshold":
        return ThresholdGraphCodec(p_s, p_q, iters)
    return CODECS[name](p_s, p_q) if name != "identity" else IdentityCodec()


def resolve_codec(name: str, p_s: float = 1.0, p_q: int = FLOAT_BITS,
                  iters: int = 12) -> Codec:
    """Bind a codec family name to an ``(p_s, p_q)`` operating point.

    The uncompressed point short-circuits to :class:`IdentityCodec` for
    every family (the simulators' dense fast path).  Instances are cached:
    codecs are frozen and stateless.  ``iters`` is the threshold codec's
    bisection steps.
    """
    if name not in CODECS:
        raise ValueError(
            f"unknown codec {name!r}; expected one of {sorted(CODECS)}")
    if p_s >= 1.0 and p_q >= FLOAT_BITS:
        return _make_codec("identity", 1.0, FLOAT_BITS, iters)
    return _make_codec(name, float(p_s), int(p_q), int(iters))
