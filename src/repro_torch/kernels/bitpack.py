"""Host half of the packed wire format's bit-packing (Alg. 3).

``pack_segments`` concatenates fixed-width unsigned fields into one
bit-level stream of big-endian uint32 words, and ``BitReader`` reads them
back; the stream layout is the JAX package's ``docs/WIRE_FORMAT.md``, byte
for byte.  Both work at word level: each ``width``-bit field spans at most
two stream words, so packing is one shift/OR scatter per segment (through
``np.add.at``: contributions to one word never overlap in bits, so the
integer sum is the bitwise OR) and reading is one 64-bit gather, shift and
mask per field.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

WORD = 32                     # stream word size in bits (big-endian uint32)

Segment = Tuple[np.ndarray, int]          # (uint32 values, bit width)


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Serialize big-endian uint32 stream words -> ``ceil(total_bits/8)``
    bytes.  Bits past ``total_bits`` must already be zero (they become the
    stream's zero-filled trailing partial byte)."""
    return np.ascontiguousarray(words, np.uint32).astype(">u4").tobytes()[
        :(total_bits + 7) // 8]


def _scatter_segment(acc: np.ndarray, v: np.ndarray, width: int,
                     pos: int) -> None:
    """Accumulate one fixed-width segment into a uint64 window accumulator:
    field ``i`` starts at stream bit ``off = pos + i * width`` and is ONE
    uint64 contribution ``v << (64 - off%32 - width)`` to ``acc[off >> 5]``
    (``width <= 32``, so it ends inside the window of that word and the
    next)."""
    off = pos + np.arange(v.size, dtype=np.int64) * width
    sh = (np.int64(2 * WORD - width) - (off & 31)).astype(np.uint64)
    np.add.at(acc, off >> 5, v.astype(np.uint64) << sh)


def _fold_windows(acc: np.ndarray, total_bits: int) -> np.ndarray:
    """Collapse the uint64 window accumulator to big-endian uint32 words:
    stream word ``j`` = high half of window ``j`` OR low half of window
    ``j - 1`` (bit-disjoint, so ``+`` is OR)."""
    nw = (total_bits + WORD - 1) // WORD
    words = (acc >> np.uint64(WORD)).astype(np.uint32)[:nw]
    words[1:] += acc.astype(np.uint32)[:nw - 1]
    return words


def pack_segments(segments: Sequence[Segment]) -> bytes:
    """Concatenate fixed-width fields into one bit-level stream.

    The final partial byte (if any) is zero-padded on the right, giving
    ``ceil(total_bits / 8)`` bytes.
    """
    parts: List[Tuple[np.ndarray, int, int]] = []
    pos = 0
    for v, width in segments:
        v = np.ascontiguousarray(v, dtype=np.uint32).reshape(-1)
        if v.size == 0:
            continue
        if not 1 <= width <= 32:
            raise ValueError(f"field width must be in [1, 32], got {width}")
        parts.append((v, width, pos))
        pos += v.size * width
    if not parts:
        return b""
    nw = (pos + WORD - 1) // WORD
    acc = np.zeros(nw, np.uint64)       # one 64-bit window per stream word
    for v, width, start in parts:
        _scatter_segment(acc, v, width, start)
    return words_to_bytes(_fold_windows(acc, pos), pos)


class BitReader:
    """Sequential fixed-width field reader over a packed byte stream.

    The payload is viewed as big-endian uint32 words; each field comes out
    of the (at most two) words it spans with one 64-bit shift --
    ``(w[i] << 32 | w[i+1]) >> (64 - offset%32 - width)``.  All arithmetic
    stays in uint64 (mixing uint64 with signed ints would promote to
    float64 in numpy).
    """

    def __init__(self, payload: bytes):
        pad = (-len(payload)) % 4 + 4     # +1 word so words[i+1] always exists
        self._words = np.frombuffer(payload + b"\x00" * pad,
                                    dtype=">u4").astype(np.uint64)
        self._nbits = len(payload) * 8
        self._pos = 0

    def read(self, count: int, width: int) -> np.ndarray:
        """Read ``count`` values of ``width`` bits each -> uint32 (count,)."""
        if count == 0:
            return np.zeros(0, np.uint32)
        nbits = count * width
        if self._pos + nbits > self._nbits:
            raise ValueError(
                f"bitstream underrun: wanted {nbits} bits at {self._pos}, "
                f"have {self._nbits - self._pos}")
        off = np.uint64(self._pos) \
            + np.arange(count, dtype=np.uint64) * np.uint64(width)
        wi = (off >> np.uint64(5)).astype(np.int64)
        comb = (self._words[wi] << np.uint64(32)) | self._words[wi + 1]
        shift = np.uint64(64) - (off & np.uint64(31)) - np.uint64(width)
        mask = np.uint64((1 << width) - 1)
        self._pos += nbits
        return ((comb >> shift) & mask).astype(np.uint32)

    @property
    def bits_read(self) -> int:
        return self._pos
