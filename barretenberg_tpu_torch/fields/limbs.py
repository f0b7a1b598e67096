"""Limb-vector <-> integer conversions for the planar field representation.

A field-element *vector* is a ``uint32`` array of shape ``(NUM_LIMBS, *batch)``
holding base-2^15 limbs, least-significant limb first ("planar" layout: the
limb axis leads so neighbouring threads read neighbouring lanes).

The reference stores elements as 4x64-bit little-endian limb structs
(reference: fields/field.hpp:19-22); helpers here convert both ways so the
reference test vectors can be used verbatim.
"""

from __future__ import annotations

import functools
from typing import Iterable, Sequence

import numpy as np

from .params import LIMB_BITS, LIMB_MASK, NUM_LIMBS

__all__ = [
    "int_to_limbs",
    "limbs_to_int",
    "ints_to_limbs",
    "limbs_to_ints",
    "u64x4_to_int",
    "int_to_u64x4",
]


def int_to_limbs(value: int) -> np.ndarray:
    """One integer -> (NUM_LIMBS,) uint32 base-2^15 limbs."""
    return ints_to_limbs([value])[:, 0]


def limbs_to_int(limbs) -> int:
    """(NUM_LIMBS,) limb array (possibly relaxed/overflowed) -> integer."""
    arr = np.asarray(limbs, dtype=np.uint64)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr))


_WORDS = 5  # 64-bit words per value in ints_to_limbs: 320 bits >= 270
_TO_BYTES = functools.partial(int.to_bytes, length=8 * _WORDS, byteorder="little")


def ints_to_limbs(values: Sequence[int]) -> np.ndarray:
    """Batch of integers 0 <= v < 2^270 -> (NUM_LIMBS, N) uint32 limbs. One
    ``to_bytes`` per value; the limbs are cut out of the values' 64-bit
    words with numpy shifts (a per-element Python limb loop cost minutes at
    SRS / prover scale)."""
    n = len(values)
    if n == 0:
        return np.empty((NUM_LIMBS, 0), dtype=np.uint32)
    try:
        buf = b"".join(map(_TO_BYTES, map(int, values)))
    except OverflowError as e:
        raise ValueError("value does not fit in 270 bits") from e
    words = np.frombuffer(buf, dtype="<u8").reshape(n, _WORDS).T
    top = NUM_LIMBS * LIMB_BITS - 64 * (_WORDS - 1)  # bits of the last word a limb may use
    if (words[_WORDS - 1] >> np.uint64(top)).any():
        raise ValueError("value does not fit in 270 bits")
    limbs = np.empty((NUM_LIMBS, n), dtype=np.uint32)
    for i in range(NUM_LIMBS):
        w, s = divmod(LIMB_BITS * i, 64)
        v = words[w] >> np.uint64(s)
        if s + LIMB_BITS > 64:
            v = v | (words[w + 1] << np.uint64(64 - s))
        limbs[i] = v & np.uint64(LIMB_MASK)
    return limbs


def limbs_to_ints(limbs) -> list[int]:
    """(NUM_LIMBS, N) limb array -> list of N integers. Canonical 15-bit
    limbs take a vectorized bit-pack path; relaxed/overflowed limbs fall
    back to the exact per-element sum."""
    arr = np.asarray(limbs)
    arr2 = arr.reshape(NUM_LIMBS, -1)
    n = arr2.shape[1]
    if arr2.size and (arr2 < (1 << LIMB_BITS)).all():
        cols = arr2.T.astype(np.uint32)  # (n, NUM_LIMBS)
        bits = ((cols[:, :, None] >> np.arange(LIMB_BITS)) & 1).astype(np.uint8)
        flat = bits.reshape(n, NUM_LIMBS * LIMB_BITS)
        flat = np.concatenate(
            [flat, np.zeros((n, 2), dtype=np.uint8)], axis=1
        )  # pad 270 -> 272 bits
        packed = np.packbits(flat, axis=1, bitorder="little")  # (n, 34)
        raw = packed.tobytes()
        return [
            int.from_bytes(raw[j * 34 : (j + 1) * 34], "little") for j in range(n)
        ]
    arr64 = arr2.astype(np.uint64)
    return [
        sum(int(arr64[i, j]) << (LIMB_BITS * i) for i in range(NUM_LIMBS))
        for j in range(n)
    ]


def u64x4_to_int(limbs64: Iterable[int]) -> int:
    """Reference-style {d0,d1,d2,d3} little-endian u64 limbs -> integer."""
    limbs64 = list(limbs64)
    assert len(limbs64) == 4
    return sum(int(v) << (64 * i) for i, v in enumerate(limbs64))


def int_to_u64x4(value: int) -> tuple[int, int, int, int]:
    m = (1 << 64) - 1
    return (value & m, (value >> 64) & m, (value >> 128) & m, (value >> 192) & m)
