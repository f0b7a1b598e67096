"""Keccak-256 (original pad-0x01 variant, as used by Ethereum) on host.

The reference vendors a C Keccak-f[1600] (reference: keccak/keccakf1600.c,
keccak.c) and uses it for Fiat-Shamir challenges via `hash_field_elements`
(keccak.c:112-135). Transcript hashing is a handful of 32-byte-granule hashes
per proof, so it lives on host; a native C implementation with a ctypes
binding is provided in native/ (loaded lazily by transcript.challenges), with
this pure-Python version as the portable fallback and test oracle.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

# Round constants for Keccak-f[1600] (public specification values).
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets, indexed [x][y].
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rol(v: int, r: int) -> int:
    r %= 64
    return ((v << r) | (v >> (64 - r))) & _MASK


def keccak_f1600(state: list[int]) -> list[int]:
    """One permutation of 25 64-bit lanes, index a[x + 5y]."""
    a = state
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        a = [(a[i] ^ d[i % 5]) for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROT[x][y])
        # chi
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)] & _MASK)
            for i in range(25)
        ]
        # iota
        a[0] ^= rc
    return a


_native_keccak = None
_native_checked = False


def keccak256(data: bytes) -> bytes:
    """Keccak-256 with the original 0x01 padding (NOT sha3-256's 0x06).
    Dispatches to the native C sponge (the native sub-package) when it
    builds; this Python path is the fallback and oracle."""
    global _native_keccak, _native_checked
    if not _native_checked:
        from ..native import get_keccak

        _native_keccak = get_keccak()
        _native_checked = True
    if _native_keccak is not None:
        return _native_keccak(data)
    return _keccak256_py(data)


def _keccak256_py(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate
    state = [0] * 25
    # absorb full blocks
    offset = 0
    while len(data) - offset >= rate:
        block = data[offset : offset + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)
        offset += rate
    # final partial block with pad
    block = bytearray(data[offset:])
    block.append(0x01)
    block.extend(b"\x00" * (rate - len(block)))
    block[-1] |= 0x80
    for i in range(rate // 8):
        state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
    state = keccak_f1600(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


def hash_field_elements(values_256bit: list[int]) -> int:
    """The reference's transcript hash (keccak.c:112-135): each element is
    serialized as 4 x u64 limbs, least-significant limb first, each limb
    big-endian; the digest is read back as 4 little-endian u64s (= one
    little-endian 256-bit integer, keccak.c:101-102 / challenge.hpp usage).

    Inputs here are the raw 256-bit integers (Montgomery-form words in the
    PLONK transcript); output is the raw 256-bit digest integer.
    """
    buf = bytearray()
    for v in values_256bit:
        v = int(v)
        for j in range(4):
            limb = (v >> (64 * j)) & _MASK
            buf += limb.to_bytes(8, "big")
    return int.from_bytes(keccak256(bytes(buf)), "little")
