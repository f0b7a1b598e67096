"""Bit-vector gadget across uint32 words (reference:
waffle/stdlib/bitarray/bitarray.tcc).

Index convention matches the reference: bit 0 is the LSB of the LAST word;
the first character/word of the input is the most significant. This is the
layout SHA256's padding logic expects (sha256.tcc:121-151).
"""

from __future__ import annotations

from .types import bool_t, witness_t
from .uint32 import Uint32


class BitArray:
    def __init__(self, context, n: int = 0):
        self.context = context
        self.values: list[bool_t] = [bool_t(context, False) for _ in range(n)]

    @property
    def length(self) -> int:
        return len(self.values)

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, idx: int) -> bool_t:
        return self.values[idx]

    def __setitem__(self, idx: int, value) -> None:
        if isinstance(value, bool_t):
            self.values[idx] = value
        else:
            self.values[idx] = bool_t(self.context, bool(value))

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_string(context, s: str | bytes) -> "BitArray":
        """Each input byte becomes 8 witness bits; first byte = most
        significant (bitarray.tcc:19-37)."""
        data = s.encode() if isinstance(s, str) else s
        out = BitArray(context, len(data) * 8)
        n = out.length
        for i, ch in enumerate(data):
            position = n - 8 * (i + 1)
            for j in range(8):
                out.values[position + j] = bool_t.from_witness(
                    witness_t(context, (ch >> j) & 1)
                )
        return out

    @staticmethod
    def from_uint32s(words: list[Uint32]) -> "BitArray":
        """word 0 = most significant (bitarray.tcc:39-66)."""
        context = next(
            (w.context for w in words if w.context is not None), None
        )
        out = BitArray(context, 0)
        num = len(words)
        out.values = [None] * (num * 32)
        for i in range(num):
            bits = words[num - 1 - i].get_bits()
            for j in range(32):
                out.values[i * 32 + j] = bits[j]
        return out

    # -- views ----------------------------------------------------------------
    def to_uint32s(self, starting_index: int = 0, count: int | None = None):
        """Extract `count` words ending at the array top
        (bitarray.tcc populate_uint32_array)."""
        if count is None:
            count = (self.length - starting_index) // 32
        num_words = self.length // 32
        out = []
        for i in range(count):
            start = (num_words - i) * 32 - 32
            bits = [self.values[j - starting_index] for j in range(start, start + 32)]
            out.append(Uint32.from_bits(self.context, bits))
        return out

    def get_value(self) -> int:
        v = 0
        for i, b in enumerate(self.values):
            v |= int(b.get_value()) << i
        return v

    def to_bytes(self) -> bytes:
        """Big-endian byte view (first byte = most significant bits)."""
        n = self.length
        assert n % 8 == 0
        out = bytearray()
        for i in range(n // 8):
            byte = 0
            position = n - 8 * (i + 1)
            for j in range(8):
                byte |= int(self.values[position + j].get_value()) << j
            out.append(byte)
        return bytes(out)
