"""In-circuit SHA256 (reference: waffle/stdlib/crypto/hash/sha256.tcc).

Standard FIPS-180 message schedule + compression over Uint32 gadgets,
including the reference's cheap tricks: ch = (e&f) + (~e&g) and
maj = (a & (b + c - 2*(b&c))) + (b&c), both valid because the mixed terms
cannot carry (sha256.tcc:87-93)."""

from __future__ import annotations

from .bitarray import BitArray
from .uint32 import Uint32

_INIT = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)


def sha256_block(h_init: list[Uint32], inp: list[Uint32]) -> list[Uint32]:
    """One compression round (sha256.tcc:47-119)."""
    w = list(inp)
    for i in range(16, 64):
        s0 = w[i - 15].ror(7) ^ w[i - 15].ror(18) ^ (w[i - 15] >> 3)
        s1 = w[i - 2].ror(17) ^ w[i - 2].ror(19) ^ (w[i - 2] >> 10)
        w.append(w[i - 16] + w[i - 7] + s0 + s1)

    a, b, c, d, e, f, g, h = h_init
    for i in range(64):
        s1 = e.ror(6) ^ e.ror(11) ^ e.ror(25)
        ch = (e & f) + (~e & g)
        temp1 = h + s1 + ch + _K[i] + w[i]
        s0 = a.ror(2) ^ a.ror(13) ^ a.ror(22)
        t0 = b & c
        maj = (a & (b + c - (t0 * 2))) + t0
        temp2 = s0 + maj
        h, g, f = g, f, e
        e = d + temp1
        d, c, b = c, b, a
        a = temp1 + temp2

    prev = h_init
    out = [x + y for x, y in zip((a, b, c, d, e, f, g, h), prev)]
    return [u.normalize() for u in out]


def sha256(inp: BitArray) -> BitArray:
    """Padding + block chaining (sha256.tcc:121-151)."""
    num_bits = inp.length
    num_blocks = (num_bits + 65) // 512 + (1 if (num_bits + 65) % 512 else 0)

    schedule = BitArray(inp.context, num_blocks * 512)
    offset = schedule.length - num_bits
    for i in range(num_bits):
        schedule[offset + i] = inp[i]
    schedule[offset - 1] = True
    for i in range(32):
        schedule[i] = bool((num_bits >> i) & 1)

    rolling = [Uint32(inp.context, value=v) for v in _INIT]
    for i in range(num_blocks):
        block = schedule.to_uint32s(i * 512, 16)
        rolling = sha256_block(rolling, block)
    return BitArray.from_uint32s(rolling)
