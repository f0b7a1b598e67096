"""GLV scalar splitting + signed fixed-window digits, on the device.

Replaces the reference's per-scalar integer bit-twiddling
(split_into_endomorphism_scalars, fixed_wnaf) with vectorized limb
arithmetic over the whole scalar array.

split_scalars: k -> (k1, k2) with k = k1 - k2*lambda (mod r), k1,k2 < 2^128.
The Babai-rounding mulhi uses the 2^270-aligned trick:
floor(g * k / 2^256) == floor((g << 14) * k / 2^270), and 270 = 18 limbs
exactly, so the high half of the 36-limb product IS the quotient. The exact
integer products run as plain int64 tensor ops (they are integer, not field,
arithmetic; every operand is a constant times a limb array); the field steps
in between go through the Field's kernel ops.

signed_digits: c-bit windows with borrow recoding, digits in
[-2^(c-1), 2^(c-1)], so Pippenger needs only 2^(c-1) buckets and
ceil(128/c)+1 rounds instead of ceil(254/c) unsigned ones.

This eager chain is K4 ``glv_digits``' plain version
(``kernels/msm_kernels.py``): on the card the MSMs take their digits from
K4, one launch per call, and the chain runs only where it is compared with
K4; on the CPU it computes the digits.
"""

from __future__ import annotations

import torch

from ..fields import fr as _fr
from ..fields.limbs import int_to_limbs
from ..fields.params import (
    GLV_B2,
    GLV_G1,
    GLV_G2,
    GLV_MINUS_B1,
    LIMB_BITS,
    LIMB_MASK,
    NUM_LIMBS,
)

HALF_BITS = 128
HALF_LIMBS = -(-HALF_BITS // LIMB_BITS)  # 9 limbs cover 135 bits

# Calls of the eager split's limb product on a CUDA tensor since the counter
# was last reset (reset_counts): on the card, K4 glv_digits computes the
# commitments' digits, so the prove path makes none.
cuda_counts = {"mul_full_const": 0}


def reset_counts() -> None:
    cuda_counts["mul_full_const"] = 0


def _mul_full_const(a: torch.Tensor, value: int) -> torch.Tensor:
    """Exact 36-limb product of (18, N) plain limbs with a host constant
    (< 2^270), carry-propagated: (36, N) int64 canonical limbs."""
    if a.is_cuda:
        cuda_counts["mul_full_const"] += 1
    n = a.shape[1]
    a64 = a.to(torch.int64)
    cols = torch.zeros((2 * NUM_LIMBS, n), dtype=torch.int64, device=a.device)
    for j, cj in enumerate(int(v) for v in int_to_limbs(value)):
        if cj:
            cols[j : j + NUM_LIMBS] += a64 * cj  # column sums < 18 * 2^30
    carry = torch.zeros(n, dtype=torch.int64, device=a.device)
    for k in range(2 * NUM_LIMBS):
        v = cols[k] + carry
        cols[k] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return cols


def _mask_to_128(a: torch.Tensor) -> torch.Tensor:
    """Keep the low 128 bits of an 18-limb value."""
    out = torch.zeros_like(a)
    out[:HALF_LIMBS] = a[:HALF_LIMBS]
    top_mask = (1 << (HALF_BITS - (HALF_LIMBS - 1) * LIMB_BITS)) - 1  # 8 bits
    out[HALF_LIMBS - 1] &= top_mask
    return out


def split_scalars(scalars_mont: torch.Tensor):
    """(18, N) internal-Montgomery Fr -> (k1, k2) plain canonical limb
    tensors, each < 2^128, with k = k1 - k2*lambda (mod r)."""
    fr = _fr(scalars_mont.device)
    k = fr.to_plain(scalars_mont)
    c1 = _mul_full_const(k, GLV_G2 << 14)[NUM_LIMBS:]
    c2 = _mul_full_const(k, GLV_G1 << 14)[NUM_LIMBS:]
    # q1 = c1 * minus_b1, q2 = c2 * b2; both < 2^192, no masking needed
    q1 = _mul_full_const(c1, GLV_MINUS_B1)[:NUM_LIMBS].to(torch.int32)
    q2 = _mul_full_const(c2, GLV_B2)[:NUM_LIMBS].to(torch.int32)
    # t1 = q2 - q1 mod r (both < 2^192 < r, so one field sub suffices)
    t1 = fr.sub(q2, q1)
    # t2 = t1 * lambda + k mod r: t1 and k are plain values, and a Montgomery
    # product with lambda's Montgomery form is the plain product
    t2 = fr.add(fr.mul_by_constant(t1, fr.params.cube_root), k)
    return _mask_to_128(t2), _mask_to_128(t1)


def window(limbs: torch.Tensor, lo: int, c: int) -> torch.Tensor:
    """Extract bits [lo, lo+c) of an (18+, N) limb tensor as (N,) int64."""
    l0, sh = lo // LIMB_BITS, lo % LIMB_BITS
    d = limbs[l0].to(torch.int64) >> sh
    got = LIMB_BITS - sh
    j = 1
    while got < c and l0 + j < limbs.shape[0]:
        d = d | (limbs[l0 + j].to(torch.int64) << got)
        got += LIMB_BITS
        j += 1
    return d & ((1 << c) - 1)


def signed_digits_full(value: torch.Tensor, c: int, nbits: int = 254) -> torch.Tensor:
    """(18, N) plain canonical value < 2^nbits -> (ceil(nbits / c) + 1, N)
    int32 signed window digits, LSB window first, the last the final carry;
    digits in [-2^(c-1), 2^(c-1)]. Over the full scalar width this is what
    the arbitrary-base windowed scalar multiplication walks (K3g computes
    the same digits in its own body)."""
    nwin = -(-nbits // c)
    carry = torch.zeros(value.shape[1], dtype=torch.int64, device=value.device)
    out = []
    for r in range(nwin):
        v = window(value, r * c, c) + carry
        carry = (v >= (1 << (c - 1))).to(torch.int64)
        out.append(v - (carry << c))
    out.append(carry)  # final carry digit
    return torch.stack(out).to(torch.int32)


def signed_digits(half: torch.Tensor, c: int) -> torch.Tensor:
    """(18, N) plain value < 2^128 -> (rounds, N) int32 signed window digits,
    LSB window first; digits in [-2^(c-1), 2^(c-1)]."""
    return signed_digits_full(half, c, HALF_BITS)
