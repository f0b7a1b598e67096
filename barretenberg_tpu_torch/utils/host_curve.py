"""Host-side (pure Python int) BN254 arithmetic: the slow oracle.

Serves three roles, mirroring the reference's test strategy of checking fast
paths against naive ones (reference: test/test_scalar_multiplication.cpp:72):
  * test oracle for the device kernels (field, group law, MSM, FFT);
  * SRS generation (powers-of-tau) and G2 arithmetic until a device Fq2
    tower exists;
  * building block for the pairing (pairing/ runs on host - only ~2 pairings
    per verification, reference verifier.cpp:376).

Everything here is arbitrary-precision Python ints - slow, obviously correct.
"""

from __future__ import annotations

from ..fields.params import FQ_MODULUS, FR_MODULUS

P = FQ_MODULUS
R = FR_MODULUS


# ---------------------------------------------------------------------------
# G1: affine/Jacobian tuples (x, y, z) of ints; None = point at infinity.
# ---------------------------------------------------------------------------
G1_B = 3
G1_GENERATOR = (1, 2)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - G1_B) % P == 0


def g1_add(a, b):
    """Affine addition on G1 (host oracle)."""
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_neg(a):
    if a is None:
        return None
    return (a[0], (-a[1]) % P)


def g1_mul(a, k: int):
    k %= R
    result = None
    addend = a
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_add(addend, addend)
        k >>= 1
    return result


def g1_msm(points, scalars):
    acc = None
    for pt, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(pt, s))
    return acc


# ---------------------------------------------------------------------------
# Fq2 = Fq[i]/(i^2+1): pairs (c0, c1). (reference: fields/field2.hpp)
# ---------------------------------------------------------------------------
def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_mul(a, b):
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_mul_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def fq2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * d % P, (-a[1]) * d % P)


def fq2_conj(a):
    return (a[0], (-a[1]) % P)


FQ2_ONE = (1, 0)
FQ2_ZERO = (0, 0)

# Twist constant: b' = b / xi where xi = 9 + i (reference curves/bn254/fq2.hpp
# twist_coeff_b). b' = 3 * (9+i)^-1.
XI = (9, 1)
TWIST_B = fq2_mul_scalar(fq2_inv(XI), G1_B)

# G2 generator (values; reference curves/bn254/g2.hpp:9-23 gives Montgomery
# form - converted via R^-1, asserted in tests).
_RINV = pow(1 << 256, -1, P)
G2_GENERATOR = (
    (
        0x19573841AF96503BFBB8264797811ADFDCEB1935497B01728E83B5D102BC2026 * _RINV % P,
        0x14FEF0833AEA7B6B09E950FC52A02F866043DD5A5802D8C4AFB4737DA84C6140 * _RINV % P,
    ),
    (
        0x28FD7EEBAE9E4206FF9E1A62231B7DFEFE7FD297F59E9B78619DFA9D886BE9F6 * _RINV % P,
        0x0DA4A0E693FD648255F935BE33351076DC57F922327D3CBB64095B56C71856EE * _RINV % P,
    ),
)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = fq2_sqr(y)
    rhs = fq2_add(fq2_mul(fq2_sqr(x), x), TWIST_B)
    return lhs == rhs


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        lam = fq2_mul(fq2_mul_scalar(fq2_sqr(x1), 3), fq2_inv(fq2_mul_scalar(y1, 2)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sqr(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(a):
    if a is None:
        return None
    return (a[0], fq2_neg(a[1]))


def g2_mul(a, k: int):
    k %= R
    result = None
    addend = a
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result
