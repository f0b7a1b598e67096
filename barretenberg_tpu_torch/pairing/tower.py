"""Fast host optimal-ate pairing via the Fq2/Fq6/Fq12 tower.

The performance machinery of the reference pairing stack rebuilt in host
Python (reference: fields/field2.hpp, field6.hpp, field12.hpp,
curves/bn254/pairing.cpp):

  * Miller lines precomputed once per G2 point (pairing.cpp:120-160), so the
    Miller loop itself touches only G1 coordinates and sparse Fq12 muls;
  * sparse line multiplication exploiting the (o, vw, vv) shape
    (field12.hpp:79 sparse_mul);
  * Frobenius maps via precomputed xi-power coefficients (field6.hpp:267-293,
    field12.hpp:200-222) instead of generic exponentiation;
  * Granger-Scott cyclotomic squaring for the final-exponentiation z-powers
    (field12.hpp:224) and the Fuentes-Castaneda addition chain
    (pairing.cpp:253-331).

All constants are DERIVED from the curve parameters at import (xi-powers,
NAF digits, twist coefficients) and asserted, not transcribed. Elements:
fq2 = (c0, c1) ints; fq6 = (fq2, fq2, fq2); fq12 = (fq6, fq6). The verifier
does ~2 pairings per proof, so host Python is ample here; bulk math is on
device.
"""

from __future__ import annotations

from ..fields.params import FQ_MODULUS

P = FQ_MODULUS
BN_Z = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_Z + 2

# ---------------------------------------------------------------------------
# Fq2 = Fq[i]/(i^2 + 1)
# ---------------------------------------------------------------------------
FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
XI = (9, 1)  # sextic non-residue (curves/bn254/fq6.hpp:43)


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_conj(a):
    return (a[0], (-a[1]) % P)


def fq2_mul(a, b):
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sqr(a):
    t = a[0] * a[1]
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, (t + t) % P)


def fq2_scale(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fq2_inv(a):
    t = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * t % P, -a[1] * t % P)


def fq2_pow(a, e: int):
    r, b = FQ2_ONE, a
    while e:
        if e & 1:
            r = fq2_mul(r, b)
        b = fq2_sqr(b)
        e >>= 1
    return r


def fq2_mul_xi(a):
    """a * (9 + i) (the fq6 non-residue; reference fq6.hpp __mul_by_non_residue)."""
    return ((9 * a[0] - a[1]) % P, (9 * a[1] + a[0]) % P)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi)
# ---------------------------------------------------------------------------
FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a, b):
    t0 = fq2_mul(a[0], b[0])
    t1 = fq2_mul(a[1], b[1])
    t2 = fq2_mul(a[2], b[2])
    c0 = fq2_add(
        t0,
        fq2_mul_xi(
            fq2_sub(
                fq2_mul(fq2_add(a[1], a[2]), fq2_add(b[1], b[2])), fq2_add(t1, t2)
            )
        ),
    )
    c1 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a[0], a[1]), fq2_add(b[0], b[1])), fq2_add(t0, t1)),
        fq2_mul_xi(t2),
    )
    c2 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a[0], a[2]), fq2_add(b[0], b[2])), fq2_add(t0, t2)),
        t1,
    )
    return (c0, c1, c2)


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_inv(a):
    c0 = fq2_sub(fq2_sqr(a[0]), fq2_mul_xi(fq2_mul(a[1], a[2])))
    c1 = fq2_sub(fq2_mul_xi(fq2_sqr(a[2])), fq2_mul(a[0], a[1]))
    c2 = fq2_sub(fq2_sqr(a[1]), fq2_mul(a[0], a[2]))
    t = fq2_inv(
        fq2_add(
            fq2_mul(a[0], c0),
            fq2_mul_xi(fq2_add(fq2_mul(a[2], c1), fq2_mul(a[1], c2))),
        )
    )
    return (fq2_mul(c0, t), fq2_mul(c1, t), fq2_mul(c2, t))


def fq6_mul_by_nonresidue(a):
    """a * v: (a0, a1, a2) -> (xi*a2, a0, a1)."""
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_scale_fq2(a, k):
    return (fq2_mul(a[0], k), fq2_mul(a[1], k), fq2_mul(a[2], k))


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v)
# ---------------------------------------------------------------------------
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)
FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)


def fq12_mul(a, b):
    t0 = fq6_mul(a[0], b[0])
    t1 = fq6_mul(a[1], b[1])
    c0 = fq6_add(t0, fq6_mul_by_nonresidue(t1))
    c1 = fq6_sub(
        fq6_mul(fq6_add(a[0], a[1]), fq6_add(b[0], b[1])), fq6_add(t0, t1)
    )
    return (c0, c1)


def fq12_sqr(a):
    t = fq6_mul(a[0], a[1])
    c0 = fq6_sub(
        fq6_mul(fq6_add(a[0], a[1]), fq6_add(a[0], fq6_mul_by_nonresidue(a[1]))),
        fq6_add(t, fq6_mul_by_nonresidue(t)),
    )
    return (c0, fq6_add(t, t))


def fq12_inv(a):
    t = fq6_inv(fq6_sub(fq6_sqr(a[0]), fq6_mul_by_nonresidue(fq6_sqr(a[1]))))
    return (fq6_mul(a[0], t), fq6_neg(fq6_mul(a[1], t)))


def fq12_conj(a):
    """Unitary inverse (field12.hpp:230): inverse of cyclotomic elements."""
    return (a[0], fq6_neg(a[1]))


def fq12_eq_one(a) -> bool:
    return a == FQ12_ONE


# ---------------------------------------------------------------------------
# Frobenius coefficients, derived from xi (not transcribed):
#   fq6:  c1 coeff_k = xi^((p^k - 1)/3),  c2 coeff_k = xi^(2(p^k - 1)/3)
#   fq12: w  coeff_k = xi^((p^k - 1)/6)
# ---------------------------------------------------------------------------
def _derive_frobenius():
    c1, c2, w = {}, {}, {}
    for k in (1, 2, 3):
        pk = P**k
        assert (pk - 1) % 6 == 0
        c1[k] = fq2_pow(XI, (pk - 1) // 3)
        c2[k] = fq2_pow(XI, 2 * (pk - 1) // 3)
        w[k] = fq2_pow(XI, (pk - 1) // 6)
    return c1, c2, w


_FROB_C1, _FROB_C2, _FROB_W = _derive_frobenius()


def _fq2_frob(a, k):
    return a if k % 2 == 0 else fq2_conj(a)


def fq6_frobenius(a, k: int):
    return (
        _fq2_frob(a[0], k),
        fq2_mul(_fq2_frob(a[1], k), _FROB_C1[k]),
        fq2_mul(_fq2_frob(a[2], k), _FROB_C2[k]),
    )


def fq12_frobenius(a, k: int):
    return (
        fq6_frobenius(a[0], k),
        fq6_scale_fq2(fq6_frobenius(a[1], k), _FROB_W[k]),
    )


# ---------------------------------------------------------------------------
# Cyclotomic squaring (Granger-Scott; reference field12.hpp:224).
# Coordinates in the w-basis (w^6 = xi): z = sum c_j w^j with
# (c0..c5) = (x0, x3, x1, x4, x2, x5) in tower coords
# x = (x0 + x1 v + x2 v^2) + w (x3 + x4 v + x5 v^2), v = w^2.
# ---------------------------------------------------------------------------
def fq12_cyclotomic_sqr(a):
    (x0, x1, x2), (x3, x4, x5) = a
    t0 = fq2_sqr(x4)
    t1 = fq2_sqr(x0)
    t6 = fq2_sub(fq2_sqr(fq2_add(x4, x0)), fq2_add(t0, t1))  # 2 x0 x4
    t2 = fq2_sqr(x2)
    t3 = fq2_sqr(x3)
    t7 = fq2_sub(fq2_sqr(fq2_add(x2, x3)), fq2_add(t2, t3))  # 2 x2 x3
    t4 = fq2_sqr(x5)
    t5 = fq2_sqr(x1)
    t8 = fq2_mul_xi(fq2_sub(fq2_sqr(fq2_add(x5, x1)), fq2_add(t4, t5)))
    t0 = fq2_add(fq2_mul_xi(t0), t1)
    t2 = fq2_add(fq2_mul_xi(t2), t3)
    t4 = fq2_add(fq2_mul_xi(t4), t5)
    z0 = fq2_add(fq2_scale(fq2_sub(t0, x0), 2), t0)
    z1 = fq2_add(fq2_scale(fq2_sub(t2, x1), 2), t2)
    z2 = fq2_add(fq2_scale(fq2_sub(t4, x2), 2), t4)
    z3 = fq2_add(fq2_scale(fq2_add(t8, x3), 2), t8)
    z4 = fq2_add(fq2_scale(fq2_add(t6, x4), 2), t6)
    z5 = fq2_add(fq2_scale(fq2_add(t7, x5), 2), t7)
    return ((z0, z1, z2), (z3, z4, z5))


def _exp_by_neg_z(a):
    """a^(-z) for cyclotomic a (pairing.cpp:269-284): square-multiply over
    the bits of z with cyclotomic squarings, then unitary inverse."""
    r = a
    for i in range(BN_Z.bit_length() - 2, -1, -1):
        r = fq12_cyclotomic_sqr(r)
        if (BN_Z >> i) & 1:
            r = fq12_mul(r, a)
    return fq12_conj(r)


# ---------------------------------------------------------------------------
# G2 twist-curve arithmetic + Miller line precompute
# (pairing.cpp:24-160). Points are homogeneous projective (X, Y, Z) over Fq2
# on y^2 = x^3 + b', b' = 3/xi. Lines are (o, vw, vv) fq2 triples; the
# sparse fq12 multiplicand is c0.c0 = o*? see _sparse_mul.
# ---------------------------------------------------------------------------
TWIST_B = fq2_mul((3, 0), fq2_inv(XI))
_INV2 = pow(2, -1, P)


def _dbl_step(cur):
    """Tangent-line doubling (pairing.cpp:24-77). Returns (new_point, line)."""
    x, y, z = cur
    a = fq2_scale(fq2_mul(x, y), _INV2)
    b = fq2_sqr(y)
    c = fq2_sqr(z)
    d = fq2_scale(c, 3)
    e = fq2_mul(TWIST_B, d)
    f = fq2_scale(e, 3)
    g = fq2_scale(fq2_add(b, f), _INV2)
    h = fq2_sub(fq2_sqr(fq2_add(y, z)), fq2_add(b, c))
    i = fq2_sub(e, b)
    j = fq2_sqr(x)
    ee = fq2_sqr(e)
    nx = fq2_mul(a, fq2_sub(b, f))
    ny = fq2_sub(fq2_sqr(g), fq2_scale(ee, 3))
    nz = fq2_mul(b, h)
    line = (fq2_mul_xi(i), fq2_neg(h), fq2_scale(j, 3))
    return (nx, ny, nz), line


def _add_step(base, q):
    """Chord-line mixed addition (pairing.cpp:79-118). base: affine-ish
    (X, Y) with Z=1. Returns (new_point, line)."""
    bx, by = base
    qx, qy, qz = q
    d = fq2_sub(qx, fq2_mul(bx, qz))
    e = fq2_sub(qy, fq2_mul(by, qz))
    f = fq2_sqr(d)
    g = fq2_sqr(e)
    h = fq2_mul(d, f)
    i = fq2_mul(qx, f)
    j = fq2_sub(fq2_add(fq2_mul(qz, g), h), fq2_scale(i, 2))
    nx = fq2_mul(d, j)
    ny = fq2_sub(fq2_mul(fq2_sub(i, j), e), fq2_mul(qy, h))
    nz = fq2_mul(qz, h)
    line = (
        fq2_mul_xi(fq2_sub(fq2_mul(e, bx), fq2_mul(d, by))),
        d,
        fq2_neg(e),
    )
    return (nx, ny, nz), line


def _naf(t: int) -> list[int]:
    """Canonical NAF digits, MSB-first, leading digit dropped (it is 1)."""
    digits = []
    k = t
    while k:
        if k & 1:
            d = 2 - (k % 4)
            digits.append(d)
            k -= d
        else:
            digits.append(0)
        k >>= 1
    digits.reverse()
    assert digits[0] == 1
    # self-check the expansion
    s = 0
    for d in digits:
        s = 2 * s + d
    assert s == t
    return digits[1:]


_ATE_NAF = _naf(ATE_LOOP_COUNT)


_TWIST_Q_X = _FROB_C1[1]  # xi^((p-1)/3) == reference twist_mul_by_q_x
_TWIST_Q_Y = fq2_pow(XI, (P - 1) // 2)  # == reference twist_mul_by_q_y


def _mul_by_q(pt):
    """Untwist-Frobenius-twist endomorphism on affine-ish G2 points
    (pairing.cpp:12-22): (x, y) -> (qx * conj(x), qy * conj(y))."""
    x, y = pt
    return (
        fq2_mul(_TWIST_Q_X, fq2_conj(x)),
        fq2_mul(_TWIST_Q_Y, fq2_conj(y)),
    )


def precompute_miller_lines(q_affine) -> list:
    """All line coefficients for a fixed G2 point (pairing.cpp:120-160).
    q_affine: ((x0,x1),(y0,y1)) host ints. Returns the line list consumed by
    miller_loop_precomputed."""
    qx, qy = q_affine
    q = (qx, qy)
    q_neg = (qx, fq2_neg(qy))
    work = (qx, qy, FQ2_ONE)
    lines = []
    for d in _ATE_NAF:
        work, line = _dbl_step(work)
        lines.append(line)
        if d == 1:
            work, line = _add_step(q, work)
            lines.append(line)
        elif d == -1:
            work, line = _add_step(q_neg, work)
            lines.append(line)
    q1 = _mul_by_q(q)
    q2 = _mul_by_q(q1)
    q2 = (q2[0], fq2_neg(q2[1]))
    work, line = _add_step(q1, work)
    lines.append(line)
    _, line = _add_step(q2, work)
    lines.append(line)
    return lines


def _sparse_mul(a, line, px: int, py: int):
    """a * L where L is the evaluated line: the fq12 element with
    c0.c0 = o, c0.c2 = vv*px, c1.c1 = vw*py, rest zero
    (field12.hpp sparse_mul's layout; we expand via two sparse fq6 muls)."""
    o, vw, vv = line
    vw = fq2_scale(vw, py)
    vv = fq2_scale(vv, px)
    a0, a1 = a
    # b0 = (o, 0, vv); b1 = (0, vw, 0)
    # t0 = a0*b0, t1 = a1*b1, using sparsity:
    t0 = _fq6_mul_sparse_02(a0, o, vv)
    t1 = _fq6_mul_sparse_1(a1, vw)
    c0 = fq6_add(t0, fq6_mul_by_nonresidue(t1))
    # (a0+a1) * (b0+b1) where b0+b1 = (o, vw, vv)
    s = fq6_add(a0, a1)
    t2 = _fq6_mul_sparse_012(s, o, vw, vv)
    c1 = fq6_sub(t2, fq6_add(t0, t1))
    return (c0, c1)


def _fq6_mul_sparse_02(a, b0, b2):
    """a * (b0, 0, b2)."""
    t0 = fq2_mul(a[0], b0)
    t2 = fq2_mul(a[2], b2)
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_mul(fq2_add(a[1], a[2]), b2), t2)))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a[0], a[1]), b0), t0), fq2_mul_xi(t2))
    c2 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a[0], a[2]), fq2_add(b0, b2)), fq2_add(t0, t2)),
        FQ2_ZERO,
    )
    return (c0, c1, c2)


def _fq6_mul_sparse_1(a, b1):
    """a * (0, b1, 0)."""
    return (
        fq2_mul_xi(fq2_mul(a[2], b1)),
        fq2_mul(a[0], b1),
        fq2_mul(a[1], b1),
    )


def _fq6_mul_sparse_012(a, b0, b1, b2):
    """a * (b0, b1, b2) - full product (b dense after the line sum)."""
    return fq6_mul(a, (b0, b1, b2))


def miller_loop_precomputed(points, lines_list):
    """Batched Miller loop sharing the squaring chain
    (pairing.cpp:202-251). points: [(px, py)] host ints; lines_list:
    matching precomputed line lists."""
    f = FQ12_ONE
    it = 0
    for d in _ATE_NAF:
        f = fq12_sqr(f)
        for (px, py), lines in zip(points, lines_list):
            f = _sparse_mul(f, lines[it], px, py)
        it += 1
        if d != 0:
            for (px, py), lines in zip(points, lines_list):
                f = _sparse_mul(f, lines[it], px, py)
            it += 1
    for _ in range(2):
        for (px, py), lines in zip(points, lines_list):
            f = _sparse_mul(f, lines[it], px, py)
        it += 1
    return f


def final_exponentiation(f):
    """Easy part (pairing.cpp:253-265) + Fuentes-Castaneda hard part
    (pairing.cpp:267-331): canonical pairing raised to 2z(6z^2+3z+1)."""
    # easy: f^(p^6 - 1) then ^(p^2 + 1)
    a = fq12_mul(fq12_conj(f), fq12_inv(f))
    a = fq12_mul(a, fq12_frobenius(a, 2))
    # hard (Fuentes-Castaneda)
    elt = a
    A = _exp_by_neg_z(elt)
    B = fq12_cyclotomic_sqr(A)
    C = fq12_cyclotomic_sqr(B)
    D = fq12_mul(C, B)
    E = _exp_by_neg_z(D)
    F = fq12_cyclotomic_sqr(E)
    G = _exp_by_neg_z(F)
    H = fq12_conj(D)
    I = fq12_conj(G)
    J = fq12_mul(I, E)
    K = fq12_mul(H, J)
    L = fq12_mul(B, K)
    M = fq12_mul(E, K)
    N = fq12_mul(M, elt)
    O = fq12_frobenius(L, 1)
    Pp = fq12_mul(O, N)
    Q = fq12_frobenius(K, 2)
    R = fq12_mul(Pp, Q)
    S = fq12_conj(elt)
    T = fq12_mul(L, S)
    U = fq12_frobenius(T, 3)
    return fq12_mul(R, U)


def reduced_ate_pairing_batch(pairs):
    """prod e(P_i, Q_i) in tower coordinates. pairs: [((px,py) ints,
    ((x0,x1),(y0,y1)) fq2 pairs)], None entries skipped."""
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    if not live:
        return FQ12_ONE
    points = [p for p, _ in live]
    lines = [precompute_miller_lines(q) for _, q in live]
    return final_exponentiation(miller_loop_precomputed(points, lines))


def reduced_ate_pairing_batch_precomputed(points, lines_list):
    """Verifier entry (pairing.cpp:349-362): points with already-precomputed
    G2 lines (e.g. the SRS's [1]_2 and [x]_2)."""
    return final_exponentiation(miller_loop_precomputed(points, lines_list))


def tower_to_flat(t):
    """Tower fq12 -> the flat Fq[w]/(w^12 - 18w^6 + 82) basis used by the
    legacy host module (w_tower = w_flat, i = w^6 - 9)."""
    flat = [0] * 12
    for i6 in range(2):
        for j in range(3):
            x, y = t[i6][j]
            d = i6 + 2 * j
            flat[d] = (flat[d] + x - 9 * y) % P
            flat[d + 6] = (flat[d + 6] + y) % P
    return tuple(flat)
