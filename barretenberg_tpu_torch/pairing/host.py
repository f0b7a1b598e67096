"""Optimal-ate pairing for BN254, host-side.

Coverage analog of the reference's pairing stack (reference:
curves/bn254/pairing.cpp, fields/field6.hpp, field12.hpp), built differently:
instead of the Fq2/Fq6/Fq12 tower with sparse line multiplication, we use a
single flat degree-12 extension FQ12 = Fq[w]/(w^12 - 18 w^6 + 82) with plain
Python integers. The verifier performs only ~2 pairings per proof
(reference: verifier.cpp:376-379), so this path is host-bound by design;
bulk G1/Fr math stays on device.

Embedding facts used (standard for alt_bn128):
  * i := w^6 - 9 satisfies i^2 = -1, so Fq2 = Fq[i] embeds at positions 0,6.
  * the sextic twist maps G2 points (x, y) in Fq2 to (x~ * w^2, y~ * w^3)
    on y^2 = x^3 + 3 over FQ12, where x~ is x rewritten in the i basis.
  * ate loop count = 6z + 2 with z = 4965661367192848881.
"""

from __future__ import annotations

from ..fields.params import FQ_MODULUS, FR_MODULUS

P = FQ_MODULUS
R = FR_MODULUS

BN_Z = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_Z + 2  # 29793968203157093288
_LOG_ATE = ATE_LOOP_COUNT.bit_length() - 1

DEG = 12
# w^12 = 18 w^6 - 82
_W12_C6 = 18
_W12_C0 = -82


# ---------------------------------------------------------------------------
# FQ12 arithmetic: elements are tuples of 12 ints mod P (coeff of w^k).
# ---------------------------------------------------------------------------
FQ12_ONE = (1,) + (0,) * 11
FQ12_ZERO = (0,) * 12


def fq12_from_fq(c: int):
    return (c % P,) + (0,) * 11


def fq12_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def fq12_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def fq12_neg(a):
    return tuple((-x) % P for x in a)


def fq12_scale(a, k: int):
    k %= P
    return tuple(x * k % P for x in a)


def fq12_mul(a, b):
    wide = [0] * 23
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                wide[i + j] += ai * bj
    # reduce degrees 22..12 with w^12 = 18 w^6 - 82
    for k in range(22, 11, -1):
        c = wide[k]
        if c:
            wide[k - 6] += c * _W12_C6
            wide[k - 12] += c * _W12_C0
            wide[k] = 0
    return tuple(c % P for c in wide[:12])


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_pow(a, e: int):
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


def _poly_divmod_deg(num, den):
    """Remainder-producing division step helper for extended Euclid, on
    coefficient lists (low-to-high) over Fq."""
    num = list(num)
    den_deg = _deg(den)
    den_lead_inv = pow(den[den_deg], -1, P)
    q = [0] * (len(num))
    while True:
        n_deg = _deg(num)
        if n_deg < den_deg:
            return q, num
        shift = n_deg - den_deg
        factor = num[n_deg] * den_lead_inv % P
        q[shift] = (q[shift] + factor) % P
        for i in range(den_deg + 1):
            num[shift + i] = (num[shift + i] - factor * den[i]) % P


def _deg(poly):
    for i in range(len(poly) - 1, -1, -1):
        if poly[i]:
            return i
    return -1


_MODULUS_POLY = [(-_W12_C0) % P] + [0] * 5 + [(-_W12_C6) % P] + [0] * 5 + [1]


def fq12_inv(a):
    """Extended Euclid in Fq[w] modulo the defining polynomial."""
    lm, hm = [1] + [0] * 12, [0] * 13
    low, high = list(a) + [0], list(_MODULUS_POLY)
    while _deg(low) > 0:
        q, _ = _poly_divmod_deg(high, low)
        nm = [(hm[i] - sum(q[j] * lm[i - j] for j in range(max(0, i - 12), min(i + 1, _deg(q) + 1)))) % P for i in range(13)]
        new = [(high[i] - sum(q[j] * low[i - j] for j in range(max(0, i - 12), min(i + 1, _deg(q) + 1)))) % P for i in range(13)]
        lm, low, hm, high = nm, new, lm, low
    if _deg(low) == -1:
        raise ZeroDivisionError("fq12 inverse of zero")
    c_inv = pow(low[0], -1, P)
    return tuple(x * c_inv % P for x in lm[:12])


def fq12_eq_one(a) -> bool:
    return a[0] % P == 1 and all(x % P == 0 for x in a[1:])


# ---------------------------------------------------------------------------
# Curve points over FQ12 (affine tuples (x, y); None = infinity).
# ---------------------------------------------------------------------------
def _pt_double(pt):
    x, y = pt
    lam = fq12_mul(fq12_scale(fq12_sqr(x), 3), fq12_inv(fq12_scale(y, 2)))
    nx = fq12_sub(fq12_sqr(lam), fq12_scale(x, 2))
    ny = fq12_sub(fq12_mul(lam, fq12_sub(x, nx)), y)
    return (nx, ny)


def _pt_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _pt_double(p1)
        return None
    lam = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
    nx = fq12_sub(fq12_sqr(lam), fq12_add(x1, x2))
    ny = fq12_sub(fq12_mul(lam, fq12_sub(x1, nx)), y1)
    return (nx, ny)


def _linefunc(p1, p2, t):
    """Line through p1,p2 (or tangent if equal) evaluated at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
    elif y1 == y2:
        m = fq12_mul(fq12_scale(fq12_sqr(x1), 3), fq12_inv(fq12_scale(y1, 2)))
    else:
        return fq12_sub(xt, x1)
    return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))


# ---------------------------------------------------------------------------
# Twist embedding
# ---------------------------------------------------------------------------
def embed_g1(pt):
    """(x, y) ints -> FQ12 affine point."""
    if pt is None:
        return None
    return (fq12_from_fq(pt[0]), fq12_from_fq(pt[1]))


def _fq2_to_fq12(c):
    """Fq2 element (c0, c1) with basis {1, i}, i = w^6 - 9:
    c0 + c1*i = (c0 - 9 c1) + c1 * w^6."""
    c0, c1 = c
    out = [0] * 12
    out[0] = (c0 - 9 * c1) % P
    out[6] = c1 % P
    return tuple(out)


_W2 = tuple(1 if i == 2 else 0 for i in range(12))
_W3 = tuple(1 if i == 3 else 0 for i in range(12))


def twist_g2(pt):
    """G2 affine point ((x0,x1),(y0,y1)) -> FQ12 point on y^2 = x^3 + 3."""
    if pt is None:
        return None
    x = fq12_mul(_fq2_to_fq12(pt[0]), _W2)
    y = fq12_mul(_fq2_to_fq12(pt[1]), _W3)
    return (x, y)


def _frobenius_pt(pt):
    """(x, y) -> (x^p, y^p) via FQ12 pow (used twice per Miller loop)."""
    return (fq12_pow(pt[0], P), fq12_pow(pt[1], P))


# ---------------------------------------------------------------------------
# Miller loop + final exponentiation
# ---------------------------------------------------------------------------
def miller_loop_batch(pairs) -> tuple:
    """Product of Miller loops over [(P_g1, Q_g2_twisted)] with the shared
    squaring chain (the batching rationale of reference pairing.cpp:202-251),
    WITHOUT final exponentiation."""
    live = [(q, q, p) for (p, q) in pairs if p is not None and q is not None]
    f = FQ12_ONE
    state = [list(t) for t in live]
    for i in range(_LOG_ATE - 1, -1, -1):
        f = fq12_sqr(f)
        for s in state:
            q, r, p = s
            f = fq12_mul(f, _linefunc(r, r, p))
            s[1] = _pt_double(r)
        if ATE_LOOP_COUNT & (1 << i):
            for s in state:
                q, r, p = s
                f = fq12_mul(f, _linefunc(r, q, p))
                s[1] = _pt_add(r, q)
    for s in state:
        q, r, p = s
        q1 = _frobenius_pt(q)
        nq2 = _frobenius_pt(q1)
        nq2 = (nq2[0], fq12_neg(nq2[1]))
        f = fq12_mul(f, _linefunc(r, q1, p))
        r2 = _pt_add(r, q1)
        f = fq12_mul(f, _linefunc(r2, nq2, p))
    return f


# The reference's final exponentiation (pairing.cpp:253-331) is the
# Fuentes-Castaneda addition chain, which computes the canonical reduced
# pairing raised to the fixed power d = 2z(6z^2 + 3z + 1) (a standard,
# equally secure variant - d is coprime to r). tower.py implements that
# chain; the slow flat-basis fq12_pow below is kept as the oracle.
_FC_SCALE = 2 * BN_Z * (6 * BN_Z * BN_Z + 3 * BN_Z + 1)
_FINAL_EXP = (P**12 - 1) // R * _FC_SCALE


def final_exponentiation(f) -> tuple:
    """Oracle-grade final exp on flat-basis elements (one giant fq12_pow).
    The fast path lives in tower.final_exponentiation."""
    return fq12_pow(f, _FINAL_EXP)


def reduced_ate_pairing(p_g1, q_g2) -> tuple:
    """e(P, Q) for host points: P = (x, y) ints, Q = ((x0,x1),(y0,y1)).
    (reference: pairing.cpp:333-347). Computed via the fast tower path,
    returned in the flat basis."""
    return reduced_ate_pairing_batch([(p_g1, q_g2)])


def reduced_ate_pairing_batch(pairs) -> tuple:
    """prod e(P_i, Q_i) over host points (reference: pairing.cpp:364-385)."""
    from . import tower

    return tower.tower_to_flat(tower.reduced_ate_pairing_batch(pairs))


def reduced_ate_pairing_slow(p_g1, q_g2) -> tuple:
    """The original flat-basis path (Miller loop over embedded FQ12 points +
    one-shot exponentiation). Kept as a cross-implementation oracle for
    tower.py (the reference's slow-vs-fast test pattern)."""
    f = miller_loop_batch([(embed_g1(p_g1), twist_g2(q_g2))])
    return final_exponentiation(f)


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 (the verifier's final gate,
    reference verifier.cpp:376-379)."""
    return fq12_eq_one(reduced_ate_pairing_batch(pairs))
