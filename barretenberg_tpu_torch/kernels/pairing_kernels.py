"""K5a ``miller_loop`` and K5b ``final_exp``: the BN254 pairing's two chains,
one launch each (``csrc/pairing.cu`` + ``csrc/tower.cuh``).

They replace the JAX package's ``lax.scan`` of Fq12 ops in ``_miller_jit``
(``pairing/device.py:132-152``) and its microcoded ``fori_loop`` +
``lax.switch`` in ``_final_exp_jit`` (``:193-243``), with the group
product of ``_group_product_jit`` folded into K5b: the launch chains of
``_mul_fn`` (``kernels/field_kernels.py:64``) on the pairing's path, as K1
``pow`` and K3d took over those of the Fermat inversion and the
double-and-add.

K5a takes the Miller lines of each distinct G2 point once - a table
``(nq, L, 3, 2, 18)`` of the host's (o, vw, vv) rows, L = 88 for BN254 -
and per lane the index of its Q and its P's coordinates; it scales vw by
P.y and vv by P.x as it reads a row, the values of the host's
``fq2_scale``. Each of the NAF's 65 steps is one Fq12 squaring and two
sparse products by the lines ``i1[s]`` and ``i2[s]`` (index L is the
identity line a zero digit takes), then come the two Frobenius add-lines
(rows L - 2 and L - 1). K5b folds each group of g consecutive lanes with
Fq12 products and runs the easy part and the Fuentes-Castaneda chain,
straight-line calls of the tower ops in the JAX package's ``_PROGRAM``
order.

What bounds them on the card: neither rate. Each is a serial chain of
Montgomery products on one thread (``MILLER_CHAIN_PRODUCTS`` a lane,
``FINAL_EXP_CHAIN_PRODUCTS`` a group), so each product's dependent latency sets
the time; CTAs are one warp each to spread the lanes over the SMs. What
the design does about it: the whole chain is one launch (the JAX schedule
was one ``_mul_fn`` call per Fq product, 9,468 a Miller loop with its dense
line products), the tower values live in lane-interleaved device scratch
and pass by pointer to ``__noinline__`` tower functions, so no Fq12 value
sits in registers across the loop (see ``csrc/tower.cuh``).

A CUDA tensor always launches the kernel (or raises); a CPU tensor always
takes the plain version: the same functions over the Fq12 tower written as
batched limb ops (``LimbField``), each Fq2 product of a tower op stacked
into one Montgomery product call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import FQ_PARAMS, NUM_LIMBS, R_INTERNAL
from ..pairing import tower as ht
from . import build
from .field_kernels import limb_field, plain_pow

L = NUM_LIMBS
LINE_WORDS = 3 * 2 * L  # csrc/pairing.cu: one table row (o, vw, vv)
MILLER_MAX_STEPS = 96  # csrc/pairing.cu

NAF = ht._ATE_NAF

FINAL_EXP_SLOTS = 7  # csrc/pairing.cu: K5b's Fq12 registers a group

# Montgomery products, counted from csrc/tower.cuh: Fq2 mul 3, sqr 2; Fq6
# mul 18 (by (o, 0, vv) 15, by (0, vw, 0) 9); Fq12 mul 54, sqr 36, sparse
# line product 42 (+ 4 to scale the line by P), cyclotomic squaring 18,
# Frobenius 21, inverse 471 (an Fq inversion is K1 pow's 362 products: 253
# squarings, 109 multiplications).
F12_MUL, F12_SQR, F12_CSQ, F12_FROB, F12_INV, F12_LINE = 54, 36, 18, 21, 471, 42 + 4
Z_STEPS = ht.BN_Z.bit_length() - 1  # exp-by-neg-z's squarings
Z_SET_BITS = bin(ht.BN_Z).count("1") - 1  # z's set bits below its top bit
MILLER_LINES = len(NAF) + sum(d != 0 for d in NAF) + 2  # a Q's lines


def _final_exp_products(expz: int) -> int:
    """The easy part and the Fuentes-Castaneda chain: 12 Fq12 products, 3
    cyclotomic squarings, 4 Frobenius maps, an inverse, 3 exp-by-neg-z."""
    return 12 * F12_MUL + 3 * F12_CSQ + 4 * F12_FROB + F12_INV + 3 * expz


# What the kernels run, a lane (K5a) and a group (K5b, before its fold of g
# lanes, (g - 1) x 54): every NAF step takes two line products (a zero digit
# its second with the identity line), exp-by-neg-z a product at every bit.
MILLER_CHAIN_PRODUCTS = len(NAF) * (F12_SQR + 2 * F12_LINE) + 2 * F12_LINE
FINAL_EXP_CHAIN_PRODUCTS = _final_exp_products(Z_STEPS * (F12_CSQ + F12_MUL))
# What the functions need: a Q's lines once each, the first squaring (of
# one) and the first line's product by one (its scaling only) left out;
# exp-by-neg-z's products at z's set bits only. The smoke's bounds count
# these.
MILLER_PRODUCTS = (len(NAF) - 1) * F12_SQR + (MILLER_LINES - 1) * F12_LINE + 4
FINAL_EXP_PRODUCTS = _final_exp_products(Z_STEPS * F12_CSQ + Z_SET_BITS * F12_MUL)

# Kernel launches since the counters were last reset (reset_counts).
launch_counts = {"miller_loop": 0, "final_exp": 0}


def reset_counts() -> None:
    for op in launch_counts:
        launch_counts[op] = 0


def miller_steps(n_lines: int):
    """Per NAF step the indices of its two lines in a Q's line list of
    ``n_lines`` (the JAX package's i1 / i2; ``n_lines`` is the identity
    line of a zero digit). The last two lines are the Frobenius add-lines."""
    i1, i2, it = [], [], 0
    for d in NAF:
        i1.append(it)
        it += 1
        if d != 0:
            i2.append(it)
            it += 1
        else:
            i2.append(n_lines)
    if it != n_lines - 2:
        raise ValueError(f"a Q's line list has {n_lines} lines, the NAF takes {it + 2}")
    return i1, i2


# ---------------------------------------------------------------------------
# the plain versions: the tower on limb-first tensors - Fq2 (18, ..., 2, B),
# Fq6 (18, ..., 3, 2, B), Fq12 (18, ..., 2, 3, 2, B) - each op a few batched
# LimbField calls
# ---------------------------------------------------------------------------
def _lf():
    return limb_field(FQ_PARAMS)


@functools.lru_cache(maxsize=None)
def _const_col(value: int, ndim: int, device) -> torch.Tensor:
    """Limbs of a field value, internal form, shaped (18, 1, ..., 1)."""
    return _lf().const_rows(value, torch.zeros((L,) + (1,) * (ndim - 1), device=device))


def _st(xs, dim):
    return torch.stack(xs, dim)


def _f2_mul(a, b):
    lf = _lf()
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
    s = lf.add(_st([a0, b0], 1), _st([a1, b1], 1))
    t = lf.mont_mul(_st([a0, a1, s[:, 0]], 1), _st([b0, b1, s[:, 1]], 1))
    c = lf.sub(_st([t[:, 0], t[:, 2]], 1), _st([t[:, 1], lf.add(t[:, 0], t[:, 1])], 1))
    return c.movedim(1, -2)


def _f2_sqr(a):
    lf = _lf()
    a0, a1 = a[..., 0, :], a[..., 1, :]
    m = lf.mont_mul(_st([a0, lf.add(a0, a1)], 1), _st([a1, lf.sub(a0, a1)], 1))
    return _st([m[:, 1], lf.add(m[:, 0], m[:, 0])], -2)


def _f2_mul_xi(a):
    lf = _lf()
    n = lf.mont_mul(a, _const_col(9, a.ndim, a.device))
    return _st([lf.sub(n[..., 0, :], a[..., 1, :]), lf.add(n[..., 1, :], a[..., 0, :])], -2)


def _f2_inv(a):
    lf = _lf()
    sq = lf.mont_mul(a, a)
    inv = plain_pow(FQ_PARAMS, lf.add(sq[..., 0, :], sq[..., 1, :]), FQ_PARAMS.modulus - 2)
    m = lf.mont_mul(a, inv.unsqueeze(-2))
    return _st([m[..., 0, :], lf.neg(m[..., 1, :])], -2)


_IL, _IR = [1, 0, 0], [2, 1, 2]


def _f6(a, j):
    return a[..., j, :, :]


def _f6_mul(a, b):
    lf = _lf()
    a, b = torch.broadcast_tensors(a, b)
    s = lf.add(_st([a[..., _IL, :, :], b[..., _IL, :, :]], 1), _st([a[..., _IR, :, :], b[..., _IR, :, :]], 1))
    t = _f2_mul(torch.cat([a, s[:, 0]], -3), torch.cat([b, s[:, 1]], -3))
    t3, m = t[..., :3, :, :], t[..., 3:, :, :]
    u = lf.sub(m, lf.add(t3[..., _IL, :, :], t3[..., _IR, :, :]))
    x = _f2_mul_xi(_st([_f6(u, 0), _f6(t3, 2)], -3))
    return lf.add(_st([_f6(t3, 0), _f6(u, 1), _f6(u, 2)], -3), _st([_f6(x, 0), _f6(x, 1), _f6(t3, 1)], -3))


def _f6_nr(a):
    return _st([_f2_mul_xi(_f6(a, 2)), _f6(a, 0), _f6(a, 1)], -3)


def _f6_inv(a):
    lf = _lf()
    a0, a1, a2 = _f6(a, 0), _f6(a, 1), _f6(a, 2)
    m = _f2_mul(_st([a0, a1, a2, a1, a0, a0], -3), _st([a0, a2, a2, a1, a1, a2], -3))
    x = _f2_mul_xi(_st([_f6(m, 1), _f6(m, 2)], -3))
    c = lf.sub(_st([_f6(m, 0), _f6(x, 1), _f6(m, 3)], -3), _st([_f6(x, 0), _f6(m, 4), _f6(m, 5)], -3))
    n = _f2_mul(_st([a0, a2, a1], -3), c)
    t = _f2_inv(lf.add(_f6(n, 0), _f2_mul_xi(lf.add(_f6(n, 1), _f6(n, 2)))))
    return _f2_mul(c, t.unsqueeze(-3))


def _f12(a, i):
    return a[..., i, :, :, :]


def _f12_mul(a, b):
    lf = _lf()
    a, b = torch.broadcast_tensors(a, b)
    s = lf.add(_st([_f12(a, 0), _f12(b, 0)], 1), _st([_f12(a, 1), _f12(b, 1)], 1))
    t = _f6_mul(_st([_f12(a, 0), _f12(a, 1), s[:, 0]], -4), _st([_f12(b, 0), _f12(b, 1), s[:, 1]], -4))
    t0, t1, t2 = _f12(t, 0), _f12(t, 1), _f12(t, 2)
    x = lf.add(_st([t0, t0], -4), _st([_f6_nr(t1), t1], -4))
    return _st([_f12(x, 0), lf.sub(t2, _f12(x, 1))], -4)


def _f12_sqr(a):
    lf = _lf()
    a0, a1 = _f12(a, 0), _f12(a, 1)
    s = lf.add(_st([a0, a0], -4), _st([a1, _f6_nr(a1)], -4))
    m = _f6_mul(_st([a0, _f12(s, 0)], -4), _st([a1, _f12(s, 1)], -4))
    t = _f12(m, 0)
    y = lf.add(_st([t, t], -4), _st([_f6_nr(t), t], -4))
    return _st([lf.sub(_f12(m, 1), _f12(y, 0)), _f12(y, 1)], -4)


def _f12_conj(a):
    return _st([_f12(a, 0), _lf().neg(_f12(a, 1))], -4)


def _f12_inv(a):
    lf = _lf()
    sq = _f6_mul(a, a)
    t = _f6_inv(lf.sub(_f12(sq, 0), _f6_nr(_f12(sq, 1))))
    m = _f6_mul(a, t.unsqueeze(-4))
    return _st([_f12(m, 0), lf.neg(_f12(m, 1))], -4)


@functools.lru_cache(maxsize=None)
def _frob_coeffs(k: int, device) -> torch.Tensor:
    """(18, 2, 3, 2, 1): the Fq2 factor of each coordinate under the k-th
    Frobenius - [1, C1, C2][j], times W for the w coordinate (the product
    of the two constants, so one Fq2 product a coordinate)."""
    p = FQ_PARAMS.modulus
    coeff = [ht.FQ2_ONE, ht._FROB_C1[k], ht._FROB_C2[k]]
    vals = [[coeff[j] if i == 0 else ht.fq2_mul(coeff[j], ht._FROB_W[k]) for j in range(3)] for i in range(2)]
    rows = [v * R_INTERNAL % p for i in range(2) for j in range(3) for v in vals[i][j]]
    from ..fields.limbs import ints_to_limbs

    limbs = torch.from_numpy(ints_to_limbs(rows).astype(np.int32))  # (18, 12)
    return limbs.reshape(L, 2, 3, 2, 1).to(device)


def _f12_frob(a, k: int):
    if k % 2:
        a = _st([a[..., 0, :], _lf().neg(a[..., 1, :])], -2)
    return _f2_mul(a, _frob_coeffs(k, a.device))


def _f12_csq(a):
    """Granger-Scott (the host tower's formula), its Fq2 squarings and sums
    stacked."""
    lf = _lf()
    x = a.flatten(-4, -3)  # (18, ..., 6, 2, B): x0 .. x5
    xs = [_f6(x, j) for j in range(6)]
    s = lf.add(_st([xs[4], xs[2], xs[5]], -3), _st([xs[0], xs[3], xs[1]], -3))
    q = _f2_sqr(_st([xs[4], xs[0], _f6(s, 0), xs[2], xs[3], _f6(s, 1), xs[5], xs[1], _f6(s, 2)], -3))
    t = [_f6(q, j) for j in range(9)]  # t0 t1 q40 t2 t3 q23 t4 t5 q51
    u = lf.sub(_st([t[2], t[5], t[8]], -3), lf.add(_st([t[0], t[3], t[6]], -3), _st([t[1], t[4], t[7]], -3)))
    xi = _f2_mul_xi(_st([_f6(u, 2), t[0], t[3], t[6]], -3))  # t8, xi t0, xi t2, xi t4
    tt = lf.add(xi[..., 1:, :, :], _st([t[1], t[4], t[7]], -3))  # t0', t2', t4'
    big = _st([_f6(tt, 0), _f6(tt, 1), _f6(tt, 2), _f6(xi, 0), _f6(u, 0), _f6(u, 1)], -3)
    d = torch.cat([lf.sub(big[..., :3, :, :], x[..., :3, :, :]), lf.add(big[..., 3:, :, :], x[..., 3:, :, :])], -3)
    z = lf.add(lf.add(d, d), big)
    return z.unflatten(-3, (2, 3))


def _f12_expz(a):
    r = a
    for i in range(ht.BN_Z.bit_length() - 2, -1, -1):
        r = _f12_csq(r)
        if (ht.BN_Z >> i) & 1:
            r = _f12_mul(r, a)
    return _f12_conj(r)


def _limb_first(t):
    """(2, 3, 2, 18, *batch) -> (18, *batch..., 2, 3, 2) order the plain ops
    use: (18, 2, 3, 2, *batch)."""
    return t.movedim(3, 0)


def _package_order(t):
    return t.movedim(0, 3)


def _line_elements(lines, q_idx, px, py):
    """Per lane the dense Fq12 element of each line, (18, L, 2, 3, 2, B):
    c0 = (o, 0, vv P.x), c1 = (0, vw P.y, 0)."""
    lf = _lf()
    ll = lines.index_select(0, q_idx.long()).permute(4, 1, 2, 3, 0)  # (18, L, 3, 2, B)
    pyx = _st([py, px], 1).unsqueeze(1).unsqueeze(3)  # (18, 1, 2, 1, B)
    scaled = lf.mont_mul(ll[:, :, 1:3], pyx)  # vw P.y, vv P.x
    n, b = ll.shape[1], ll.shape[-1]
    out = torch.zeros((L, n, 2, 3, 2, b), dtype=torch.int32, device=ll.device)
    out[:, :, 0, 0] = ll[:, :, 0]
    out[:, :, 0, 2] = scaled[:, :, 1]
    out[:, :, 1, 1] = scaled[:, :, 0]
    return out


def plain_miller_loop(lines, q_idx, px, py, i1, i2):
    """The plain PyTorch version of K5a (any device): the JAX package's
    _miller_jit over the per-lane line elements; the identity line leaves f
    as it is, so a zero digit's second product is skipped."""
    elems = _line_elements(lines, q_idx, px, py)
    n_lines = elems.shape[1]
    f = torch.zeros((L, 2, 3, 2, px.shape[1]), dtype=torch.int32, device=px.device)
    f[:, 0, 0, 0] = _const_col(1, 2, px.device)
    for s1, s2 in zip(i1, i2):
        f = _f12_mul(_f12_sqr(f), elems[:, s1])
        if s2 != n_lines:
            f = _f12_mul(f, elems[:, s2])
    for li in (n_lines - 2, n_lines - 1):
        f = _f12_mul(f, elems[:, li])
    return _package_order(f)


def plain_final_exp(f, group_size: int):
    """The plain PyTorch version of K5b (any device): each group's product
    of its g lanes' Miller values, then the easy part and the
    Fuentes-Castaneda chain (the JAX package's _PROGRAM, step for step)."""
    x = _limb_first(f)
    lanes = x.shape[-1]
    x = x.reshape(x.shape[:-1] + (lanes // group_size, group_size))
    acc = x[..., 0]
    for j in range(1, group_size):
        acc = _f12_mul(acc, x[..., j])
    t = _f12_mul(_f12_conj(acc), _f12_inv(acc))  # f^(p^6 - 1)
    elt = _f12_mul(t, _f12_frob(t, 2))  # the easy part
    b = _f12_csq(_f12_expz(elt))  # B = A^2, A = elt^-z
    d = _f12_mul(_f12_csq(b), b)  # D = C B, C = B^2
    e = _f12_expz(d)
    g = _f12_expz(_f12_csq(e))  # G = F^-z, F = E^2
    k = _f12_mul(_f12_conj(d), _f12_mul(_f12_conj(g), e))  # K = H J, J = I E
    l_ = _f12_mul(b, k)
    n = _f12_mul(_f12_mul(e, k), elt)  # N = M elt, M = E K
    r = _f12_mul(_f12_mul(_f12_frob(l_, 1), n), _f12_frob(k, 2))  # R = P Q, P = O N
    u = _f12_frob(_f12_mul(l_, _f12_conj(elt)), 3)  # U = T^(p^3), T = L S
    return _package_order(_f12_mul(r, u))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _check(t, shape, what: str):
    if t.dtype != torch.int32 or not t.is_cuda or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous int32 CUDA tensor of shape {tuple(shape)}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _launch_miller(lines, q_idx, px, py, i1, i2):
    nq, n_lines = lines.shape[0], lines.shape[1]
    n = px.shape[1]
    _check(lines, (nq, n_lines, 3, 2, L), "the line table")
    _check(q_idx, (n,), "q_idx")
    _check(px, (L, n), "px")
    _check(py, (L, n), "py")
    if len(i1) != len(i2) or len(i1) > MILLER_MAX_STEPS:
        raise ValueError(f"miller_loop takes at most {MILLER_MAX_STEPS} steps")
    out = px.new_empty((2, 3, 2, L, n))
    scratch = px.new_empty((2 * 3 * 2 * 9 * n,))
    w1 = np.asarray(i1, dtype=np.int16)
    w2 = np.asarray(i2, dtype=np.int16)
    with build.on_device(px):
        err = build.get_lib("pairing").bb_miller_loop(
            lines.data_ptr(), n_lines, q_idx.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, len(i1), w1.ctypes.data, w2.ctypes.data, build.field_consts(FQ_PARAMS),
            build.tower_consts(), build.stream_of(px),
        )
    build.check(err, "miller_loop")
    launch_counts["miller_loop"] += 1
    return out


def _launch_final_exp(f, group_size: int):
    lanes = f.shape[-1]
    _check(f, (2, 3, 2, L, lanes), "f")
    if group_size < 1 or lanes % group_size:
        raise ValueError(f"{lanes} lanes do not split into groups of {group_size}")
    groups = lanes // group_size
    out = f.new_empty((2, 3, 2, L, groups))
    scratch = f.new_empty((FINAL_EXP_SLOTS * 2 * 3 * 2 * 9 * groups,))
    with build.on_device(f):
        err = build.get_lib("pairing").bb_final_exp(
            f.data_ptr(), out.data_ptr(), scratch.data_ptr(), groups, group_size, build.field_consts(FQ_PARAMS),
            build.tower_consts(), build.stream_of(f),
        )
    build.check(err, "final_exp")
    launch_counts["final_exp"] += 1
    return out


def miller_loop(lines, q_idx, px, py, i1, i2):
    """The Miller loop of B lanes, f as (2, 3, 2, 18, B): lane l pairs the
    point (px[:, l], py[:, l]) (internal Montgomery Fq, (18, B)) with the
    G2 point whose lines are ``lines[q_idx[l]]`` (the table (nq, L, 3, 2,
    18) of the host's (o, vw, vv) rows, unscaled); i1 / i2 from
    ``miller_steps(L)``."""
    if px.is_cuda:
        return _launch_miller(lines, q_idx, px, py, i1, i2)
    return plain_miller_loop(lines, q_idx, px, py, i1, i2)


def final_exp(f, group_size: int = 1):
    """(2, 3, 2, 18, B) Miller values -> the final exponentiation of each
    group's product, (2, 3, 2, 18, B / g), groups of g consecutive lanes."""
    if f.is_cuda:
        return _launch_final_exp(f, group_size)
    return plain_final_exp(f, group_size)
