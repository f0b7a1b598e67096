"""K4 ``glv_digits``: the GLV split and signed digits of an MSM's scalars.

Its plain version (``kernels/msm_kernels.py::plain_glv_digits``, the eager
``split_scalars`` + ``signed_digits`` chain) is held, with tolerance 0,
against the JAX package's ``split_scalars`` + ``signed_digits`` at the shape
``tests/test_torch_msm.py`` compiles (N = 64) and against the host oracle
``fields/glv.py::split_into_endomorphism_scalars`` on edge scalars; its
(sets, m) layout against separate calls and the JAX [d1 | d2] per round; and
a Python-integer model of the CUDA kernel's own schedule
(``csrc/msm_kernels.cu::glv_digits_kernel``: 30-bit limbs, limb products
sized by the kernel's compile-time widths, 64-bit column sums, the quotient
by 2^270 as the product's limbs from the ninth on, the digits shifted out of
two 64-bit words) against the host oracle, with every column checked below
2^64 and every limb the kernel skips checked to be zero.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fr as jfr
from barretenberg_tpu.msm import signed_digits as j_signed_digits
from barretenberg_tpu.msm import split_scalars as j_split_scalars

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fr as tfr
from barretenberg_tpu_torch.fields.glv import split_into_endomorphism_scalars
from barretenberg_tpu_torch.fields.limbs import ints_to_limbs
from barretenberg_tpu_torch.fields.params import FR_CUBE_ROOT, FR_MODULUS, R_INTERNAL
from barretenberg_tpu_torch.groups import AffinePoints
from barretenberg_tpu_torch.kernels import build, msm_kernels
from barretenberg_tpu_torch.msm import signed_digits
from barretenberg_tpu_torch.msm.pippenger import glv_entries, precomputed_digits
from chip_smoke import glv_edge_scalars, host_glv_digits, host_signed_digits

torch.set_num_threads(1)

N = 64  # the scalar count tests/test_torch_msm.py runs the JAX split at
P = FR_MODULUS
WINDOWS = (8, 10, 13)  # c at 2^11, 2^16 and 2^20 points
LIMBS, BITS = 9, 30
MASK30 = (1 << BITS) - 1
WORD = 1 << 64


def edge_scalars() -> list:
    """The smoke's edge scalars (0, 1, r-1, lambda and its neighbours, k1 or
    k2 all ones, k1 = 2^126) and the scalars with the largest k1 and the
    largest k2 of a seeded sample."""
    rng = np.random.default_rng(71)
    sample = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(2048)]
    splits = [split_into_endomorphism_scalars(k) for k in sample]
    widest = [sample[max(range(len(sample)), key=lambda i: splits[i][h])] for h in (0, 1)]
    return glv_edge_scalars(9, rng) + widest


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(36)
    scalars = [0, 1, P - 1, 2] + [int.from_bytes(rng.bytes(32), "little") % P for _ in range(N - 4)]
    jscal = jfr.encode(scalars)
    jk1, jk2 = j_split_scalars(jscal)
    return scalars, jk1, jk2, convert.field_tensor(jscal, "cpu")


@pytest.mark.parametrize("c", WINDOWS)
def test_glv_digits_match_jax_split_and_signed_digits(data, c):
    _, jk1, jk2, tscal = data
    want = np.concatenate([np.asarray(j_signed_digits(jk1, c)), np.asarray(j_signed_digits(jk2, c))], axis=1)
    rounds = msm_kernels.digit_rounds(c)
    assert want.shape == (rounds, 2 * N)
    got = msm_kernels.glv_digits(tscal, 1, c, rounds * 2 * N)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy()[0], want.reshape(-1))
    # glv_entries reads the same words as (rounds, 2N): [d1 | d2] per round
    assert np.array_equal(got.numpy().reshape(rounds, 2 * N), want)


@pytest.mark.parametrize("c", WINDOWS)
def test_glv_digits_match_host_oracle_on_edge_scalars(c):
    scalars = edge_scalars()
    n = len(scalars)
    got = msm_kernels.glv_digits(tfr("cpu").encode(scalars), 1, c, msm_kernels.digit_rounds(c) * 2 * n)
    assert got[0].tolist() == host_glv_digits(scalars, c)


@pytest.mark.parametrize("sets", [1, 3])
def test_glv_digits_layout_of_several_sets(sets):
    c, n = 10, 16
    rng = np.random.default_rng(5 + sets)
    fr = tfr("cpu")
    vecs = [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)] for _ in range(sets)]
    used = msm_kernels.digit_rounds(c) * 2 * n
    m = used + 37  # zeros beyond the rounds
    got = msm_kernels.glv_digits(torch.cat([fr.encode(v) for v in vecs], dim=1), sets, c, m)
    assert tuple(got.shape) == (sets, m)
    assert not got[:, used:].any()
    for b, v in enumerate(vecs):
        assert torch.equal(got[b], msm_kernels.glv_digits(fr.encode(v), 1, c, m)[0])
        assert got[b, :used].tolist() == host_glv_digits(v, c)
    assert torch.equal(precomputed_digits([fr.encode(v) for v in vecs], c, m), got)


def test_glv_entries_take_their_digits_from_glv_digits():
    c, n, block = 8, 24, 32  # 2n = 48 entries padded to 64 per round
    rng = np.random.default_rng(9)
    scalars = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    zero = torch.zeros((18, n), dtype=torch.int32)
    pts = AffinePoints(zero, zero, torch.ones(n, dtype=torch.bool))
    digits, px, _, pinf = glv_entries(tfr("cpu").encode(scalars), pts, c, block)
    rounds = msm_kernels.digit_rounds(c)
    assert tuple(digits.shape) == (rounds, 64) and tuple(px.shape) == (18, 64) and bool(pinf.all())
    assert digits[:, :2 * n].reshape(-1).tolist() == host_glv_digits(scalars, c)
    assert not digits[:, 2 * n:].any()


@pytest.mark.parametrize("c", WINDOWS)
def test_signed_digits_recode_the_widest_halves(c):
    """The recoding on halves the split never returns (its halves are < 2^127)
    but a window may carry through: 2^128 - 1 (every window carries), 2^127,
    2^127 - 1, alternating bits."""
    halves = [(1 << 128) - 1, 1 << 127, (1 << 127) - 1, int("10" * 64, 2), int("01" * 64, 2)]
    got = signed_digits(torch.from_numpy(ints_to_limbs(halves).astype(np.int32)), c)
    for j, h in enumerate(halves):
        col = got[:, j].tolist()
        assert col == host_signed_digits(h, c) == k4_digits_model(limbs30(h), c)
        assert sum(d << (r * c) for r, d in enumerate(col)) == h


# ---------------------------------------------------------------------------
# the CUDA kernel's schedule in Python integers
# ---------------------------------------------------------------------------
def limbs30(v: int) -> list:
    return [(v >> (BITS * k)) & MASK30 for k in range(LIMBS)]


def value(limbs: list) -> int:
    return sum(v << (BITS * k) for k, v in enumerate(limbs))


def kernel_consts() -> list:
    """The 45 GlvConst words the wrapper passes to the kernel."""
    return list((ctypes.c_uint32 * (5 * LIMBS)).from_address(build.glv_consts()))


def kernel_widths() -> dict:
    """The limb counts csrc/msm_kernels.cu compiles K4's products with."""
    with open(os.path.join(build.CSRC_DIR, "msm_kernels.cu")) as fh:
        return {k: int(v) for k, v in re.findall(r"^#define (\w+_LIMBS) (\d+)$", fh.read(), re.MULTILINE)}


def mul_limbs_model(a: list, b: list, nout: int):
    """msm_kernels.cu's mul_limbs: the low ``nout`` carry-propagated 30-bit
    limbs of a * b over the limbs given (len(a) and len(b) are the kernel's
    NA and NB), and the largest 64-bit column sum (carry in included)."""
    out, carry, top = [], 0, 0
    for k in range(nout):
        col = carry + sum(a[i] * b[k - i] for i in range(max(0, k - len(b) + 1), min(k, len(a) - 1) + 1))
        top = max(top, col)
        out.append(col & MASK30)
        carry = col >> BITS
    return out, top


def k4_digits_model(h: list, c: int) -> list:
    """store_signed_digits: the half's low 128 bits in two 64-bit words, each
    window taken from the low word, then both words shifted right by c."""
    lo = (h[0] | (h[1] << 30) | (h[2] << 60)) % WORD
    hi = ((h[2] >> 4) | (h[3] << 26) | ((h[4] & 0xFF) << 56)) % WORD
    out, carry = [], 0
    for _ in range(-(-128 // c)):
        v = (lo & ((1 << c) - 1)) + carry
        carry = int(v >= 1 << (c - 1))
        out.append(v - (carry << c))
        lo = ((lo >> c) | (hi << (64 - c))) % WORD
        hi >>= c
    return out + [carry]


def k4_model(k_mont: int, c: int):
    """glv_digits_kernel for one scalar: (digits of k1, digits of k2, the
    largest column sum of its four limb products). Checks on the way that
    the limbs each product skips are zero: the constants' limbs above their
    widths, and the quotients' limbs above C1_LIMBS and C2_LIMBS."""
    w = kernel_widths()
    g2, g1, mb1, b2, lam = (kernel_consts()[LIMBS * i:LIMBS * (i + 1)] for i in range(5))
    for const, width in ((g2, w["G2_LIMBS"]), (g1, w["G1_LIMBS"]), (mb1, w["B1_LIMBS"]), (b2, w["B2_LIMBS"])):
        assert not any(const[width:])
    r_inv = pow(R_INTERNAL, -1, P)
    k = k_mont * r_inv % P  # fe_mul by 1
    c1, c2, tops = [], [], []
    for g, gw, cw in ((g2, w["G2_LIMBS"], w["C1_LIMBS"]), (g1, w["G1_LIMBS"], w["C2_LIMBS"])):
        prod, top = mul_limbs_model(limbs30(k), g[:gw], LIMBS + cw)
        assert value(prod) == k * value(g)  # nothing above the kept limbs
        (c1 if g is g2 else c2).extend(prod[LIMBS:])
        tops.append(top)
    q1, t3_ = mul_limbs_model(c1, mb1[:w["B1_LIMBS"]], w["C1_LIMBS"] + w["B1_LIMBS"])
    q2, t4_ = mul_limbs_model(c2, b2[:w["B2_LIMBS"]], w["C2_LIMBS"] + w["B2_LIMBS"])
    assert len(q1) <= LIMBS and len(q2) <= LIMBS  # they fill the low limbs of an fe
    assert value(q1) == value(c1) * value(mb1) and value(q2) == value(c2) * value(b2)
    assert max(value(q1), value(q2)) < 1 << 224  # canonical operands of fe_sub
    t1 = (value(q2) - value(q1)) % P  # fe_sub
    t2 = (t1 * value(lam) * r_inv + k) % P  # fe_mul by lambda's Montgomery form, fe_add
    return k4_digits_model(limbs30(t2), c), k4_digits_model(limbs30(t1), c), max(tops + [t3_, t4_])


def test_k4_schedule_columns_stay_below_2_64():
    """Every limb product of the kernel at its widest operands: k < r (top limb
    < 2^14) against g2 and g1, and every limb of each quotient at 2^30 - 1
    against -b1 and b2; the constants fit the widths the kernel compiles in."""
    w = kernel_widths()
    g2, g1, mb1, b2, _ = (kernel_consts()[LIMBS * i:LIMBS * (i + 1)] for i in range(5))
    widest_k = limbs30(P - 1)
    widest_k[:-1] = [MASK30] * (LIMBS - 1)
    tops = [mul_limbs_model(widest_k, g[:gw], LIMBS + cw)[1]
            for g, gw, cw in ((g2, w["G2_LIMBS"], w["C1_LIMBS"]), (g1, w["G1_LIMBS"], w["C2_LIMBS"]))]
    tops += [mul_limbs_model([MASK30] * cw, g[:gw], cw + gw)[1]
             for g, gw, cw in ((mb1, w["B1_LIMBS"], w["C1_LIMBS"]), (b2, w["B2_LIMBS"], w["C2_LIMBS"]))]
    assert max(tops) < 2**63.2 < WORD
    for const, width in ((g2, w["G2_LIMBS"]), (g1, w["G1_LIMBS"]), (mb1, w["B1_LIMBS"]), (b2, w["B2_LIMBS"])):
        assert not any(const[width:])
    # the quotients' widths hold for every k < 2^254: c1 < 2^(254 + 30 G2 - 270)
    assert 254 + BITS * w["G2_LIMBS"] - 270 <= BITS * w["C1_LIMBS"]
    assert 254 + BITS * w["G1_LIMBS"] - 270 <= BITS * w["C2_LIMBS"]
    # the constants are the documented ones
    assert value(g2) == ((0x2 << 64) | 0xD91D232EC7E0B3D7) << 14
    assert value(mb1) == (0x6F4D8248EEB859FC << 64) | 0x8211BBEB7D4F1128
    assert value(kernel_consts()[4 * LIMBS:]) == FR_CUBE_ROOT * R_INTERNAL % P


@pytest.mark.parametrize("c", WINDOWS)
def test_k4_schedule_is_the_host_split(c):
    rng = np.random.default_rng(13)
    scalars = edge_scalars() + [int.from_bytes(rng.bytes(32), "little") % P for _ in range(48)]
    for k in scalars:
        k1, k2 = split_into_endomorphism_scalars(k)
        d1, d2, top = k4_model(k * R_INTERNAL % P, c)
        assert d1 == host_signed_digits(k1, c) and d2 == host_signed_digits(k2, c)
        assert top < WORD


def test_glv_digits_rejects_what_the_kernel_does_not_take():
    scalars = tfr("cpu").encode(list(range(6)))
    with pytest.raises(ValueError):
        msm_kernels.glv_digits(scalars, 4, 10, 1000)  # 6 scalars in 4 sets
    with pytest.raises(ValueError):
        msm_kernels.glv_digits(scalars, 1, 10, msm_kernels.digit_rounds(10) * 12 - 1)  # m too small
    with pytest.raises(ValueError):
        msm_kernels.glv_digits(scalars, 1, 31, 1000)
