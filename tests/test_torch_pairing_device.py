"""The port's device pairing (barretenberg_tpu_torch/pairing/device.py and
the plain versions of K5a miller_loop / K5b final_exp in
kernels/pairing_kernels.py) against the JAX package, exact, on the CPU.

The JAX device pairing takes minutes of cold XLA compile on a CPU, so the
fast cases hold the port against the JAX package's host tower
(barretenberg_tpu/pairing/tower.py: miller_loop_precomputed,
final_exponentiation, reduced_ate_pairing_batch) and its line preparation
(``_prepare_lines``, host Python and encoding); the comparisons with the
JAX device pairing itself are marked slow. Inputs are points [k]G1 / [k]G2
of scalars drawn with numpy from fixed seeds."""

import pathlib
import re

import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fr as jax_fr
from barretenberg_tpu.pairing import device as jax_dp, tower as jax_ht
from barretenberg_tpu_torch.fields import fr
from barretenberg_tpu_torch.fields.params import FR_MODULUS, R_INTERNAL
from barretenberg_tpu_torch.groups.g1 import host_to_affine_points
from barretenberg_tpu_torch.kernels import build, pairing_kernels as pk
from barretenberg_tpu_torch.pairing import device as dp, tower as ht
from barretenberg_tpu_torch.srs import ReferenceString, test_srs
from barretenberg_tpu_torch.utils import host_curve as hc

torch.set_num_threads(1)

CSRC = pathlib.Path(pk.__file__).resolve().parent.parent / "csrc"
F12 = dp.fq12("cpu")


def scalars(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS or 1 for _ in range(n)]


def g1_points(n, seed):
    return [hc.g1_mul(hc.G1_GENERATOR, k) for k in scalars(n, seed)]


def limb_first(values):
    return pk._limb_first(F12.encode(values))


def decode(t):
    return F12.decode(pk._package_order(t))


def rand_fq12(rng):
    return tuple(tuple(tuple(int.from_bytes(rng.bytes(32), "little") % ht.P for _ in range(2)) for _ in range(3))
                 for _ in range(2))


# ---------------------------------------------------------------------------
# the plain tower of the kernels' plain versions, and the kernels' constants
# ---------------------------------------------------------------------------
def test_plain_tower_equals_host_tower():
    rng = np.random.default_rng(31)
    a = [rand_fq12(rng) for _ in range(3)]
    b = [rand_fq12(rng) for _ in range(3)]
    ta, tb = limb_first(a), limb_first(b)
    assert decode(pk._f12_mul(ta, tb)) == [jax_ht.fq12_mul(x, y) for x, y in zip(a, b)]
    assert decode(pk._f12_sqr(ta)) == [jax_ht.fq12_sqr(x) for x in a]
    assert decode(pk._f12_conj(ta)) == [jax_ht.fq12_conj(x) for x in a]
    assert decode(pk._f12_inv(ta)) == [jax_ht.fq12_inv(x) for x in a]
    for k in (1, 2, 3):
        assert decode(pk._f12_frob(ta, k)) == [jax_ht.fq12_frobenius(x, k) for x in a]
    cyc = []
    for x in a:
        e = jax_ht.fq12_mul(jax_ht.fq12_conj(x), jax_ht.fq12_inv(x))
        cyc.append(jax_ht.fq12_mul(e, jax_ht.fq12_frobenius(e, 2)))
    assert decode(pk._f12_csq(limb_first(cyc))) == [jax_ht.fq12_cyclotomic_sqr(x) for x in cyc]
    assert decode(pk._f12_expz(limb_first(cyc[:1]))) == [jax_ht._exp_by_neg_z(cyc[0])]


def _define(source: str, name: str) -> int:
    return int(re.search(rf"#define {name} \(?(\d+)", (CSRC / source).read_text()).group(1))


def test_kernel_constants_equal_the_sources_and_jax():
    assert list(pk.NAF) == list(jax_dp._NAF) == list(jax_ht._ATE_NAF)
    assert pk.MILLER_MAX_STEPS == _define("pairing.cu", "MILLER_MAX_STEPS") >= len(pk.NAF)
    assert pk.FINAL_EXP_SLOTS == _define("pairing.cu", "FE_EXP_SLOTS")
    assert "pairing" in build.SOURCES
    # the TowerConst words: Frobenius coefficients in internal form, p - 2, z
    build.tower_consts()
    words = [int(w) for w in build._const_cache["tower"][0]]
    assert len(words) == 3 * 3 * 2 * 9 + 8 + 4
    p = ht.P

    def value(ws):
        return sum(w << (30 * i) for i, w in enumerate(ws))

    for k in (1, 2, 3):
        for c, host in enumerate((jax_ht._FROB_C1[k], jax_ht._FROB_C2[k], jax_ht._FROB_W[k])):
            base = ((k - 1) * 3 + c) * 18
            got = tuple(value(words[base + 9 * h : base + 9 * h + 9]) * pow(R_INTERNAL, -1, p) % p for h in (0, 1))
            assert got == host
    assert sum(w << (32 * i) for i, w in enumerate(words[162:170])) == p - 2 and words[170] == (p - 2).bit_length()
    assert words[171] | (words[172] << 32) == ht.BN_Z and words[173] == ht.BN_Z.bit_length()
    # products a lane (K5a) and a group (K5b): as the kernels run them, and
    # as the functions need them (the smoke's bounds): no product by an
    # identity line, none by one, exp-by-neg-z's only at z's 27 set bits
    assert pk.MILLER_LINES == len(ht.precompute_miller_lines(hc.G2_GENERATOR)) == 88
    assert pk.MILLER_CHAIN_PRODUCTS == 65 * (36 + 92) + 92
    assert pk.MILLER_PRODUCTS == 64 * 36 + 87 * 46 + 4
    assert pk.FINAL_EXP_CHAIN_PRODUCTS == 12 * 54 + 3 * 18 + 4 * 21 + 471 + 3 * 62 * 72
    assert pk.FINAL_EXP_PRODUCTS == 12 * 54 + 3 * 18 + 4 * 21 + 471 + 3 * (62 * 18 + 27 * 54)


def test_final_exp_kernel_chain_equals_jax_program():
    """K5b's straight-line chain, read from csrc/pairing.cu and run on the
    JAX package's host tower, gives the JAX package's register program
    (pairing/device.py _PROGRAM) and final_exponentiation on each value."""
    src = (CSRC / "pairing.cu").read_text()
    start = src.index("// the easy part: elt")
    body = src[start:src.index("fe_store(out", start)]
    result = re.search(r"fe_store\(out[^;]*ld_fe\((s\d), e\)\);", src[start:]).group(1)
    calls = re.findall(r"f12_(\w+)\((s\d), (s\d)(?:, (s\d|\d))?\);", body)
    assert len(calls) == 27
    ops = {"mul": lambda a, b: jax_ht.fq12_mul(a, b), "csq": lambda a, b: jax_ht.fq12_cyclotomic_sqr(a),
           "conj": lambda a, b: jax_ht.fq12_conj(a), "inv": lambda a, b: jax_ht.fq12_inv(a),
           "expz": lambda a, b: jax_ht._exp_by_neg_z(a), "frob": lambda a, b: jax_ht.fq12_frobenius(a, int(b))}
    jax_ops = {jax_dp._MUL: ops["mul"], jax_dp._CSQ: ops["csq"], jax_dp._CONJ: ops["conj"],
               jax_dp._INV: ops["inv"], jax_dp._EXPZ: ops["expz"],
               jax_dp._FROB1: lambda a, b: ops["frob"](a, 1), jax_dp._FROB2: lambda a, b: ops["frob"](a, 2),
               jax_dp._FROB3: lambda a, b: ops["frob"](a, 3)}
    rng = np.random.default_rng(37)
    for _ in range(2):
        f = rand_fq12(rng)
        slots = {"s0": f}
        for op, dst, a, b in calls:
            slots[dst] = ops[op](slots[a], slots.get(b, b))
        regs = [f] + [None] * (jax_dp._NREGS - 1)
        for op, a, b, d in jax_dp._PROGRAM:
            regs[d] = jax_ops[op](regs[a], regs[b])
        assert slots[result] == regs[jax_dp._RESULT_REG] == jax_ht.final_exponentiation(f)


# ---------------------------------------------------------------------------
# line preparation, K5a and K5b's plain versions
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def groups():
    """Two groups of two lanes: P against the G2 generator with -P, and P'
    against [tau]G2 beside P'' against a random [k]G2."""
    p = g1_points(3, 41)
    q = [hc.G2_GENERATOR] + [hc.g2_mul(hc.G2_GENERATOR, k) for k in scalars(2, 42)]
    return [[(p[0], q[0]), (hc.g1_neg(p[0]), q[0])], [(p[1], q[1]), (p[2], q[2])]]


def test_prepare_lines_equal_jax(groups):
    (table, q_idx, px, py), (i1, i2), layout = dp._prepare_lines(groups, "cpu")
    (jo, jvw, jvv), (ji1, ji2), jlayout = jax_dp._prepare_lines(groups)
    assert layout == jlayout == (2, 2)
    assert (i1, i2) == (ji1.tolist(), ji2.tolist())
    assert table.shape == (3, 88, 3, 2, 18) and q_idx.tolist() == [0, 0, 1, 2]
    for got, want in zip(dp.expand_lines(table, q_idx, px, py), (jo, jvw, jvv)):
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def test_plain_miller_loop_equals_jax_host(groups):
    (table, q_idx, px, py), (i1, i2), _ = dp._prepare_lines(groups, "cpu")
    f = pk.miller_loop(table, q_idx, px, py, i1, i2)
    assert f.shape == (2, 3, 2, 18, 4)
    flat = [pair for grp in groups for pair in grp]
    want = [jax_ht.miller_loop_precomputed([p], [jax_ht.precompute_miller_lines(q)]) for p, q in flat]
    assert F12.decode(f) == want
    # a lane whose lines are all the identity row keeps f = 1
    ident = [((1, 0), (0, 0), (0, 0))] * 88
    (t2, qi2, px2, py2), _, _ = dp._prepare_lines([[(flat[0][0], None, ident)]], "cpu")
    assert F12.decode(pk.miller_loop(t2, qi2, px2, py2, i1, i2)) == [ht.FQ12_ONE]
    assert pk.launch_counts == {"miller_loop": 0, "final_exp": 0}  # plain versions launch nothing


def test_plain_final_exp_equals_jax_host(groups):
    (table, q_idx, px, py), (i1, i2), _ = dp._prepare_lines(groups, "cpu")
    f = pk.miller_loop(table, q_idx, px, py, i1, i2)
    fs = F12.decode(f)
    singles = F12.decode(pk.final_exp(f[..., :2].contiguous(), 1))
    assert singles == [jax_ht.final_exponentiation(x) for x in fs[:2]]
    pairs = F12.decode(pk.final_exp(f, 2))
    assert pairs[0] == ht.FQ12_ONE  # e(P, Q) e(-P, Q)
    assert pairs[1] == jax_ht.final_exponentiation(jax_ht.fq12_mul(fs[2], fs[3]))


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
def test_reduced_ate_pairing_known_answer():
    p = hc.g1_mul(hc.G1_GENERATOR, 7)
    q = hc.g2_mul(hc.G2_GENERATOR, 11)
    assert dp.reduced_ate_pairing(p, q, "cpu") == jax_ht.reduced_ate_pairing_batch([(p, q)])


def test_bilinearity_groups():
    a, b = 6, 13
    pa = hc.g1_mul(hc.G1_GENERATOR, a)
    qb = hc.g2_mul(hc.G2_GENERATOR, b)
    pab = hc.g1_mul(hc.G1_GENERATOR, a * b)
    groups = [
        [(pa, qb), (hc.g1_neg(pab), hc.G2_GENERATOR)],
        [(pa, qb), (pab, hc.G2_GENERATOR)],
    ]
    assert dp.pairing_check_groups(groups, "cpu") == [True, False]


@pytest.mark.parametrize("n", [8, 1000])
def test_rlc_scalars_equal_jax(n):
    """validate_srs_rlc's r: the JAX package's values, and the generator
    left in the same state (the port draws the bytes in one call)."""
    rng_t, rng_j = np.random.default_rng(0xC0FFEE), np.random.default_rng(0xC0FFEE)
    got = fr("cpu").random_elements(n, rng_t)
    want = jax_fr.random_elements(n, rng_j)
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    assert rng_t.bytes(40) == rng_j.bytes(40)


def corrupted(srs, index, off_curve=False):
    pts = srs.monomials_host()
    x, y = hc.g1_mul(hc.G1_GENERATOR, 999)
    pts[index] = (x, y + 1 if off_curve else y)
    return ReferenceString(host_to_affine_points(pts, "cpu"), srs.g2_x, srs.degree)


def test_srs_checks_at_degree_8():
    srs = test_srs(8, device="cpu")
    assert dp.srs_on_curve_all(srs)
    assert dp.validate_srs_device(srs)
    assert dp.validate_srs_rlc(srs)
    bad = corrupted(srs, 3)
    assert dp.srs_on_curve_all(bad)  # [999]G is on the curve ...
    assert not dp.validate_srs_device(bad)  # ... but not tau-consistent
    assert not dp.validate_srs_rlc(bad)
    assert dp.validate_srs_device(bad, [0, 4, 5])  # indices that do not touch monomial 3
    assert not dp.srs_on_curve_all(corrupted(srs, 3, off_curve=True))


# ---------------------------------------------------------------------------
# against the JAX device pairing itself
# ---------------------------------------------------------------------------
@pytest.mark.slow  # the JAX device pairing: minutes of cold XLA compile on a CPU
def test_pairing_groups_equal_jax_device(groups):
    assert dp.reduced_ate_pairing_groups(groups, "cpu") == jax_dp.reduced_ate_pairing_groups(groups)


@pytest.mark.slow  # the JAX device pairing: minutes of cold XLA compile on a CPU
def test_srs_checks_equal_jax_device():
    """Two sampled indices: 2 groups of 2 lanes, the shapes the test above
    compiles (each new lane count is another cold compile of the JAX
    Miller loop)."""
    from barretenberg_tpu.srs import test_srs as jax_test_srs

    srs = test_srs(8, device="cpu")
    jsrs = jax_test_srs(8)
    assert dp.srs_on_curve_all(srs) == jax_dp.srs_on_curve_all(jsrs) is True
    assert dp.validate_srs_device(srs, [0, 5]) == jax_dp.validate_srs_device(jsrs, [0, 5]) is True
