"""The port's G1 library surface against the JAX package, tolerance 0, on the
CPU (the kernel wrappers take their plain versions there): ``Field.sqrt`` /
``sqrt_host``, the small group methods, ``signed_digits_full``, the
arbitrary-base scalar multiplications (``Curve.scalar_mul_windowed`` and
``scalar_mul_glv``, K3g's plain walk; ``scalar_mul``, K3d's), the point
samplers (``hash_to_curve``, ``random_affine_points``,
``random_points_device``) and the polynomial leftovers
(``compute_kate_opening_coefficients``, ``compress_fft``,
``shrink_evaluation_domain``). The JAX sides run at the shapes its own
tests compile (4 lanes for the walks, 16 x 4 candidates for
hash_to_curve). Also Python models of K3g's index arithmetic: its table
entries (28 words as seven 16-byte words, each lane's entries contiguous)
and its windowed digits taken from 30-bit limbs."""

import pathlib
import re

import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fq as jfq
from barretenberg_tpu.fields import fr as jfr
from barretenberg_tpu.groups import AffinePoints as JAffine
from barretenberg_tpu.groups import JacobianPoints as JJacobian
from barretenberg_tpu.groups import g1 as jg1
from barretenberg_tpu.groups.g1 import hash_to_curve as j_hash_to_curve
from barretenberg_tpu.groups.g1 import random_affine_points as j_random_affine_points
from barretenberg_tpu.groups.g1 import random_points_device as j_random_points_device
from barretenberg_tpu.groups.g1 import scalar_mul as j_scalar_mul
from barretenberg_tpu.groups.g1 import scalar_mul_glv as j_scalar_mul_glv
from barretenberg_tpu.groups.g1 import scalars_to_bits_msb as j_scalars_to_bits_msb
from barretenberg_tpu.msm.wnaf import signed_digits_full as j_signed_digits_full
from barretenberg_tpu.polynomials import arithmetic as JPA

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fq as tfq, fr as tfr
from barretenberg_tpu_torch.groups import AffinePoints, JacobianPoints
from barretenberg_tpu_torch.groups.g1 import (
    g1 as tg1,
    hash_to_curve,
    jacobian_to_host,
    points_to_host,
    random_affine_points,
    random_points_device,
    scalar_mul,
    scalar_mul_glv,
    scalars_to_bits_msb,
)
from barretenberg_tpu_torch.kernels import msm_kernels, point_kernels
from barretenberg_tpu_torch.msm.wnaf import signed_digits_full
from barretenberg_tpu_torch.polynomials import arithmetic as PA
from barretenberg_tpu_torch.utils import host_curve

torch.set_num_threads(1)

R = jfr.p
Q = jfq.p
CSRC = pathlib.Path(__file__).resolve().parent.parent / "barretenberg_tpu_torch" / "csrc"


def _same(t, j) -> bool:
    """Port tensors (limbs as int32, masks as bool) equal the JAX arrays."""
    return all(np.array_equal(tc.cpu().numpy().astype(np.asarray(jc).dtype), np.asarray(jc)) for tc, jc in zip(t, j))


def _t_affine(p) -> AffinePoints:
    return convert.affine_points(*(np.asarray(c) for c in p), device="cpu")


def _t_field(a) -> torch.Tensor:
    return convert.field_tensor(np.asarray(a), "cpu")


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------
def _values(p: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def test_sqrt_matches_jax():
    """The inputs of tests/test_fields.py's sqrt test (8 squares), with 0, 1
    and a non-residue: the roots' limbs equal JAX's fq.sqrt, and squared
    give the squares back."""
    squares = [x * x % Q for x in _values(Q, 8, 10)] + [0, 1, 3]
    got = tfq("cpu").sqrt(tfq("cpu").encode(squares))
    assert _same([got], [jfq.sqrt(jfq.encode(squares))])
    roots = tfq("cpu").decode(got)
    assert [r * r % Q for r in roots[:-1]] == squares[:-1]
    assert roots[-1] ** 2 % Q != 3  # 3 is no square mod q: the chain's value is not a root
    with pytest.raises(NotImplementedError):
        tfr("cpu").sqrt(tfr("cpu").encode([4]))


@pytest.mark.parametrize("field, jfield", [(tfq, jfq), (tfr, jfr)], ids=["fq", "fr"])
def test_sqrt_host_matches_jax(field, jfield):
    """Tonelli-Shanks on host ints (p = 1 mod 4 for Fr), non-residues None."""
    p = jfield.p
    vals = [x * x % p for x in _values(p, 8, 10)] + [0, 1, 3, 5, 7, p - 1]
    got = [field("cpu").sqrt_host(v) for v in vals]
    assert got == [jfield.sqrt_host(v) for v in vals]
    assert all(r is None or r * r % p == v % p for r, v in zip(got, vals))


# ---------------------------------------------------------------------------
# group methods
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jac_pair():
    """Two Jacobian batches of 6 lanes with random z: lane 0 the same point
    twice (other z), lane 1 P and -P, lane 2 P at infinity, lane 3 both at
    infinity, lanes 4-5 unrelated points."""
    rng = np.random.default_rng(71)
    ks = [int(k) for k in rng.integers(1, 1 << 40, size=12)]
    pts = [host_curve.g1_mul(host_curve.G1_GENERATOR, k) for k in ks]

    def batch(host, zs, infs):
        xs = [x * z * z % Q for (x, _), z in zip(host, zs)]
        ys = [y * z * z * z % Q for (_, y), z in zip(host, zs)]
        return [xs, ys, zs, infs]

    zs1 = [int(z) for z in rng.integers(2, 1 << 60, size=6)]
    zs2 = [int(z) for z in rng.integers(2, 1 << 60, size=6)]
    p = pts[:6]
    q = [pts[0], host_curve.g1_neg(pts[1])] + pts[8:12]
    a = batch(p, zs1, [False, False, True, True, False, False])
    b = batch(q, zs2, [False, False, False, True, False, False])

    def both(v):
        jp = JJacobian(jfq.encode(v[0]), jfq.encode(v[1]), jfq.encode(v[2]), np.array(v[3]))
        tp = JacobianPoints(tfq("cpu").encode(v[0]), tfq("cpu").encode(v[1]), tfq("cpu").encode(v[2]),
                            torch.tensor(v[3]))
        return jp, tp

    return both(a), both(b)


def test_eq_and_normalize_match_jax(jac_pair):
    (jp, tp), (jq, tq) = jac_pair
    curve = tg1("cpu")
    got = curve.eq(tp, tq)
    assert got.tolist() == np.asarray(jg1.eq(jp, jq)).tolist() == [True, False, False, True, False, False]
    assert curve.eq(tp, tp).all()
    assert _same(curve.normalize(tp), jg1.normalize(jp))


def test_affine_negation_and_infinity_match_jax(jac_pair):
    (jp, tp), _ = jac_pair
    curve = tg1("cpu")
    ta, ja = curve.normalize(tp), jg1.normalize(jp)
    assert _same(curve.neg_affine(ta), jg1.neg_affine(ja))
    pred = np.array([True, False, True, False, True, True])
    assert _same(curve.conditional_negate_affine(ta, torch.from_numpy(pred)),
                 jg1.conditional_negate_affine(ja, pred))
    assert _same(curve.affine_infinity(5), jg1.affine_infinity((5,)))


# ---------------------------------------------------------------------------
# digits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", [1, 4, 5, 8, 13])
def test_signed_digits_full_matches_jax(c):
    vals = [0, 1, R - 1, (1 << 253) + 5] + _values(R, 12, 72)
    got = signed_digits_full(tfr("cpu").to_plain(tfr("cpu").encode(vals)), c)
    want = np.asarray(j_signed_digits_full(jfr.to_plain(jfr.encode(vals)), c))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert got.shape[0] == point_kernels.walk_rounds(c, glv=False)
    rebuilt = [sum(int(got[r, i]) << (c * r) for r in range(got.shape[0])) for i in range(len(vals))]
    assert rebuilt == vals


def _walk_defines() -> dict:
    src = (CSRC / "point_chains.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"#define (WALK_MAX_C|WALK_MAX_ROUNDS|ENTRY_VEC) (\d+)", src)}


def _kernel_digits(value: int, c: int) -> list:
    """K3g's windowed digits as its loop computes them: the plain value in
    nine 30-bit limbs, window r from limb lo / 30 shifted by lo % 30 and the
    next limb above it, borrow-recoded least significant first."""
    k = [(value >> (30 * i)) & ((1 << 30) - 1) for i in range(9)]
    rounds = point_kernels.walk_rounds(c, glv=False)
    mask, half = (1 << c) - 1, 1 << (c - 1)
    out, carry = [], 0
    for r in range(rounds - 1):
        lo = r * c
        w, sh = lo // 30, lo % 30
        bits = k[w] >> sh
        if w + 1 < 9:
            bits |= k[w + 1] << (30 - sh)
        v = (bits & mask) + carry
        carry = int(v >= half)
        out.append(v - (carry << c))
    return out + [carry]


@pytest.mark.parametrize("c", [1, 5, 8, 16])
def test_k3g_digit_model_matches_signed_digits_full(c):
    """The kernel's digit arithmetic on 30-bit limbs gives signed_digits_full's
    digits; its local array and window limit hold every c it accepts."""
    defines = _walk_defines()
    assert defines["WALK_MAX_C"] == point_kernels.MAX_WALK_C
    assert point_kernels.walk_rounds(1, glv=False) <= defines["WALK_MAX_ROUNDS"]
    vals = [0, 1, R - 1, (1 << 253) + (1 << 30) - 1] + _values(R, 6, 73)
    want = signed_digits_full(tfr("cpu").to_plain(tfr("cpu").encode(vals)), c)
    assert [_kernel_digits(v, c) for v in vals] == want.t().tolist()
    assert all(abs(d) < 1 << 15 for v in vals for d in _kernel_digits(v, c))  # a short holds them


def test_k3g_table_entry_layout_round_trip():
    """K3g's table in device memory: lane l's entry m at 16-byte word (l *
    size + m) * ENTRY_VEC, each entry x, y, z as 9 x 30-bit words and the
    infinity word; packing the plain table so and unpacking it gives it back."""
    vec = _walk_defines()["ENTRY_VEC"]
    assert 4 * vec == point_kernels.ENTRY_WORDS == 3 * 9 + 1
    pts = random_affine_points(3, np.random.default_rng(74), device="cpu")
    pts = AffinePoints(pts.x, pts.y, torch.tensor([False, True, False]))
    c = 3
    size = (1 << (c - 1)) + 1
    tab = point_kernels.plain_mul_table(pts, size)  # (18, size, n)

    def words(t):  # (18, ...) 15-bit limbs -> (9, ...) 30-bit words
        return t[0::2] | (t[1::2] << 15)

    n = pts.x.shape[1]
    flat = torch.zeros(n * size * vec * 4, dtype=torch.int64)
    for lane in range(n):
        for m in range(size):
            base = (lane * size + m) * vec * 4
            entry = torch.cat([words(tab.x[:, m, lane]), words(tab.y[:, m, lane]), words(tab.z[:, m, lane]),
                               tab.inf[m, lane].reshape(1).to(torch.int64)])
            flat[base : base + 4 * vec] = entry
    back = flat.reshape(n, size, 4 * vec)

    def limbs(w):  # (..., 9) words -> (18, size, n) limbs
        w = w.permute(2, 1, 0)
        return torch.stack((w & 0x7FFF, w >> 15), 1).reshape(18, size, n)

    assert torch.equal(limbs(back[..., 0:9]), tab.x.to(torch.int64))
    assert torch.equal(limbs(back[..., 9:18]), tab.y.to(torch.int64))
    assert torch.equal(limbs(back[..., 18:27]), tab.z.to(torch.int64))
    assert torch.equal(back[..., 27].t() != 0, tab.inf)
    # T[0] is infinity with zero coordinates; a lane at infinity has only such entries
    assert tab.inf[0].all() and not tab.x[:, 0].any() and tab.inf[:, 1].all() and not tab.z[:, :, 1].any()
    host = points_to_host(pts)
    for m in range(1, size):
        got = jacobian_to_host(JacobianPoints(tab.x[:, m], tab.y[:, m], tab.z[:, m], tab.inf[m]))
        assert got == [host_curve.g1_mul(h, m) if h else None for h in host]


# ---------------------------------------------------------------------------
# scalar multiplication
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def walk_inputs():
    """tests/test_g1.py's windowed / GLV inputs (4 points, scalars 0, 1,
    r - 1 and a random one), and the same with lanes 1 and 3 at infinity."""
    rng = np.random.default_rng(17)
    jpts = j_random_affine_points(4, rng)
    svals = [0, 1, R - 1, int.from_bytes(rng.bytes(32), "little") % R]
    inf = np.array([False, True, False, True])
    jpts_inf = JAffine(jpts.x, jpts.y, inf)
    return svals, jfr.encode(svals), jpts, jpts_inf


@pytest.mark.parametrize("glv", [False, True], ids=["windowed", "glv"])
def test_scalar_mul_walks_match_jax_and_host(walk_inputs, glv):
    svals, jscal, jpts, jpts_inf = walk_inputs
    tscal = _t_field(jscal)
    for jp in (jpts, jpts_inf):
        tp = _t_affine(jp)
        if glv:
            got, want = scalar_mul_glv(tp, tscal, c=5), j_scalar_mul_glv(jp, jscal, c=5)
        else:
            got, want = tg1("cpu").scalar_mul_windowed(tp, tscal, c=5), jg1.scalar_mul_windowed(jp, jscal, c=5)
        assert _same(got, want)
        host = points_to_host(tp)
        assert jacobian_to_host(got) == [host_curve.g1_mul(h, k) if h else None for h, k in zip(host, svals)]


def test_walks_launch_no_kernel_on_the_cpu(walk_inputs):
    svals, jscal, jpts, _ = walk_inputs
    before = dict(point_kernels.launch_counts), dict(msm_kernels.launch_counts)
    tp, tscal = _t_affine(jpts), _t_field(jscal)
    scalar_mul_glv(tp, tscal, c=4)
    tg1("cpu").scalar_mul_windowed(tp, tscal, c=4)
    assert (point_kernels.launch_counts, msm_kernels.launch_counts) == before


def test_walks_refuse_windows_out_of_range():
    """K3g takes 1 <= c <= WALK_MAX_C (its digits are shorts), on either path."""
    tp = random_affine_points(2, np.random.default_rng(75), device="cpu")
    scalars = tfr("cpu").encode([1, 2])
    for c in (0, point_kernels.MAX_WALK_C + 1):
        with pytest.raises(ValueError):
            tg1("cpu").scalar_mul_windowed(tp, scalars, c=c)
        with pytest.raises(ValueError):
            point_kernels.glv_walk(tp, torch.zeros((3, 2, 2), dtype=torch.int32), c)


def test_scalar_mul_matches_jax_and_host():
    """tests/test_g1.py's scalar_mul edges: scalar 0 (infinity), 1 and k."""
    k = 0x1234567890ABCDEF1234567890ABCDEF
    jgen = jg1.generator((1,))
    tgen = tg1("cpu").generator(1)
    for s in (0, 1, k, R + 1):
        got = scalar_mul(tgen, s)
        assert _same(got, j_scalar_mul(jgen, s))
    assert jacobian_to_host(scalar_mul(tgen, k)) == [host_curve.g1_mul(host_curve.G1_GENERATOR, k)]
    assert bool(scalar_mul(tgen, 0).inf.all())


def test_scalars_to_bits_msb_matches_jax():
    vals = [0, 1, R - 1, 1 << 253, 12345]
    got = scalars_to_bits_msb(vals, device="cpu")
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), np.asarray(j_scalars_to_bits_msb(vals)))
    assert np.array_equal(scalars_to_bits_msb(vals, 200, "cpu").numpy(), np.asarray(j_scalars_to_bits_msb(vals, 200)))


# ---------------------------------------------------------------------------
# point samplers
# ---------------------------------------------------------------------------
def test_hash_to_curve_matches_jax():
    """tests/test_g1.py's hash_to_curve(b"kat-seed", 16, attempts=4) and its
    pinned one-point KAT: the same affine points; every point on the curve."""
    got = hash_to_curve(b"kat-seed", 16, attempts=4, device="cpu")
    assert _same(got, j_hash_to_curve(b"kat-seed", 16, attempts=4))
    assert all(host_curve.g1_is_on_curve(p) for p in points_to_host(got))
    one = hash_to_curve(b"kat-seed", 1, device="cpu")
    assert tfq("cpu").decode(one.x)[0] == 0x2C18C36213674232FA0639643913CD5DFF4D3F08C434432DB4D11BCE58BDDDBA
    assert tfq("cpu").decode(one.y)[0] == 0x0AD722A88ED54726ECAE4398297497A01F004BB90EE73ED7960345A221DDBD73


def test_hash_to_curve_host_completion_matches_jax():
    """One attempt per lane: about half the lanes miss and finish on the
    host; the points are JAX's."""
    got = hash_to_curve(b"miss", 16, attempts=1, device="cpu")
    assert _same(got, j_hash_to_curve(b"miss", 16, attempts=1))
    assert all(host_curve.g1_is_on_curve(p) for p in points_to_host(got))


def test_random_affine_points_matches_jax():
    got = random_affine_points(16, np.random.default_rng(21), device="cpu")
    assert _same(got, j_random_affine_points(16, np.random.default_rng(21)))


def test_random_points_device_matches_jax():
    """The same seed gives the same points (the generator's multiples by
    the scalars the generator of numbers draws, 0 -> 1)."""
    got = random_points_device(8, np.random.default_rng(3), device="cpu")
    assert _same(got, j_random_points_device(8, np.random.default_rng(3)))
    rng = np.random.default_rng(3)
    ks = [int.from_bytes(rng.bytes(32), "little") % R or 1 for _ in range(8)]
    assert points_to_host(got) == [host_curve.g1_mul(host_curve.G1_GENERATOR, k) for k in ks]


# ---------------------------------------------------------------------------
# polynomials
# ---------------------------------------------------------------------------
def test_kate_opening_coefficients_match_jax():
    """tests/test_polynomials.py's inputs: 16 coefficients (seed 5) at z."""
    rng = np.random.default_rng(5)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(16)]
    z = 0x1234567DEADBEEF
    got_w, got_f = PA.compute_kate_opening_coefficients(tfr("cpu").encode(coeffs), z)
    want_w, want_f = JPA.compute_kate_opening_coefficients(jfr.encode(coeffs), z)
    assert got_f == want_f and _same([got_w], [want_w])


def test_compress_and_shrink_match_jax():
    vals = _values(R, 32, 76)
    t, j = tfr("cpu").encode(vals), jfr.encode(vals)
    for k in (0, 1, 3):
        assert _same([PA.compress_fft(t, k)], [JPA.compress_fft(j, k)])
    for size in (1, 8, 32):
        assert _same([PA.shrink_evaluation_domain(t, size)], [JPA.shrink_evaluation_domain(j, size)])
