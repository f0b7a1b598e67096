"""The port's lane-wise Fq2 / Fq6 / Fq12 tower (barretenberg_tpu_torch
fields/quadratic.py, fields/tower.py) against the JAX package's at 4 lanes
(the JAX ops run as plain jnp there, below PALLAS_MIN_BATCH), exact: the
same inputs, made with numpy from fixed seeds, encoded by the JAX package
and carried across with ``convert``; results compared as decoded integers
and limb for limb, and against the host tower."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fq as jax_fq
from barretenberg_tpu.fields.quadratic import QuadraticField as JaxQuadratic
from barretenberg_tpu.fields.tower import SexticField as JaxSextic, TwelfthField as JaxTwelfth
from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fq
from barretenberg_tpu_torch.fields.quadratic import QuadraticField
from barretenberg_tpu_torch.fields.tower import SexticField, TwelfthField
from barretenberg_tpu_torch.pairing import tower as ht

torch.set_num_threads(1)

N = 4
P = ht.P

jf2 = JaxQuadratic(jax_fq)
jf6 = JaxSextic(jf2)
jf12 = JaxTwelfth(jf6)
f2 = QuadraticField(fq("cpu"))
f6 = SexticField(f2)
f12 = TwelfthField(f6)


def rand_fq2(rng):
    return tuple(int.from_bytes(rng.bytes(32), "little") % P for _ in range(2))


def rand_fq6(rng):
    return tuple(rand_fq2(rng) for _ in range(3))


def rand_fq12(rng):
    return tuple(rand_fq6(rng) for _ in range(2))


def same(port, jax_arr, port_field, jax_field):
    """Limb for limb and as decoded integers."""
    arr = np.asarray(jax_arr)
    assert np.array_equal(port.numpy().astype(np.uint32), arr)
    assert port_field.decode(port) == jax_field.decode(jax_arr)


def cyclotomic(f):
    a = ht.fq12_mul(ht.fq12_conj(f), ht.fq12_inv(f))
    return ht.fq12_mul(a, ht.fq12_frobenius(a, 2))


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fq2_pair():
    rng = np.random.default_rng(21)
    a = [rand_fq2(rng) for _ in range(N)]
    b = [rand_fq2(rng) for _ in range(N)]
    a[1] = (0, 0)  # a zero lane
    b[2] = (P - 1, 1)
    ja, jb = jf2.encode(a), jf2.encode(b)
    return a, b, ja, jb, convert.fq2_tensor(ja, "cpu"), convert.fq2_tensor(jb, "cpu")


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sqr", "neg", "double", "conjugate", "invert"])
def test_fq2_ops_equal_jax(fq2_pair, op):
    a, b, ja, jb, ta, tb = fq2_pair
    if op in ("add", "sub", "mul"):
        got, want = getattr(f2, op)(ta, tb), getattr(jf2, op)(ja, jb)
    else:
        got, want = getattr(f2, op)(ta), getattr(jf2, op)(ja)
    same(got, want, f2, jf2)
    host = {"add": ht.fq2_add, "sub": ht.fq2_sub, "mul": ht.fq2_mul}
    if op in host:
        assert f2.decode(got) == [host[op](x, y) for x, y in zip(a, b)]
    if op == "invert":
        assert f2.decode(got) == [(0, 0) if x == (0, 0) else ht.fq2_inv(x) for x in a]


def test_fq2_mul_by_base_encode_and_predicates(fq2_pair):
    a, b, ja, jb, ta, tb = fq2_pair
    assert np.array_equal(f2.encode(a).numpy().astype(np.uint32), np.asarray(ja))
    same(f2.mul_by_base(ta, tb[0]), jf2.mul_by_base(ja, jb[0]), f2, jf2)
    assert f2.is_zero(ta).tolist() == np.asarray(jf2.is_zero(ja)).tolist() == [False, True, False, False]
    assert f2.eq(ta, ta).all() and f2.eq(ta, tb).tolist() == np.asarray(jf2.eq(ja, jb)).tolist()
    mask = [True, False, True, False]
    same(f2.select(torch.tensor(mask), ta, tb), jf2.select(jnp.asarray(mask), ja, jb), f2, jf2)
    assert f2.const((3, 5)).tolist() == np.asarray(jf2.const((3, 5))).astype(np.int32).tolist()
    assert f2.full((3,), f2.one).shape == (2, 18, 3)


def test_fq2_batch_invert_equal_jax():
    rng = np.random.default_rng(22)
    vals = [rand_fq2(rng) for _ in range(2 * N)]
    ja = jf2.encode(vals)
    ta = convert.fq2_tensor(ja, "cpu")
    same(f2.batch_invert(ta), jf2.batch_invert(ja), f2, jf2)
    assert f2.decode(f2.batch_invert(ta)) == [ht.fq2_inv(x) for x in vals]
    j2, t2 = ja.reshape(2, 18, 2, N), ta.reshape(2, 18, 2, N)
    same(f2.batch_invert_any(t2).reshape(2, 18, -1), jf2.batch_invert_any(j2).reshape(2, 18, -1), f2, jf2)
    # a zero in the batch: every output is zero in both
    zero = ta.clone()
    zero[:, :, 3] = 0
    jzero = jnp.asarray(np.asarray(zero).astype(np.uint32))
    same(f2.batch_invert(zero), jf2.batch_invert(jzero), f2, jf2)


# ---------------------------------------------------------------------------
# Fq6
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fq6_pair():
    rng = np.random.default_rng(61)
    a = [rand_fq6(rng) for _ in range(N)]
    b = [rand_fq6(rng) for _ in range(N)]
    ja, jb = jf6.encode(a), jf6.encode(b)
    return a, b, ja, jb, convert.fq6_tensor(ja, "cpu"), convert.fq6_tensor(jb, "cpu")


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sqr", "neg", "mul_by_nonresidue", "invert"])
def test_fq6_ops_equal_jax(fq6_pair, op):
    a, b, ja, jb, ta, tb = fq6_pair
    if op in ("add", "sub", "mul"):
        got, want = getattr(f6, op)(ta, tb), getattr(jf6, op)(ja, jb)
    else:
        got, want = getattr(f6, op)(ta), getattr(jf6, op)(ja)
    same(got, want, f6, jf6)
    host = {"mul": lambda x, y: ht.fq6_mul(x, y), "sqr": lambda x, y: ht.fq6_sqr(x),
            "invert": lambda x, y: ht.fq6_inv(x), "mul_by_nonresidue": lambda x, y: ht.fq6_mul_by_nonresidue(x)}
    if op in host:
        assert f6.decode(got) == [host[op](x, y) for x, y in zip(a, b)]


def test_fq6_mul_xi_equal_jax(fq6_pair):
    _, _, ja, _, ta, _ = fq6_pair
    same(f6.mul_xi(ta[0]), jf6.mul_xi(ja[0]), f2, jf2)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fq6_frobenius_equal_jax(fq6_pair, k):
    a, _, ja, _, ta, _ = fq6_pair
    got = f6.frobenius(ta, k)
    same(got, jf6.frobenius(ja, k), f6, jf6)
    assert f6.decode(got) == [ht.fq6_frobenius(x, k) for x in a]


# ---------------------------------------------------------------------------
# Fq12
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fq12_pair():
    rng = np.random.default_rng(121)
    a = [rand_fq12(rng) for _ in range(N)]
    b = [rand_fq12(rng) for _ in range(N)]
    ja, jb = jf12.encode(a), jf12.encode(b)
    return a, b, ja, jb, convert.fq12_tensor(ja, "cpu"), convert.fq12_tensor(jb, "cpu")


@pytest.mark.parametrize("op", ["mul", "sqr", "conjugate", "invert"])
def test_fq12_ops_equal_jax(fq12_pair, op):
    a, b, ja, jb, ta, tb = fq12_pair
    if op == "mul":
        got, want = f12.mul(ta, tb), jf12.mul(ja, jb)
    else:
        got, want = getattr(f12, op)(ta), getattr(jf12, op)(ja)
    same(got, want, f12, jf12)
    host = {"mul": ht.fq12_mul, "sqr": lambda x, y: ht.fq12_sqr(x), "conjugate": lambda x, y: ht.fq12_conj(x),
            "invert": lambda x, y: ht.fq12_inv(x)}
    assert f12.decode(got) == [host[op](x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fq12_frobenius_equal_jax(fq12_pair, k):
    a, _, ja, _, ta, _ = fq12_pair
    got = f12.frobenius(ta, k)
    same(got, jf12.frobenius(ja, k), f12, jf12)
    assert f12.decode(got) == [ht.fq12_frobenius(x, k) for x in a]


def test_fq12_one_and_cyclotomic_sqr_equal_jax(fq12_pair):
    a = fq12_pair[0]
    same(f12.one((N,)), jf12.one((N,)), f12, jf12)
    assert f12.decode(f12.one((2,))) == [ht.FQ12_ONE] * 2
    cyc = [cyclotomic(x) for x in a]
    ja = jf12.encode(cyc)
    ta = convert.fq12_tensor(ja, "cpu")
    got = f12.cyclotomic_sqr(ta)
    same(got, jf12.cyclotomic_sqr(ja), f12, jf12)
    assert f12.decode(got) == [ht.fq12_cyclotomic_sqr(x) for x in cyc] == [ht.fq12_sqr(x) for x in cyc]


def test_fq12_sparse_mul_equal_jax(fq12_pair):
    a, _, ja, _, ta, _ = fq12_pair
    rng = np.random.default_rng(122)
    lines = [tuple(rand_fq2(rng) for _ in range(3)) for _ in range(N)]
    lines[3] = ((1, 0), (0, 0), (0, 0))  # the identity line: a * 1
    jl = [jf2.encode([ln[c] for ln in lines]) for c in range(3)]
    tl = [convert.fq2_tensor(x, "cpu") for x in jl]
    got = f12.sparse_mul(ta, *tl)
    same(got, jf12.sparse_mul(ja, *jl), f12, jf12)
    want = [ht._sparse_mul(x, ln, 1, 1) for x, ln in zip(a, lines)]
    assert f12.decode(got) == want and want[3] == a[3]
