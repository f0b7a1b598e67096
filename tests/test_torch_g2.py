"""The port's G2 (barretenberg_tpu_torch/groups/g2.py: the generic
mask-merged group law over the lane-wise Fq2) against the JAX package's
groups/g2.py at 4 lanes, exact: Jacobian coordinates limb for limb (both
run the same formulas), affine results against the host oracle. Inputs are
host points [k]G2 of scalars drawn with numpy from fixed seeds, encoded by
the JAX package and carried across with ``convert``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barretenberg_tpu.groups import g2 as jax_g2
from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields.params import FR_MODULUS
from barretenberg_tpu_torch.groups import JacobianPoints
from barretenberg_tpu_torch.groups.g2 import (
    TWIST_B,
    fq2,
    g2,
    g2_host_to_affine,
    g2_jacobian_to_host,
    g2_points_to_host,
)
from barretenberg_tpu_torch.utils import host_curve as hc

torch.set_num_threads(1)

N = 4
curve = g2("cpu")


def random_points(n, seed):
    rng = np.random.default_rng(seed)
    pts = [hc.g2_mul(hc.G2_GENERATOR, int.from_bytes(rng.bytes(32), "little") % FR_MODULUS or 1) for _ in range(n)]
    jax_pts = jax_g2.g2_host_to_affine(pts)
    port = convert.g2_affine_points(jax_pts.x, jax_pts.y, jax_pts.inf, "cpu")
    return pts, jax_pts, port


def same_jacobian(port, jax_pt):
    for a, b in zip(port[:3], jax_pt[:3]):
        assert np.array_equal(a.numpy().astype(np.uint32), np.asarray(b))
    assert port.inf.tolist() == np.asarray(jax_pt.inf).tolist()


def jax_jacobian(j):
    return jax_g2.g2.to_jacobian(j)


def test_curve_constants_and_encoding_equal_jax():
    assert TWIST_B == jax_g2.TWIST_B
    assert curve.b.tolist() == np.asarray(jax_g2.g2.b).astype(np.int32).tolist()
    pts, jax_pts, port = random_points(N, 1)
    mine = g2_host_to_affine(pts, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(mine, port))
    assert g2_points_to_host(port) == pts == jax_g2.g2_points_to_host(jax_pts)
    assert bool(curve.on_curve_affine(port).all())
    gen = curve.generator(2)
    assert g2_points_to_host(gen) == [hc.G2_GENERATOR] * 2
    with_inf = g2_host_to_affine([pts[0], None], "cpu")
    assert g2_points_to_host(with_inf) == [pts[0], None] and bool(curve.on_curve_affine(with_inf).all())


def test_add_equals_jax_and_host():
    a, ja, pa = random_points(N, 2)
    b, jb, pb = random_points(N, 3)
    got = curve.add(curve.to_jacobian(pa), curve.to_jacobian(pb))
    same_jacobian(got, jax_g2.g2.add(jax_jacobian(ja), jax_jacobian(jb)))
    assert g2_jacobian_to_host(got) == [hc.g2_add(x, y) for x, y in zip(a, b)]


def test_dbl_and_mixed_add_equal_jax_and_host():
    a, ja, pa = random_points(N, 4)
    b, jb, pb = random_points(N, 5)
    dbl = curve.dbl(curve.to_jacobian(pa))
    jdbl = jax_g2.g2.dbl(jax_jacobian(ja))
    same_jacobian(dbl, jdbl)
    want_dbl = [hc.g2_add(x, x) for x in a]
    assert g2_jacobian_to_host(dbl) == want_dbl
    mixed = curve.mixed_add(dbl, pb)
    same_jacobian(mixed, jax_g2.g2.mixed_add(jdbl, jb))
    assert g2_jacobian_to_host(mixed) == [hc.g2_add(d, y) for d, y in zip(want_dbl, b)]


def test_add_exceptions_equal_jax():
    """P + (-P) = infinity, P + P through add = dbl, an operand at infinity
    gives the other, in add and mixed_add."""
    a, ja, pa = random_points(N, 6)
    j = curve.to_jacobian(pa)
    jj = jax_jacobian(ja)
    cancel = curve.add(j, curve.neg(j))
    same_jacobian(cancel, jax_g2.g2.add(jj, jax_g2.g2.neg(jj)))
    assert bool(cancel.inf.all())
    twice = curve.add(j, j)
    same_jacobian(twice, jax_g2.g2.add(jj, jj))
    assert g2_jacobian_to_host(twice) == [hc.g2_add(x, x) for x in a]
    mixed_twice = curve.mixed_add(j, pa)
    same_jacobian(mixed_twice, jax_g2.g2.mixed_add(jj, ja))
    mixed_cancel = curve.mixed_add(j, curve.neg_affine(pa))
    assert bool(mixed_cancel.inf.all())
    # lanes 0, 1 at infinity on one side
    inf = torch.tensor([True, False, True, False])
    p_inf = JacobianPoints(j.x, j.y, j.z, inf)
    jp_inf = jj._replace(inf=jnp.asarray(inf.numpy()))
    b, jb, pb = random_points(N, 7)
    mixed = curve.mixed_add(p_inf, pb)
    same_jacobian(mixed, jax_g2.g2.mixed_add(jp_inf, jb))
    want = [y if i else hc.g2_add(x, y) for x, y, i in zip(a, b, inf.tolist())]
    assert g2_jacobian_to_host(mixed) == want
    added = curve.add(curve.to_jacobian(pb), p_inf)
    same_jacobian(added, jax_g2.g2.add(jax_jacobian(jb), jp_inf))
    assert g2_jacobian_to_host(added) == want


def test_eq_normalize_and_small_scalar_mul():
    a, _, pa = random_points(N, 8)
    j = curve.to_jacobian(pa)
    d = curve.dbl(j)
    assert curve.eq(curve.add(j, j), d).all() and not curve.eq(d, j).any()
    norm = curve.batch_normalize(d)
    assert g2_points_to_host(norm) == [hc.g2_add(x, x) for x in a]
    assert g2_points_to_host(curve.batch_normalize_chunked(d, chunk=3)) == g2_points_to_host(norm)
    assert g2_points_to_host(curve.take_affine(pa, torch.tensor([2, 0]))) == [a[2], a[0]]
    k = 0xB5
    bits = torch.tensor([[(k >> (7 - i)) & 1] * N for i in range(8)], dtype=torch.int32)
    assert g2_jacobian_to_host(curve.scalar_mul_bits(pa, bits)) == [hc.g2_mul(x, k) for x in a]
    assert fq2("cpu").decode(curve.b.reshape(2, 18, 1)) == [TWIST_B]
    with pytest.raises(NotImplementedError):
        curve.scalar_mul_windowed(pa, torch.zeros((18, N), dtype=torch.int32))


@pytest.mark.slow  # the JAX G2 double-and-add: minutes of cold XLA compile
def test_scalar_mul_bits_equal_jax():
    a, ja, pa = random_points(1, 9)
    k = 0xDEADBEEF12345678
    nbits = k.bit_length()
    col = [[(k >> (nbits - 1 - i)) & 1] for i in range(nbits)]
    got = curve.scalar_mul_bits(pa, torch.tensor(col, dtype=torch.int32))
    same_jacobian(got, jax_g2.g2.scalar_mul_bits(ja, jnp.asarray(col, dtype=jnp.uint32)))
    assert g2_jacobian_to_host(got) == [hc.g2_mul(a[0], k)]
