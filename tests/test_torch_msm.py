"""The port's MSM stack against the JAX package (Jacobian coordinates, limb
for limb) and the host oracle, on the CPU. The JAX side uses the one
(n, c, block) Pippenger configuration its own tests compile."""

import numpy as np
import pytest
import torch

from barretenberg_tpu.fields import fr as jfr
from barretenberg_tpu.groups.g1 import host_to_affine_points as j_host_to_affine
from barretenberg_tpu.msm import pippenger as j_pippenger
from barretenberg_tpu.msm import signed_digits as j_signed_digits
from barretenberg_tpu.msm import split_scalars as j_split_scalars
from barretenberg_tpu.msm.pippenger import scalar_digits as j_scalar_digits

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fr as tfr
from barretenberg_tpu_torch.fields.glv import split_into_endomorphism_scalars
from barretenberg_tpu_torch.fields.limbs import limbs_to_ints
from barretenberg_tpu_torch.groups.g1 import g1 as tg1, jacobian_to_host
from barretenberg_tpu_torch.msm import (
    batched_msm,
    msm,
    naive_msm,
    optimal_window,
    pippenger,
    scalar_digits,
    signed_digits,
    split_scalars,
)
from barretenberg_tpu_torch.utils import host_curve

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

N, C, BLOCK = 64, 8, 16  # the configuration tests/test_msm.py compiles
P = jfr.p


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(36)
    scalars = [0, 1, P - 1, 2] + [int.from_bytes(rng.bytes(32), "little") % P for _ in range(N - 4)]
    g = host_curve.G1_GENERATOR
    host_pts = [host_curve.g1_mul(g, int(k)) for k in rng.integers(1, 1 << 30, size=N)]
    jpts = j_host_to_affine(host_pts)
    jscal = jfr.encode(scalars)
    tpts = convert.affine_points(*(np.asarray(c) for c in jpts), device="cpu")
    return scalars, host_pts, jscal, jpts, convert.field_tensor(jscal, "cpu"), tpts


def test_split_scalars_matches_jax_and_host(data):
    scalars, _, jscal, _, tscal, _ = data
    k1, k2 = split_scalars(tscal)
    jk1, jk2 = j_split_scalars(jscal)
    assert np.array_equal(convert.field_array(k1), np.asarray(jk1))
    assert np.array_equal(convert.field_array(k2), np.asarray(jk2))
    got = list(zip(limbs_to_ints(k1.numpy()), limbs_to_ints(k2.numpy())))
    assert got == [split_into_endomorphism_scalars(s) for s in scalars]


@pytest.mark.parametrize("c", [4, 8, 10, 13])
def test_signed_digits_reconstruct_the_scalar(data, c):
    _, _, _, _, tscal, _ = data
    k1, _ = split_scalars(tscal)
    d = signed_digits(k1, c)
    assert d.dtype == torch.int32 and d.shape == (-(-128 // c) + 1, N)
    assert int(d.abs().max()) <= 1 << (c - 1)
    rebuilt = [sum(int(d[r, i]) << (c * r) for r in range(d.shape[0])) for i in range(N)]
    assert rebuilt == limbs_to_ints(k1.numpy())


def test_signed_and_unsigned_digits_match_jax(data):
    _, _, jscal, _, tscal, _ = data
    k1, _ = split_scalars(tscal)
    jk1, _ = j_split_scalars(jscal)
    assert np.array_equal(signed_digits(k1, C).numpy(), np.asarray(j_signed_digits(jk1, C)))
    assert np.array_equal(scalar_digits(tscal, C).numpy(), np.asarray(j_scalar_digits(jscal, C)))


def test_pippenger_matches_jax_coordinates_and_host_oracle(data):
    scalars, host_pts, jscal, jpts, tscal, tpts = data
    got = pippenger(tscal, tpts, c=C, block=BLOCK)
    want = j_pippenger(jscal, jpts, c=C, block=BLOCK, fused=False)
    for tc, jc in zip(got, want):
        assert np.array_equal(tc.numpy().astype(jc.dtype), np.asarray(jc))
    assert jacobian_to_host(got) == [host_curve.g1_msm(host_pts, scalars)]


def test_pippenger_all_zero_scalars_is_infinity(data):
    _, _, _, _, _, tpts = data
    m = 16
    pts = tg1("cpu").take_affine(tpts, torch.arange(m))
    res = pippenger(tfr("cpu").encode([0] * m), pts, c=4, block=16)
    assert jacobian_to_host(res) == [None]


def test_naive_and_batched_msm_match_host_oracle(data):
    scalars, host_pts, _, _, tscal, tpts = data
    m = 8
    pts = tg1("cpu").take_affine(tpts, torch.arange(m))
    s1, s2 = tscal[:, :m].contiguous(), tscal[:, m : 2 * m].contiguous()
    want1 = host_curve.g1_msm(host_pts[:m], scalars[:m])
    want2 = host_curve.g1_msm(host_pts[:m], scalars[m : 2 * m])
    assert jacobian_to_host(naive_msm(s1, pts)) == [want1]
    assert jacobian_to_host(batched_msm([s1, s2], pts)) == [want1, want2]
    single = msm(s1, pts)  # below the Pippenger threshold: the naive path
    assert all(torch.equal(a, b) for a, b in zip(single, naive_msm(s1, pts)))


def test_optimal_window():
    assert [optimal_window(n) for n in (16, 1 << 12, 1 << 16, 1 << 20)] == [8, 8, 10, 13]
