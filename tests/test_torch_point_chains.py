"""The port's lane-wise point chains (K3d `scalar_mul_bits` under
`naive_msm` / `batched_msm`, K3e `fixed_base` under `fixed_base_mul`) and the
MSB-first bit builder, against the JAX package's Jacobian coordinates limb
for limb (tolerance 0) and the host oracle, on the CPU, where the wrappers
take their plain versions. The JAX side runs on its XLA path at 16 lanes,
programs its n = 16 prover tests already compile. Edge lanes: scalars 0, 1,
r - 1 and 2^253, a point at infinity and a repeated point."""

import numpy as np
import pytest
import torch

from barretenberg_tpu import config as jconfig
from barretenberg_tpu.fields import fr as jfr
from barretenberg_tpu.groups.g1 import fixed_base_mul as j_fixed_base_mul
from barretenberg_tpu.groups.g1 import host_to_affine_points as j_host_to_affine
from barretenberg_tpu.msm import batched_msm as j_batched_msm
from barretenberg_tpu.msm import naive_msm as j_naive_msm
from barretenberg_tpu.msm.pippenger import scalar_digits as j_scalar_digits

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.groups.g1 import fixed_base_mul, g1 as tg1, jacobian_to_host
from barretenberg_tpu_torch.kernels import point_kernels
from barretenberg_tpu_torch.msm import batched_msm, naive_msm, scalar_digits
from barretenberg_tpu_torch.msm.naive import scalar_bits
from barretenberg_tpu_torch.utils import host_curve

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

N, B = 16, 3
R = jfr.p
EDGE_SCALARS = [0, 1, R - 1, 1 << 253]


@pytest.fixture(scope="module")
def data():
    """B x N seeded scalars, each group with the edge scalars in front (in
    another order per group), and N host points: lane 1 repeats lane 0's
    point, lane 2 is the point at infinity."""
    rng = np.random.default_rng(55)
    groups = []
    for g in range(B):
        ks = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(N)]
        ks[:4] = EDGE_SCALARS[g:] + EDGE_SCALARS[:g]
        groups.append(ks)
    hp = [host_curve.g1_mul(host_curve.G1_GENERATOR, int(k)) for k in rng.integers(1, 1 << 30, size=N)]
    hp[1] = hp[0]
    hp[2] = None
    jpts = j_host_to_affine(hp)
    tpts = convert.affine_points(*(np.asarray(c) for c in jpts), device="cpu")
    jscal = [jfr.encode(ks) for ks in groups]
    tscal = [convert.field_tensor(np.asarray(s), "cpu") for s in jscal]
    return groups, hp, jpts, tpts, jscal, tscal


@pytest.fixture
def xla_path():
    jconfig.set_use_pallas(False)
    yield
    jconfig.set_use_pallas(None)


def _same_points(t, j) -> bool:
    return all(
        np.array_equal(tc.cpu().numpy().astype(jc.dtype), np.asarray(jc)) for tc, jc in zip(t, j)
    )


def test_scalar_bits_match_scalar_digits(data):
    _, _, _, _, jscal, tscal = data
    for t, j in zip(tscal, jscal):
        bits = scalar_bits(t)
        assert bits.dtype == torch.uint8 and bits.shape == (254, N)
        assert torch.equal(bits.to(torch.int64), scalar_digits(t, 1).flip(0))
        assert np.array_equal(bits.numpy(), np.asarray(j_scalar_digits(j, 1))[::-1])


def test_naive_msm_matches_jax_and_host(data, xla_path):
    groups, hp, jpts, tpts, jscal, tscal = data
    got = naive_msm(tscal[0], tpts)
    assert _same_points(got, j_naive_msm(jscal[0], jpts))
    assert jacobian_to_host(got) == [host_curve.g1_msm(hp, groups[0])]


def test_batched_msm_matches_jax_and_host(data, xla_path):
    groups, hp, jpts, tpts, jscal, tscal = data
    got = batched_msm(tscal, tpts)
    assert _same_points(got, j_batched_msm(jscal, jpts))
    assert jacobian_to_host(got) == [host_curve.g1_msm(hp, ks) for ks in groups]


def test_scalar_mul_bits_lanes_match_host(data):
    """Every lane of the B x N double-and-add (lane l multiplies point
    l % N), before the tree sum; on the CPU no kernel launches."""
    groups, hp, _, tpts, _, tscal = data
    before = dict(point_kernels.launch_counts)
    bits = scalar_bits(torch.cat(tscal, dim=1))
    got = tg1("cpu").scalar_mul_bits(tpts, bits)
    flat = [k for ks in groups for k in ks]
    assert jacobian_to_host(got) == [host_curve.g1_mul(hp[i % N], k) for i, k in enumerate(flat)]
    assert point_kernels.launch_counts == before


def test_fixed_base_mul_matches_jax_and_host(xla_path):
    rng = np.random.default_rng(56)
    ks = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(N)]
    # the edge scalars, a window's top digit, the next window's first, the
    # top window alone, a repeated scalar
    ks[:8] = EDGE_SCALARS + [255, 256, 1 << 248, ks[8]]
    got = fixed_base_mul(ks, "cpu")
    assert _same_points(got, j_fixed_base_mul(ks))
    assert jacobian_to_host(got) == [host_curve.g1_mul(host_curve.G1_GENERATOR, k) for k in ks]


def test_point_table_rows_round_trip(data):
    """K3e's row layout (point_table) unpacks to the planar points it came
    from, infinity flag included."""
    tpts = data[3]
    back = point_kernels.row_points(point_kernels.point_table(*tpts))
    assert all(torch.equal(a, b) for a, b in zip(back, tpts))
