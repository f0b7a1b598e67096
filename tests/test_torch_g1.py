"""The port's G1 group law (K3's module and `Curve`) against the JAX
package, limb for limb (tolerance 0), on the CPU: once against the JAX XLA
path, once against the bodies of its Pallas point kernels run eagerly, with
lanes for infinity operands, P == Q and P == -Q."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barretenberg_tpu import config as jconfig
from barretenberg_tpu.groups import JacobianPoints as JJacobian
from barretenberg_tpu.groups.g1 import g1 as jg1, host_to_affine_points as j_host_to_affine
from barretenberg_tpu.kernels import point_kernels as jkernels

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fq as tfq
from barretenberg_tpu_torch.groups.g1 import (
    fixed_base_mul,
    g1 as tg1,
    host_to_affine_points,
    jacobian_to_host,
    points_to_host,
)
from barretenberg_tpu_torch.kernels import point_kernels
from barretenberg_tpu_torch.utils import host_curve

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

N = 1024  # the lane count the JAX kernel tests use (two tiles)


@pytest.fixture(scope="module")
def operands():
    """P, Q as host points with edge lanes, encoded once by the JAX package:
    lane 0 Q = inf, lane 1 P == Q, lane 2 P == -Q, lane 3 P = inf, lane 4
    both inf."""
    rng = np.random.default_rng(6)
    g = host_curve.G1_GENERATOR
    ks = [int(k) for k in rng.integers(1, 1 << 30, size=2 * N)]
    pts = [host_curve.g1_mul(g, k) for k in ks]
    hp, hq = pts[:N], pts[N:]
    hq[0] = None
    hq[1] = hp[1]
    hq[2] = host_curve.g1_neg(hp[2])
    hp[3] = None
    hp[4] = hq[4] = None
    ja, jb = j_host_to_affine(hp), j_host_to_affine(hq)
    jja, jjb = jg1.to_jacobian(ja), jg1.to_jacobian(jb)
    # give P a non-trivial z: P <- 2P - P would cost a compile; doubling does
    to_t = lambda p: convert.jacobian_points(*(np.asarray(c) for c in p), device="cpu")
    tb_aff = convert.affine_points(*(np.asarray(c) for c in jb), device="cpu")
    return hp, hq, (jja, jjb, jb), (to_t(jja), to_t(jjb), tb_aff)


def _same_points(t, j) -> bool:
    return all(
        np.array_equal(tc.cpu().numpy().astype(jc.dtype), np.asarray(jc)) for tc, jc in zip(t, j)
    )


@pytest.fixture
def xla_path():
    jconfig.set_use_pallas(False)
    yield
    jconfig.set_use_pallas(None)


def _run(op, curve_or_kernels, p, q, q_aff):
    if op == "dbl":
        return curve_or_kernels.dbl(p)
    if op == "add":
        return curve_or_kernels.add(p, q)
    return curve_or_kernels.mixed_add(p, q_aff)


@pytest.mark.parametrize("op", ["dbl", "add", "mixed_add"])
def test_group_law_matches_jax_xla(op, operands, xla_path):
    _, _, jops, tops = operands
    assert _same_points(_run(op, tg1("cpu"), *tops), _run(op, jg1, *jops))


@pytest.mark.parametrize("op", ["dbl", "add", "mixed_add"])
def test_group_law_matches_host_oracle_with_projective_operands(op, operands):
    """Operands with z != 1 (after one doubling), edge lanes included."""
    hp, hq, _, (tp, tq, tq_aff) = operands
    curve = tg1("cpu")
    m = 16
    cut = lambda v: type(v)(*(c[..., :m] for c in v))
    p2 = curve.dbl(cut(tp))  # 2P, z = 2y
    q2 = curve.dbl(cut(tq))
    h2p = [host_curve.g1_add(a, a) for a in hp[:m]]
    h2q = [host_curve.g1_add(a, a) for a in hq[:m]]
    if op == "dbl":
        got, want = curve.dbl(p2), [host_curve.g1_add(a, a) for a in h2p]
    elif op == "add":
        got, want = curve.add(p2, q2), [host_curve.g1_add(a, b) for a, b in zip(h2p, h2q)]
    else:
        got = curve.mixed_add(p2, cut(tq_aff))
        want = [host_curve.g1_add(a, b) for a, b in zip(h2p, hq[:m])]
    assert jacobian_to_host(got) == want


def test_batch_normalize_matches_jax_and_host(operands, xla_path):
    hp, _, (jja, _, _), (tp, _, _) = operands
    curve = tg1("cpu")
    m = 64
    cut = lambda v: type(v)(*(c[..., :m] for c in v))
    tj, jj = curve.dbl(cut(tp)), jg1.dbl(JJacobian(*(c[..., :m] for c in jja)))
    got = curve.batch_normalize(tj)
    assert _same_points(got, jg1.batch_normalize(jj))
    assert points_to_host(got) == [host_curve.g1_add(a, a) for a in hp[:m]]
    chunked = curve.batch_normalize_chunked(tj, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(chunked, got))
    assert bool(curve.on_curve_affine(got).all())


def test_fixed_base_mul_and_host_round_trip():
    ks = [0, 1, 2, 3, 0xDEADBEEF, host_curve.R - 1]
    want = [host_curve.g1_mul(host_curve.G1_GENERATOR, k) for k in ks]
    jac = fixed_base_mul(ks, "cpu")
    assert jacobian_to_host(jac) == want
    aff = host_to_affine_points(want, "cpu")
    assert points_to_host(aff) == want
    assert aff.inf.tolist() == [True, False, False, False, False, False]


def test_scalar_mul_bits_tree_sum_and_selects():
    curve, fq = tg1("cpu"), tfq("cpu")
    g = host_curve.G1_GENERATOR
    ks = [5, 0, 9, 12, 7, 1]
    nbits = 4
    bits = torch.tensor([[(k >> (nbits - 1 - i)) & 1 for k in ks] for i in range(nbits)])
    per_lane = curve.scalar_mul_bits(curve.generator(len(ks)), bits)
    want = [host_curve.g1_mul(g, k) for k in ks]
    assert jacobian_to_host(per_lane) == want
    assert jacobian_to_host(curve.tree_sum(per_lane)) == [host_curve.g1_mul(g, sum(ks))]
    assert jacobian_to_host(curve.tree_sum(per_lane, groups=2)) == [
        host_curve.g1_mul(g, sum(ks[:3])), host_curve.g1_mul(g, sum(ks[3:]))
    ]
    neg = curve.neg(per_lane)
    assert jacobian_to_host(curve.add(per_lane, neg)) == [None] * len(ks)
    mask = torch.tensor([True, False] * 3)
    picked = curve.select_points(mask, per_lane, curve.infinity(len(ks)))
    assert jacobian_to_host(picked) == [w if m else None for w, m in zip(want, mask.tolist())]
    idx = torch.tensor([2, 0])
    taken = curve.take_affine(curve.batch_normalize(per_lane), idx)
    assert points_to_host(taken) == [want[2], want[0]]
    assert fq.decode(curve.generator(1).y) == [2]


class _BlockRef:
    """Stands in for a Pallas block ref: rows on the leading axis, read and
    written by index, which is all the point kernels' bodies do with a ref."""

    def __init__(self, array):
        self.rows = list(array)

    def __getitem__(self, i):
        return self.rows[i]

    def __setitem__(self, i, value):
        self.rows[i] = value


def _run_kernel_body(kernel, out_shape, **_specs):
    """A drop-in for `pl.pallas_call` that runs the kernel body once over the
    whole arrays, eagerly."""

    def call(*args):
        outs = [_BlockRef(jnp.zeros(s.shape, s.dtype)) for s in out_shape]
        kernel(*(_BlockRef(a) for a in args), *outs)
        return tuple(jnp.stack(o.rows) for o in outs)

    return call


@pytest.mark.parametrize("op", ["dbl", "add", "mixed_add"])
def test_kernel_module_matches_jax_pallas_kernel_body(op, operands, monkeypatch):
    """K3's module against the bodies of the JAX package's Pallas point
    kernels (`point_kernels._kernel_fn`: LimbField arithmetic on limb rows),
    run eagerly. Compiling those kernels in interpret mode, as
    tests/test_kernels.py does, takes more than an hour on a CPU for one
    kernel, so the body is executed directly: `pallas_call` is replaced, for
    this test only, by a function that hands the body whole-array refs."""
    _, _, jops, tops = operands
    m = 128
    cut = lambda v: type(v)(*(c[..., :m] for c in v))
    jops, tops = [cut(v) for v in jops], [cut(v) for v in tops]
    monkeypatch.setattr(jkernels.pl, "pallas_call", _run_kernel_body)
    monkeypatch.setattr(jkernels, "_kernel_fn", jkernels._kernel_fn.__wrapped__)
    with jax.disable_jit():
        want = _run(op, jkernels, *jops)
    assert _same_points(_run(op, point_kernels, *tops), want)
