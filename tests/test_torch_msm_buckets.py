"""The MSM bucket kernels' plain versions (K3a ``bucket_accumulate``, K3b
``bucket_reduce``) against the JAX package's per-round ``_bucket_sums`` and
``_accumulate_window`` (Jacobian coordinates limb for limb), and the
rounds-batched Pippenger against the per-round path and the host oracle on
edge cases, on the CPU.

The JAX functions run once per module under ``jax.disable_jit()`` (op by op,
~2 s per point operation here, and no whole-program XLA compile), at a size
with few scan levels: 32 entries, blocks of 8, 8 buckets."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barretenberg_tpu.groups import AffinePoints as JAffine
from barretenberg_tpu.groups.g1 import host_to_affine_points as j_host_to_affine

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fq as tfq, fr as tfr
from barretenberg_tpu_torch.fields.params import FR_MODULUS
from barretenberg_tpu_torch.groups import JacobianPoints
from barretenberg_tpu_torch.groups.g1 import g1 as tg1, host_to_affine_points, jacobian_to_host
from barretenberg_tpu_torch.kernels import msm_kernels
from barretenberg_tpu_torch.msm import pippenger
from barretenberg_tpu_torch.msm.pippenger import glv_entries
from barretenberg_tpu_torch.utils import host_curve

# The port's CPU path is many tiny tensor ops; intra-op threads only add
# synchronisation cost there and fight the other test workers for cores.
torch.set_num_threads(1)

# the module, not the function barretenberg_tpu.msm re-exports under its name
jpip = importlib.import_module("barretenberg_tpu.msm.pippenger")

M, BLOCK, NB = 32, 8, 8  # one round's entries, block, buckets (c = 4)


def _host_points(rng, n):
    g = host_curve.G1_GENERATOR
    return [host_curve.g1_mul(g, int(k)) for k in rng.integers(1, 1 << 30, size=n)]


def _same(t, j) -> bool:
    return all(np.array_equal(tc.numpy().astype(np.asarray(jc).dtype), np.asarray(jc)) for tc, jc in zip(t, j))


@pytest.fixture(scope="module")
def one_round():
    """One round of 32 entries with: P twice first in bucket 0 (a doubling
    mid-walk), P and -P first in bucket 1 (they cancel), a bucket of 12
    entries spanning blocks, dead (zero-digit) entries and points at
    infinity. Returns the port's inputs, and the JAX package's bucket sums
    and window sum for the same entries."""
    rng = np.random.default_rng(41)
    pts = _host_points(rng, M)
    pts[1] = pts[0]
    pts[3] = pts[2]
    pts[20] = pts[27] = None
    digits = rng.choice([-8, -7, -6, -4, -3, 3, 4, 6, 7, 8], size=M)
    digits[:4] = [1, 1, 2, -2]
    digits[8:20] = 5
    digits[[5, 13, 22, 30]] = 0
    jpts = j_host_to_affine(pts)
    tpts = convert.affine_points(*(np.asarray(c) for c in jpts), device="cpu")
    d = torch.from_numpy(digits.astype(np.int32)).reshape(1, M)

    # the JAX round body takes each entry as it enters its bucket: -P for a
    # negative digit, dead (at infinity, bucket NB) for a zero digit
    y = torch.where(torch.from_numpy(digits < 0).unsqueeze(0), tfq("cpu").neg(tpts.y), tpts.y)
    jin = JAffine(jpts.x, jnp.asarray(convert.field_array(y)), jnp.asarray(np.asarray(jpts.inf) | (digits == 0)))
    bucket = jnp.asarray(np.where(digits == 0, NB, np.abs(digits) - 1).astype(np.uint32))
    captured = {}
    bucket_sums = jpip._bucket_sums

    def capture(*args):
        captured["sums"] = bucket_sums(*args)
        return captured["sums"]

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jpip, "_bucket_sums", capture)
        window = jpip._accumulate_window(bucket, jin, NB, BLOCK)
    partials = msm_kernels.plain_bucket_accumulate(msm_kernels.sort_rounds(d, NB), *tpts, NB, BLOCK)
    return d, tpts, partials, captured["sums"], window


def test_bucket_sums_match_jax(one_round):
    _, _, partials, jsums, _ = one_round
    sums = msm_kernels.plain_bucket_sums(partials, NB)
    assert _same(JacobianPoints(sums.x[:, 0], sums.y[:, 0], sums.z[:, 0], sums.inf[0]), jsums)
    # the cancelling bucket is at infinity, the doubled one is not
    assert bool(sums.inf[0, 1]) and not bool(sums.inf[0, 0])


def test_bucket_reduce_matches_jax_window(one_round):
    _, _, partials, _, jwindow = one_round
    assert _same(msm_kernels.plain_bucket_reduce(partials, NB), jwindow)
    assert _same(msm_kernels.bucket_reduce(partials, NB), jwindow)  # a CPU batch takes the plain version


def test_partials_layout_is_the_kernels(one_round):
    """The compacted layout K3a writes: block b's runs from slot offsets[b]
    on (the prefix count of the runs of the blocks before it), in order,
    then bucket NB at infinity with zero coordinates."""
    d, tpts, partials, _, _ = one_round
    entries = msm_kernels.sort_rounds(d, NB)
    sb = entries.bucket.reshape(M // BLOCK, BLOCK)
    runs = [torch.unique_consecutive(row) for row in sb]
    want = torch.cat(runs)
    emitted = want.shape[0]
    k = msm_kernels.partial_slots(NB, M // BLOCK, BLOCK)
    assert emitted <= k and partials.bucket.shape == (1, k)
    assert torch.equal(partials.bucket[0, :emitted].to(torch.int64), want)
    assert bool((partials.bucket[0, emitted:] == NB).all())
    filler = torch.arange(k) >= emitted
    assert bool(partials.points.inf[filler].all())
    assert all(bool((c[:, filler] == 0).all()) for c in partials.points[:3])
    # the kernel's dead partials are at infinity too; live ones sum live entries
    assert bool(partials.points.inf[partials.bucket[0] == NB].all())
    # the per-block first slots the CUDA launch computes
    counts = torch.tensor([r.shape[0] for r in runs])
    assert torch.equal(msm_kernels.block_offsets(entries, BLOCK)[0].to(torch.int64), counts.cumsum(0) - counts)
    # and its point table: 30-bit words of the 15-bit limbs
    words = msm_kernels.point_table(tpts.x, tpts.y, tpts.inf)
    x30 = sum(int(words[5, k]) << (30 * k) for k in range(9))
    assert x30 == sum(int(tpts.x[k, 5]) << (15 * k) for k in range(18))
    assert torch.equal(words[:, 18], tpts.inf.to(torch.int32))


# ---------------------------------------------------------------------------
# the rounds-batched Pippenger against the per-round path and the host oracle
# ---------------------------------------------------------------------------
C, PBLOCK = 8, 8


def _per_round(scalars_mont, points):
    """Pippenger with one sort / walk / reduction per round (the schedule
    the batched one replaces), Horner-combined MSB first. Returns the
    windows (18, R) and the result."""
    g1 = tg1("cpu")
    digits, px, py, pinf = glv_entries(scalars_mont, points, C, PBLOCK)
    wins = []
    for r in range(digits.shape[0]):
        entries = msm_kernels.sort_rounds(digits[r : r + 1], 1 << (C - 1))
        partials = msm_kernels.bucket_accumulate(entries, px, py, pinf, 1 << (C - 1), PBLOCK)
        wins.append(msm_kernels.bucket_reduce(partials, 1 << (C - 1)))
    acc = g1.infinity(1)
    for w in reversed(wins):
        for _ in range(C):
            acc = g1.dbl(acc)
        acc = g1.add(acc, w)
    windows = JacobianPoints(*(torch.cat([getattr(w, f) for w in wins], dim=-1) for f in ("x", "y", "z", "inf")))
    return windows, acc


def _batched_windows(scalars_mont, points):
    digits, px, py, pinf = glv_entries(scalars_mont, points, C, PBLOCK)
    entries = msm_kernels.sort_rounds(digits, 1 << (C - 1))
    return msm_kernels.bucket_reduce(
        msm_kernels.bucket_accumulate(entries, px, py, pinf, 1 << (C - 1), PBLOCK), 1 << (C - 1)
    )


def _edge_case(case: str, rng):
    n = 8
    pts = _host_points(rng, n)
    scalars = [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS for _ in range(n)]
    if case == "equal_scalars":  # one bucket spans every block of a round
        scalars = [scalars[0]] * n
    elif case == "zero_rounds":  # small scalars: the upper rounds' digits are all zero
        scalars = [5] * (n // 2) + [7] * (n // 2)
    elif case == "doubled_point":  # P twice in one bucket: P == Q mid-walk
        pts[1], scalars[1] = pts[0], scalars[0]
    elif case == "negated_point":  # P and -P in one bucket: they cancel
        pts[1], scalars[1] = host_curve.g1_neg(pts[0]), scalars[0]
    elif case == "padded":  # 2N = 14 entries, not a multiple of the block
        pts, scalars = pts[:7], scalars[:7]
    return pts, scalars


@pytest.mark.parametrize("case", ["equal_scalars", "zero_rounds", "doubled_point", "negated_point", "padded"])
def test_batched_pippenger_matches_per_round_and_host(case):
    rng = np.random.default_rng(["equal_scalars", "zero_rounds", "doubled_point", "negated_point", "padded"].index(case))
    pts, scalars = _edge_case(case, rng)
    points = host_to_affine_points(pts, device="cpu")
    s = tfr("cpu").encode(scalars)
    windows, per_round = _per_round(s, points)
    assert all(torch.equal(a, b) for a, b in zip(_batched_windows(s, points), windows))
    got = pippenger(s, points, c=C, block=PBLOCK)
    assert all(torch.equal(a, b) for a, b in zip(got, per_round))
    assert jacobian_to_host(got) == [host_curve.g1_msm(pts, scalars)]
    if case == "zero_rounds":
        assert bool(windows.inf[1:].all())
