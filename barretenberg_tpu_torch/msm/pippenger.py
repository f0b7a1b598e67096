"""Pippenger multi-scalar multiplication, with GLV + signed windows.

The bucketed MSM of the reference (scalar_multiplication.cpp, and the
bucket-ordered design of its pippenger.md) laid out for a machine with wide
lanes and no scatter-accumulate:

  0. every scalar is GLV-split on the device into two 128-bit halves
     (msm/wnaf.py) and every point is paired with its endomorphism image
     (beta*x, -y); digits are signed c-bit windows, so a round has 2^(c-1)
     buckets and there are ceil(128/c)+1 rounds over 2N entries;
  for all rounds at once:
    1. one batched stable sort of each round's entries by bucket =
       |digit| - 1 (kernels/msm_kernels.py::sort_rounds); an entry with a
       negative digit adds -P;
    2. K3a bucket_accumulate: the sorted entries of a round are cut into
       blocks of `block`, and one thread per (round, block) walks its block,
       summing runs of equal buckets with mixed adds; runs that span block
       boundaries emit partial sums, compacted per round;
    3. K3b bucket_reduce: one CTA per round merges each bucket's partials
       with a Kogge-Stone segmented scan (log depth), scatters the bucket
       sums S_m and turns them into the window sum sum_m (m+1) S_m with
       two suffix scans;
  4. K3c window_combine: the windows combine MSB-first, c doublings and
     one add per round (the Horner chain), on one thread in one launch.

The rounds are independent until step 4, so batching them changes no
coordinate: each round's window is the JAX package's per-round
`_accumulate_window` limb for limb. The fused single-sort, precomputed-table
and low-memory schedules of the JAX package are not ported yet. Every
commitment is normalised to affine before it enters a proof, so proof bytes
do not depend on the schedule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..fields import fq as _fq, fr as _fr
from ..groups import AffinePoints, JacobianPoints
from ..kernels import msm_kernels
from .wnaf import signed_digits, split_scalars, window

SCALAR_BITS = 254


def scalar_digits(scalars_mont: torch.Tensor, c: int) -> torch.Tensor:
    """Internal-Montgomery Fr scalars (18, N) -> (rounds, N) int64 c-bit
    unsigned window digits of the canonical integer value, LSB window first."""
    value = _fr(scalars_mont.device).to_plain(scalars_mont)
    limbs = F.pad(value, (0, 0, 0, 2))
    rounds = -(-SCALAR_BITS // c)
    return torch.stack([window(limbs, r * c, c) for r in range(rounds)])


def optimal_window(n: int) -> int:
    """Window width heuristic (sort-dominated rounds favour small tables)."""
    if n <= 1 << 12:
        return 8
    if n <= 1 << 16:
        return 10
    return 13


def glv_entries(scalars_mont: torch.Tensor, points: AffinePoints, c: int, block: int):
    """The MSM's bucket entries: GLV split + endo point table,
    k*P = k1*P + k2*(beta*x, -y). Returns signed digits (R, M) int32, the
    entries' affine coordinates px, py (18, M) and pinf (M,), with M = 2N
    padded to a multiple of `block` by dead entries."""
    fq = _fq(scalars_mont.device)
    k1, k2 = split_scalars(scalars_mont)
    digits = torch.cat([signed_digits(k1, c), signed_digits(k2, c)], dim=1)
    beta_x = fq.mul_by_constant(points.x, fq.params.cube_root)
    px = torch.cat([points.x, beta_x], dim=1)
    py = torch.cat([points.y, fq.neg(points.y)], dim=1)
    pinf = torch.cat([points.inf, points.inf], dim=0)
    m_total = digits.shape[1]
    pad = -(-m_total // block) * block - m_total
    if pad:
        digits = F.pad(digits, (0, pad))
        px, py = F.pad(px, (0, pad)), F.pad(py, (0, pad))
        pinf = F.pad(pinf, (0, pad), value=True)
    return digits, px, py, pinf


def _pippenger_impl(
    scalars_mont: torch.Tensor, points: AffinePoints, c: int, block: int
) -> JacobianPoints:
    digits, px, py, pinf = glv_entries(scalars_mont, points, c, block)
    nbuckets = 1 << (c - 1)
    entries = msm_kernels.sort_rounds(digits, nbuckets)
    partials = msm_kernels.bucket_accumulate(entries, px, py, pinf, nbuckets, block)
    windows = msm_kernels.bucket_reduce(partials, nbuckets)  # lane r: round r's window
    return msm_kernels.window_combine(windows, c)


def pippenger(
    scalars_mont: torch.Tensor,
    points: AffinePoints,
    c: int | None = None,
    block: int = 128,
) -> JacobianPoints:
    """MSM: sum_i scalars[i] * points[i] -> JacobianPoints batch (1,).

    scalars_mont: (18, N) internal-Montgomery Fr values. points: affine
    batch (N). Runs on the device the tensors lie on."""
    n = scalars_mont.shape[1]
    if c is None:
        c = optimal_window(n)
    block = min(block, max(16, 2 * n))
    return _pippenger_impl(scalars_mont, points, c, block)
