"""Pippenger multi-scalar multiplication, with GLV + signed windows.

The bucketed MSM of the reference (scalar_multiplication.cpp, and the
bucket-ordered design of its pippenger.md) laid out for a machine with wide
lanes and no scatter-accumulate:

  0. every scalar is GLV-split on the device into two 128-bit halves
     (msm/wnaf.py) and every point is paired with its endomorphism image
     (beta*x, -y); digits are signed c-bit windows, so a round has 2^(c-1)
     buckets and there are ceil(128/c)+1 rounds over 2N entries;
  per round (MSB-first):
    1. stable-sort entry indices by bucket = |digit| - 1, with per-entry
       conditional negation for digit < 0;
    2. accumulate equal-bucket runs with a *block-sequential segment scan*:
       sorted entries are reshaped to (blocks, C) and a Python loop walks the
       C columns - one mixed-add launch per column, every block advancing in
       lockstep;
    3. runs that span block boundaries emit partial sums; the emitted
       partials are compacted by a key sort and merged with a Kogge-Stone
       segmented scan (log depth);
    4. bucket sums -> window sum via the running-sum identity
       sum_m m*S_m = sum of suffix sums, computed with log-depth scans;
    5. windows combine MSB-first with c doublings per round.

This is the per-round schedule only; the fused single-sort,
precomputed-table and low-memory schedules of the JAX package are not ported
yet. Every commitment is normalised to affine before it enters a proof, so
proof bytes do not depend on the schedule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..fields import fq as _fq, fr as _fr
from ..fields.params import NUM_LIMBS
from ..groups import AffinePoints, JacobianPoints
from ..groups.g1 import g1 as _g1
from ..groups.group import take_jacobian
from .wnaf import signed_digits, split_scalars, window

SCALAR_BITS = 254


def scalar_digits(scalars_mont: torch.Tensor, c: int) -> torch.Tensor:
    """Internal-Montgomery Fr scalars (18, N) -> (rounds, N) int64 c-bit
    unsigned window digits of the canonical integer value, LSB window first
    (used by the naive double-and-add oracle)."""
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


def _shift_points(pts: JacobianPoints, d: int, dead: torch.Tensor) -> JacobianPoints:
    """Lane i takes lane i-d (d > 0) or i+|d| (d < 0); lanes marked `dead`
    (no source lane) become infinity."""
    return JacobianPoints(
        torch.roll(pts.x, d, dims=1),
        torch.roll(pts.y, d, dims=1),
        torch.roll(pts.z, d, dims=1),
        torch.roll(pts.inf, d, dims=0) | dead,
    )


def _ks_segmented_scan(points: JacobianPoints, starts: torch.Tensor, n: int):
    """Kogge-Stone inclusive segmented scan of group adds along the batch
    axis. starts: bool (n,), True at segment starts. Returns scanned points."""
    g1 = _g1(points.x.device)
    idx = torch.arange(n, device=points.x.device)
    pts, fl = points, starts
    for i in range(max(1, (n - 1).bit_length())):
        d = 1 << i
        valid = idx >= d
        shifted = _shift_points(pts, d, ~valid)
        sh_fl = torch.roll(fl, d, dims=0) & valid
        summed = g1.add(pts, shifted)
        keep = fl | ~valid  # at segment start (or out of range) keep own value
        pts = g1.select_points(keep, pts, summed)
        fl = fl | sh_fl
    return pts


def _suffix_scan_points(points: JacobianPoints, n: int) -> JacobianPoints:
    """Inclusive suffix scan (out[i] = sum_{j>=i} in[j]) of group adds."""
    g1 = _g1(points.x.device)
    idx = torch.arange(n, device=points.x.device)
    pts = points
    for i in range(max(1, (n - 1).bit_length())):
        d = 1 << i
        pts = g1.add(pts, _shift_points(pts, -d, idx >= n - d))
    return pts


def _bucket_sums(
    bucket_idx: torch.Tensor, pts: AffinePoints, nbuckets: int, block: int
) -> JacobianPoints:
    """Segment-accumulate entries into per-bucket sums.

    bucket_idx: (M,) int64, == nbuckets for dead entries. pts: (M,) affine.
    M must be a multiple of block. Returns a JacobianPoints batch (nbuckets,).
    """
    g1 = _g1(pts.x.device)
    dev = pts.x.device
    m_total = bucket_idx.shape[0]
    nblocks = m_total // block
    k_partials = min(nbuckets + nblocks, nblocks * (block + 1))

    # stable: the order of additions inside a bucket fixes the Jacobian
    # coordinates of its sum (not the point), and the JAX package's sort is
    # stable - keeping it so makes the coordinates comparable limb for limb
    order = torch.argsort(bucket_idx, stable=True)
    ds = bucket_idx.index_select(0, order)
    spts = g1.take_affine(pts, order)

    # ---- phase A: block-sequential segment accumulation -------------
    # column-major copies, so that step j reads contiguous (18, nblocks) rows
    ds_cols = ds.reshape(nblocks, block).t().contiguous()
    px = spts.x.reshape(NUM_LIMBS, nblocks, block).permute(2, 0, 1).contiguous()
    py = spts.y.reshape(NUM_LIMBS, nblocks, block).permute(2, 0, 1).contiguous()
    pinf = spts.inf.reshape(nblocks, block).t().contiguous()
    one = g1.f.full((nblocks,), g1.f.one)

    acc = g1.infinity(nblocks)
    cur_d = ds_cols[0]
    em_f, em_d, em_p = [], [], []
    for j in range(block):
        dj = ds_cols[j]
        aff = AffinePoints(px[j], py[j], pinf[j])
        same = dj == cur_d
        em_f.append(~same)
        em_d.append(cur_d)
        em_p.append(acc)
        fresh = JacobianPoints(aff.x, aff.y, one, aff.inf)
        acc = g1.select_points(same, g1.mixed_add(acc, aff), fresh)
        cur_d = dj
    # the final segment of each block
    em_f.append(torch.ones(nblocks, dtype=torch.bool, device=dev))
    em_d.append(cur_d)
    em_p.append(acc)
    # flatten block-major so digits stay globally sorted
    steps = block + 1
    em_f = torch.stack(em_f, dim=1).reshape(nblocks * steps)
    em_d = torch.stack(em_d, dim=1).reshape(nblocks * steps)
    em_p = JacobianPoints(
        torch.stack([p.x for p in em_p], dim=2).reshape(NUM_LIMBS, nblocks * steps),
        torch.stack([p.y for p in em_p], dim=2).reshape(NUM_LIMBS, nblocks * steps),
        torch.stack([p.z for p in em_p], dim=2).reshape(NUM_LIMBS, nblocks * steps),
        torch.stack([p.inf for p in em_p], dim=1).reshape(nblocks * steps),
    )

    # ---- compaction: emitted entries to the front, keep order -------
    pos = torch.arange(nblocks * steps, device=dev)
    key = torch.where(em_f, pos, pos | (1 << 30))
    corder = torch.argsort(key, stable=True)[:k_partials]
    cd = torch.where(em_f.index_select(0, corder), em_d.index_select(0, corder), nbuckets)
    cp = take_jacobian(em_p, corder)
    cp = JacobianPoints(cp.x, cp.y, cp.z, cp.inf | (cd == nbuckets))

    # ---- phase B: merge equal-bucket partials (log depth) ------------
    starts = torch.ones_like(em_f[:k_partials])
    starts[1:] = cd[1:] != cd[:-1]
    merged = _ks_segmented_scan(cp, starts, k_partials)
    is_end = torch.ones_like(starts)
    is_end[:-1] = cd[:-1] != cd[1:]

    # ---- scatter bucket sums ------------------------------------------
    # Only the dump slot `nbuckets` can receive more than one write (every
    # dead lane lands there; which write wins is unspecified on CUDA); it is
    # sliced off below, and each live bucket has exactly one segment end.
    live = is_end & (cd < nbuckets)
    bidx = torch.where(live, cd, nbuckets)
    binit = g1.infinity(nbuckets + 1)
    buckets = JacobianPoints(
        binit.x.index_copy(1, bidx, merged.x),
        binit.y.index_copy(1, bidx, merged.y),
        binit.z.index_copy(1, bidx, merged.z),
        binit.inf.index_copy(0, bidx, merged.inf | ~live),
    )
    return JacobianPoints(
        buckets.x[:, :nbuckets], buckets.y[:, :nbuckets],
        buckets.z[:, :nbuckets], buckets.inf[:nbuckets],
    )


def _accumulate_window(
    bucket_idx: torch.Tensor, pts: AffinePoints, nbuckets: int, block: int
) -> JacobianPoints:
    """One Pippenger round body: bucket sums -> window sum sum_m (m+1)*S_m
    via the double-suffix-scan identity."""
    buckets = _bucket_sums(bucket_idx, pts, nbuckets, block)
    suffix = _suffix_scan_points(buckets, nbuckets)
    total = _suffix_scan_points(suffix, nbuckets)
    return JacobianPoints(total.x[:, :1], total.y[:, :1], total.z[:, :1], total.inf[:1])


def _pippenger_impl(
    scalars_mont: torch.Tensor, points: AffinePoints, c: int, block: int
) -> JacobianPoints:
    dev = scalars_mont.device
    fq, g1 = _fq(dev), _g1(dev)
    n = scalars_mont.shape[1]
    # GLV split + endo point table: k*P = k1*P + k2*(beta*x, -y)
    k1, k2 = split_scalars(scalars_mont)
    digits = torch.cat([signed_digits(k1, c), signed_digits(k2, c)], dim=1)  # (R, 2N)
    beta_x = fq.mul_by_constant(points.x, fq.params.cube_root)
    px = torch.cat([points.x, beta_x], dim=1)
    py = torch.cat([points.y, fq.neg(points.y)], dim=1)
    pinf = torch.cat([points.inf, points.inf], dim=0)
    neg_py = fq.neg(py)

    m_total = 2 * n
    pad = -(-m_total // block) * block - m_total
    if pad:
        digits = F.pad(digits, (0, pad))
        px, py, neg_py = F.pad(px, (0, pad)), F.pad(py, (0, pad)), F.pad(neg_py, (0, pad))
        pinf = F.pad(pinf, (0, pad), value=True)

    rounds = digits.shape[0]
    nbuckets = 1 << (c - 1)
    acc = g1.infinity(1)
    for r in range(rounds):
        d = digits[rounds - 1 - r].to(torch.int64)
        mag = d.abs()
        bucket = torch.where(mag == 0, nbuckets, mag - 1)
        pts = AffinePoints(
            px, torch.where((d < 0).unsqueeze(0), neg_py, py), pinf | (mag == 0)
        )
        win = _accumulate_window(bucket, pts, nbuckets, block)
        for _ in range(c):
            acc = g1.dbl(acc)
        acc = g1.add(acc, win)
    return acc


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
