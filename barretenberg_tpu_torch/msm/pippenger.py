"""Pippenger multi-scalar multiplication, with GLV + signed windows.

The bucketed MSM of the reference (scalar_multiplication.cpp, and the
bucket-ordered design of its pippenger.md) laid out for a machine with wide
lanes and no scatter-accumulate:

  0. every scalar is GLV-split on the device into two 128-bit halves
     and its signed digits taken (K4 glv_digits); every point is paired
     with its endomorphism image (beta*x, -y); digits are signed c-bit
     windows, so a round has 2^(c-1) buckets and there are ceil(128/c)+1
     rounds over 2N entries;
  for all rounds of all B MSMs of a call at once:
    1. one batched stable sort of each round's entries by bucket =
       |digit| - 1 (kernels/msm_kernels.py::sort_rounds); an entry with a
       negative digit adds -P;
    2. K3a bucket_accumulate: the sorted entries of a round are cut into
       blocks of `block` (for the precomputed table, by default chosen per
       call so that the walks fill the card), and one thread per (round,
       block) walks its block,
       summing runs of equal buckets with mixed adds; runs that span block
       boundaries emit partial sums, compacted per round; all B x R rounds
       walk one point table of 2N rows;
    3. K3b-wide bucket_reduce_wide, each round one bucket set: clusters of
       CTAs merge each bucket's partials (the segmented scan's sums),
       scatter the bucket sums S_m and turn them into the window sum
       sum_m (m+1) S_m with two suffix scans (K3b, one CTA per round, is
       the same function);
  4. K3c window_combine: each MSM's windows combine MSB-first, c doublings
     and one add per round (the Horner chain), a group of 8 lanes per MSM
     in one launch.

The rounds, and the MSMs, are independent until step 4, so batching them
changes no coordinate: each round's window is the JAX package's per-round
`_accumulate_window` limb for limb, and each MSM the JAX package's
non-fused `pippenger` of its scalar vector.

The precomputed-table schedule (`pippenger_precomputed`, the JAX package's
`msm/pippenger.py:431-534`) commits against a fixed point set through a
table whose row r holds 2^(rc) P (K3f `table_rows` + one batched
normalisation): every round's entries then fall into ONE bucket set of
2^(c-1) buckets, so there is no Horner combine and the set's window sum is
the MSM. The table also keeps each entry's endomorphism image, the padding
to a multiple of the block and the K3a row layout, so a commitment computes
only its digits, one stable sort, K3a and K3b-wide `bucket_reduce_wide`; B
commitments are B bucket sets of one launch each. `pippenger_low_memory`
runs fixed-size chunks and adds their sums (always the rounds-batched
schedule, as the JAX package's does). Every commitment is normalised to
affine before it enters a proof, so proof bytes do not depend on the
schedule.

The fused schedule (`_pippenger_fused_impl`, the JAX package's
`msm/pippenger.py:309-399`), which the JAX package runs by default up to
FUSED_MAX_N points: every (round, entry) pair of a vector is one entry of
ONE bucket set of R * 2^(c-1) buckets, bucket r * 2^(c-1) + |d| - 1. K4
writes the digits with their rounds folded in (``round_offset``), one
stable sort orders all R * 2N entries, K3a walks them in blocks of the JAX
package's ``min(block, max(16, 2N))`` (where the blocks fall fixes the
partials, so the block is never the precomputed route's
``accumulate_block``), K3b-wide merges the one set and suffix-scans it in
segments of 2^(c-1) that no add crosses, one window per round, and K3c
combines the windows. B vectors are B sets of the same five launches, each
set's coordinates the JAX package's per-vector ``pippenger(fused=True)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..fields import fq as _fq, fr as _fr
from ..groups import AffinePoints, JacobianPoints
from ..groups.g1 import g1 as _g1
from ..kernels import msm_kernels, point_kernels
from .wnaf import window

SCALAR_BITS = 254

# msm / batched_msm run the naive MSM below MSM_PIPPENGER_THRESHOLD points
# (msm/naive.py) and Pippenger from there: by default the fused schedule up
# to FUSED_MAX_N (the JAX package's cutover), the rounds-batched one above.
# Below the threshold pippenger() keeps the rounds-batched schedule unless
# asked (the JAX package's pippenger() is fused there; no entry point
# reaches it there).
MSM_PIPPENGER_THRESHOLD = 4096
FUSED_MAX_N = 1 << 15


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


def endo_points(points: AffinePoints):
    """The 2N entry points of an MSM over N points: each point, then its
    endomorphism image (beta x, -y), as px, py (18, 2N) and pinf (2N,)."""
    fq = _fq(points.x.device)
    px = torch.cat([points.x, fq.mul_by_constant(points.x, fq.params.cube_root)], dim=1)
    py = torch.cat([points.y, fq.neg(points.y)], dim=1)
    return px, py, torch.cat([points.inf, points.inf], dim=0)


def glv_entries(scalars_mont: torch.Tensor, points: AffinePoints, c: int, block: int, sets: int = 1):
    """The MSM's bucket entries: GLV split + endo point table,
    k*P = k1*P + k2*(beta*x, -y). ``scalars_mont``: (18, sets * N), the
    ``sets`` scalar vectors of one call side by side, over one point set of
    N. Returns signed digits (sets * R, M) int32 (row s * R + r: vector s's
    round r), the entries' affine coordinates px, py (18, M) and pinf (M,),
    with M = 2N padded to a multiple of `block` by dead entries."""
    n = points.x.shape[1]
    rounds = msm_kernels.digit_rounds(c)
    digits = msm_kernels.glv_digits(scalars_mont, sets, c, rounds * 2 * n).reshape(sets * rounds, 2 * n)
    px, py, pinf = endo_points(points)
    m_total = digits.shape[1]
    pad = -(-m_total // block) * block - m_total
    if pad:
        digits = F.pad(digits, (0, pad))
        px, py = F.pad(px, (0, pad)), F.pad(py, (0, pad))
        pinf = F.pad(pinf, (0, pad), value=True)
    return digits, px, py, pinf


def _pippenger_impl(
    scalars_mont: torch.Tensor, points: AffinePoints, c: int, block: int, sets: int = 1
) -> JacobianPoints:
    """``sets`` MSMs over one point set (scalars (18, sets * N)) as one
    launch set: K4, one sort, K3a, K3b-wide, K3c. Returns (sets,)."""
    digits, px, py, pinf = glv_entries(scalars_mont, points, c, block, sets)
    nbuckets = 1 << (c - 1)
    entries = msm_kernels.sort_rounds(digits, nbuckets)
    partials = msm_kernels.bucket_accumulate(entries, px, py, pinf, nbuckets, block)
    windows = msm_kernels.bucket_reduce_wide(partials, nbuckets)  # lane s * R + r: MSM s's round r
    return msm_kernels.window_combine(windows, c, sets)


def _pippenger_fused_impl(
    scalars_mont: torch.Tensor, points: AffinePoints, c: int, block: int, sets: int = 1
) -> JacobianPoints:
    """``sets`` MSMs over one point set (scalars (18, sets * N)) by the
    fused schedule, one set of R * 2^(c-1) buckets per vector: K4 (digits
    with their rounds folded in), one sort, K3a, K3b-wide (per-round
    segments), K3c. Returns (sets,)."""
    n = points.x.shape[1]
    rounds = msm_kernels.digit_rounds(c)
    nbuckets = 1 << (c - 1)
    nb_total = rounds * nbuckets
    m = -(-rounds * 2 * n // block) * block  # entry r * 2N + i: round r, point i
    digits = msm_kernels.glv_digits(scalars_mont, sets, c, m, round_offset=nbuckets)
    entries = msm_kernels.sort_rounds(digits, nb_total)
    entries = entries._replace(order=entries.order % (2 * n))  # each entry's point
    partials = msm_kernels.bucket_accumulate(entries, *endo_points(points), nb_total, block)
    windows = msm_kernels.bucket_reduce_wide(partials, nb_total, segment=nbuckets)  # lane s * R + r
    return msm_kernels.window_combine(windows, c, sets)


def pippenger_batch(
    scalars_list,
    points: AffinePoints,
    c: int | None = None,
    block: int = 128,
    fused: bool | None = None,
) -> JacobianPoints:
    """B MSMs over one point set, sum_i scalars_b[i] * points[i] for each of
    the B (18, N) scalar vectors, as one launch set for all B: one K4, one
    sort, one K3a, one K3b-wide and one K3c. Returns a (B,) JacobianPoints
    batch, each the JAX package's ``pippenger`` of its vector, coordinate for
    coordinate: by the fused schedule (``fused``; by default for
    MSM_PIPPENGER_THRESHOLD <= N <= FUSED_MAX_N) or else the rounds-batched one (the JAX package's
    non-fused ``pippenger``)."""
    n = scalars_list[0].shape[1]
    if c is None:
        c = optimal_window(n)
    block = min(block, max(16, 2 * n))
    if fused is None:
        fused = MSM_PIPPENGER_THRESHOLD <= n <= FUSED_MAX_N
    scalars = scalars_list[0] if len(scalars_list) == 1 else torch.cat(list(scalars_list), dim=1)
    impl = _pippenger_fused_impl if fused else _pippenger_impl
    return impl(scalars, points, c, block, len(scalars_list))


def pippenger(
    scalars_mont: torch.Tensor,
    points: AffinePoints,
    c: int | None = None,
    block: int = 128,
    fused: bool | None = None,
) -> JacobianPoints:
    """MSM: sum_i scalars[i] * points[i] -> JacobianPoints batch (1,).

    scalars_mont: (18, N) internal-Montgomery Fr values. points: affine
    batch (N). ``fused``: the schedule (``pippenger_batch``). Runs on the
    device the tensors lie on."""
    return pippenger_batch([scalars_mont], points, c, block, fused)


class PippengerPointTable:
    """Per-round shifted point table for a fixed point set: row r holds
    2^(rc) P_i. Kept as the entries a commitment walks, as K3a's
    ``point_table`` rows: round r's entries r * 2n + i are row r's point i
    (i < n) and its endomorphism image (beta x, -y) (i >= n), followed by
    dead entries up to a multiple of ``block``."""

    def __init__(self, rows: torch.Tensor, c: int, rounds: int, n: int):
        self.rows = rows  # (>= rounds * 2n, ROW_WORDS) int32
        self.c, self.rounds, self.n = c, rounds, n

    def affine(self) -> AffinePoints:
        """The table rows as the JAX package's layout: (18, rounds * n),
        row r at lanes [r n, (r + 1) n)."""
        idx = torch.arange(self.rounds * self.n, device=self.rows.device)
        idx = idx + (idx // self.n) * self.n  # skip each round's endomorphism images
        return point_kernels.row_points(self.rows.index_select(0, idx))

    def entries(self, block: int) -> torch.Tensor:
        """The entry rows padded to a multiple of ``block`` (dead entries:
        infinity, zero coordinates)."""
        m = self.rounds * 2 * self.n
        need = -(-m // block) * block
        have = self.rows.shape[0]
        if have >= need:
            return self.rows[:need]
        zero = torch.zeros((18, need - have), dtype=torch.int32, device=self.rows.device)
        dead = torch.ones(need - have, dtype=torch.bool, device=self.rows.device)
        return torch.cat([self.rows, point_kernels.point_table(zero, zero, dead)])


def generate_pippenger_point_table(points: AffinePoints, c: int | None = None) -> PippengerPointTable:
    """The shifted table: rows 1 .. R-1 from one K3f launch (c doublings per
    row), normalised to affine in one batched normalisation, then each
    row's endomorphism images and the K3a row layout, padded for
    ``pippenger_precomputed``'s default block of 128."""
    n = points.x.shape[1]
    if c is None:
        c = optimal_window(n)
    rounds = msm_kernels.digit_rounds(c)
    dev = points.x.device
    aff = _g1(dev).batch_normalize(point_kernels.table_rows(points, rounds, c))
    x = torch.cat([points.x, aff.x], dim=1).reshape(18, rounds, n)
    y = torch.cat([points.y, aff.y], dim=1).reshape(18, rounds, n)
    inf = torch.cat([points.inf, aff.inf]).reshape(rounds, n)
    fq = _fq(dev)
    m = rounds * 2 * n
    pad = -(-m // 128) * 128 - m
    px = F.pad(torch.cat([x, fq.mul_by_constant(x, fq.params.cube_root)], dim=2).reshape(18, m), (0, pad))
    py = F.pad(torch.cat([y, fq.neg(y)], dim=2).reshape(18, m), (0, pad))
    pinf = F.pad(torch.cat([inf, inf], dim=1).reshape(m), (0, pad), value=True)
    return PippengerPointTable(point_kernels.point_table(px, py, pinf), c, rounds, n)


def precomputed_digits(scalars_list, c: int, m: int) -> torch.Tensor:
    """B scalar vectors (18, N) -> (B, m) signed digits of the table's
    entries: round r's N digits of the first GLV half, then its N of the
    second, rounds one after another (the JAX package's [d1 | d2] per
    round), zero beyond."""
    scalars = scalars_list[0] if len(scalars_list) == 1 else torch.cat(list(scalars_list), dim=1)
    return msm_kernels.glv_digits(scalars, len(scalars_list), c, m)


def pippenger_precomputed_batch(
    scalars_list, table: PippengerPointTable, block: int | None = None
) -> JacobianPoints:
    """B MSMs against one precomputed table as B bucket sets: one sort, one
    K3a and one K3b-wide launch. Returns a (B,) JacobianPoints batch.
    ``block``: K3a's walk length; by default the one that fills the card
    for this call's B * rounds * 2N entries (``accumulate_block``)."""
    if block is None:
        capacity = msm_kernels.accumulate_capacity(table.rows.device)
        block = msm_kernels.accumulate_block(len(scalars_list) * table.rounds * 2 * table.n, capacity)
    rows = table.entries(block)
    nbuckets = 1 << (table.c - 1)
    entries = msm_kernels.sort_rounds(precomputed_digits(scalars_list, table.c, rows.shape[0]), nbuckets)
    partials = msm_kernels.bucket_accumulate_rows(entries, rows, nbuckets, block)
    return msm_kernels.bucket_reduce_wide(partials, nbuckets)


def pippenger_precomputed(
    scalars_mont: torch.Tensor, table: PippengerPointTable, block: int | None = None
) -> JacobianPoints:
    """MSM against a precomputed table: all rounds share one bucket set.
    Returns a JacobianPoints batch (1,)."""
    return pippenger_precomputed_batch([scalars_mont], table, block)


def pippenger_low_memory(
    scalars_mont: torch.Tensor,
    points: AffinePoints,
    chunk: int = 1 << 16,
    c: int | None = None,
) -> JacobianPoints:
    """Chunked MSM with bounded peak memory: fixed-size chunks (the last
    padded with zero scalars and points at infinity, so every chunk has one
    shape), their sums added in order."""
    n = scalars_mont.shape[1]
    if n <= chunk:
        return pippenger(scalars_mont, points, c=c)
    if c is None:
        c = optimal_window(chunk)
    g1 = _g1(scalars_mont.device)
    acc = None
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        pad = chunk - (hi - lo)
        s = F.pad(scalars_mont[:, lo:hi], (0, pad))
        p = AffinePoints(
            F.pad(points.x[:, lo:hi], (0, pad)),
            F.pad(points.y[:, lo:hi], (0, pad)),
            F.pad(points.inf[lo:hi], (0, pad), value=True),
        )
        part = _pippenger_impl(s, p, c, 128)
        acc = part if acc is None else g1.add(acc, part)
    return acc
