"""K3a ``bucket_accumulate`` and K3b ``bucket_reduce``: the bucket phase of
Pippenger's MSM for every round at once, one launch each per MSM; K3b-wide
``bucket_reduce_wide``: K3b's function spread over clusters of CTAs, for
bucket sets too large for one CTA (the precomputed-table MSM's, all rounds
in one set) and for the rounds-batched MSM's rounds, one set each, in place
of K3b; K3c ``window_combine``: the Horner combine of the rounds' window
sums, a group of 8 lanes per MSM, the MSMs of a commit call in one launch.

Replace the two scans of the JAX package's per-round Pippenger whose bodies
are its Pallas point kernel (``kernels/point_kernels.py:179``
``_kernel_fn``):

- K3a, the block-sequential segment scan of mixed adds
  (``msm/pippenger.py:178-193``, a ``lax.scan`` over the block's columns)
  and the argsort compaction of the partial sums it emits (``:214-222``);
- K3b, the Kogge-Stone merge of those partials (``:82``
  ``_ks_segmented_scan``), their scatter into bucket slots (``:232-241``)
  and the two suffix scans (``:107`` ``_suffix_scan_points``) that turn
  bucket sums S_m into the window sum sum_m (m+1) S_m;
- K3c, the Horner ``fori_loop`` over the rounds (``:287-305``): c point
  doublings of the running sum and one add of the round's window per round,
  most significant round first.

Source: ``csrc/msm_kernels.cu`` (+ ``csrc/point.cuh``, ``csrc/field.cuh``).

What bounds them on the card: operations - a mixed add is 11 field
multiplications (3,762 32-bit multiply-adds) on 80 bytes of input, an add 16.
What holds them back is parallelism and dependence: K3a's walks are
sequential chains of ``block`` dependent mixed adds, one thread each
(14 rounds x 1024 blocks = 14,336 threads for a 2^16-point MSM), and K3b's
levels are separated by barriers, one CTA per round. What the design does
about it: all rounds run in one launch, so every walk of the MSM is in
flight at once; each walk's sum stays in registers and the next entry's
point-table row (80 bytes, four 16-byte loads, through the sort permutation)
is loaded while the current one computes; the precomputed-table MSM
picks the walk length per call
(``accumulate_block``: the longest block whose walks still fill the card,
from CUDA's occupancy query), since at 2^11 points a block of 128 leaves
most SMs idle; an entry at infinity or of a
zero digit costs no arithmetic; emitted partials are written straight to
their compacted slot; K3b skips the adds whose result its scan discards and
computes the second suffix scan only for the lanes that feed the window sum.

K3b-wide replaces the same scans (``:82`` and ``:107``) where the JAX
package runs them once over the precomputed-table MSM's one bucket set
(``msm/pippenger.py:517`` ``_accumulate_window``): 14,848 partials at 2^16
points, ten times a round's, which on one CTA would take ten times as long.
What the design does about it: the set's partials are cut at bucket
boundaries into ranges of ``range_buckets`` buckets, one cluster of eight
CTAs each (a bucket is never split); since no add of the segmented scan
crosses a segment start, a range that starts at one gives every lane the
value the scan over the whole set gives it. Each CTA finds its buckets'
first slots once, by one pass of adjacent differences into shared memory,
and lists its eighth of the range's slots deepest first by the number of
merge levels that write each; the cluster's 2,048 threads then compute,
level by level with a cluster barrier between levels, only the lanes that
feed each bucket's last lane (s - 1 adds for s partials, in place), level
i's lanes being the head of each CTA's list, so warps run full and one long
bucket spreads over the whole cluster. The last cluster of a set to finish
runs K3b's two suffix scans over its buckets, each level's lanes cut evenly
over its CTAs. By default the ranges are sized so that all sets' clusters
are resident at once, as many as CUDA's occupancy query says the card
holds (``wide_range_buckets``). B commitments are B sets of one launch.
The rounds-batched MSM of B scalar vectors hands it its B x R rounds as
B x R sets (K3b's function on each: the same window sums, coordinate for
coordinate); at n = 2^20 (c = 13) one CTA per round, as K3b runs them,
would leave 121 of 132 SMs idle through ~1,600 dependent adds a thread.

The fused Pippenger schedule (the JAX package's default up to 2^15 points,
``msm/pippenger.py:309-399``) puts every round of a vector into ONE bucket
set of R x 2^(c-1) buckets: K4 folds each digit's round into its magnitude
(``round_offset``, ``fuse_rounds``), so one sort and K3a take the set as
they take any; K3b-wide merges it in ranges of whole rounds and runs the
suffix scans in segments of 2^(c-1) (``segment``), one window sum per
round, the JAX package's ``_suffix_scan_points_seg`` (``:124``).

K4 ``glv_digits`` replaces the GLV split and signed digits that the JAX
package runs inside its jitted Pippenger (``msm/wnaf.py:73-97``
``split_scalars``, whose field steps - ``to_plain``, ``sub``, ``mont_mul``,
``add`` - go through the Pallas field kernel ``kernels/field_kernels.py:64``,
and ``:136`` ``signed_digits``); in the port the eager chain took ~965
launches per MSM call. It is bound by bytes: 72 in and 4 per digit out per
scalar (2 x 14 digits at c = 10) against 888 32-bit multiply-adds (102 wide
multiplies in four limb products, two Montgomery products). What the
design does about it: one thread per scalar keeps the whole split in
registers - the Babai quotients are the limbs from the ninth on of the
products with the multipliers shifted left by 14 (270 = 9 x 30), each limb
product compiled at its operands' widths (3 or 5 limbs for the constants
and the quotients, so no multiply of a zero limb is issued), the field
steps ``csrc/field.cuh``'s - and stores each round's digits of k1 and k2
coalesced in the table's entry order, so a commit call's (B, m) digits are
one launch.

K3c is bound by neither bytes nor instruction rate: its 143 doublings and 11 adds
(c = 13, 11 rounds) are one dependent chain of ~1,200 Montgomery products,
and grouping the sums any other way would change the Jacobian coordinates;
a product costs one warp ~1,000 cycles of issue. What the design does
about it: a group of 8 lanes of one warp runs a chain, each point
operation's independent products side by side on the group's lanes (the
same fe_mul on other operands costs a warp no more issue), in 3 levels a
doubling and 4 an add (43 product latencies a round in place of 107),
each lane taking the level's products by shuffles and computing the sums
between levels itself; the running sum is stored and reloaded once per
round, and the B MSMs of a commit call are B groups of one launch, where
the JAX package runs c + 1 point-kernel calls per round and MSM; the
launch's device time stays that of one chain.

Every point operation is the plain version's, on the same lanes in the same
order, so the Jacobian coordinates are equal limb for limb (and to the JAX
package's, whose sort is stable too). A CUDA batch always launches the
kernels (or raises); a CPU batch always takes the plain versions below.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..fields.params import FQ_PARAMS, FR_PARAMS, NUM_LIMBS
from ..groups.group import AffinePoints, JacobianPoints
from . import build
from .field_kernels import limb_field
from .point_kernels import ROW_WORDS, plain_add, plain_dbl, plain_mixed_add, point_table, row_points

L = NUM_LIMBS

# Kernel launches since the counters were last reset (reset_counts).
launch_counts = {"bucket_accumulate": 0, "bucket_reduce": 0, "bucket_reduce_wide": 0, "window_combine": 0,
                 "glv_digits": 0}

# K3b-wide: CTAs per cluster (csrc/msm_kernels.cu WIDE_CLUSTER)
WIDE_CLUSTER = 8
_max_clusters: dict = {}


def wide_max_clusters(nbuckets: int, device) -> int:
    """The most K3b-wide clusters the card holds at once, from CUDA's
    occupancy query at the shared memory of a range of ``nbuckets`` buckets
    (the widest): an H100's GPCs need not hold a multiple of WIDE_CLUSTER
    SMs, so this can be fewer than SMs / WIDE_CLUSTER."""
    key = (device, nbuckets)
    n = _max_clusters.get(key)
    if n is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = build.get_lib("msm_kernels").bb_wide_max_clusters(nbuckets, ctypes.addressof(out))
        build.check(err, "the bucket_reduce_wide occupancy query")
        n = _max_clusters[key] = out.value
    return n


# K3a: the walks an H100 holds resident at K3a's CTA shape (the occupancy
# query's answer there: 132 SMs x 3 CTAs x 128 threads). A CPU batch picks
# its block from it, so the CPU path walks the blocks the card would.
NOMINAL_CAPACITY = 132 * 3 * 128
ACC_BLOCKS = (8, 16, 32, 64, 128)  # the blocks accumulate_block picks from
_capacity: dict = {}


def accumulate_capacity(device) -> int:
    """The K3a walks the card holds resident at once (CUDA's occupancy query
    at K3a's CTA shape and shared memory, times the SMs); NOMINAL_CAPACITY
    for a CPU device."""
    if device.type != "cuda":
        return NOMINAL_CAPACITY
    n = _capacity.get(device)
    if n is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = build.get_lib("msm_kernels").bb_accumulate_capacity(ctypes.addressof(out))
        build.check(err, "the bucket_accumulate occupancy query")
        n = _capacity[device] = out.value
    return n


def accumulate_block(entries: int, capacity: int) -> int:
    """K3a's block for a call of ``entries`` sorted entries (all sets), on a
    card that holds ``capacity`` walks at once: the largest of ACC_BLOCKS
    whose walks fill the card at least once, else the smallest. A shorter
    walk puts more of a call's walks in flight, and leaves K3b-wide one
    partial more per walk to merge."""
    for block in reversed(ACC_BLOCKS):
        if entries // block >= capacity:
            return block
    return ACC_BLOCKS[0]


def wide_range_buckets(nbuckets: int, sets: int, device, segment: int | None = None) -> int:
    """K3b-wide's default buckets per cluster: the fewest that give every set
    the same number of ranges and all sets' clusters at most
    ``wide_max_clusters``, so that they run in one wave; with more sets
    than that (a rounds-batched commit call's B x R rounds), one range a
    set, in waves. With ``segment`` (the fused schedule's rounds of
    2^(c-1) buckets) a range holds a whole number of segments."""
    per_set = max(1, wide_max_clusters(nbuckets, device) // sets)
    if segment is None:
        return -(-nbuckets // per_set)
    return -(-(nbuckets // segment) // per_set) * segment


def reset_counts() -> None:
    for op in launch_counts:
        launch_counts[op] = 0


class SortedRounds(NamedTuple):
    """Each round's entries in bucket order; the sort is stable, so the
    entries of one bucket keep their order (which fixes the Jacobian
    coordinates of the bucket's sum)."""

    order: torch.Tensor  # (R, M) int64: entry index at each sorted position
    digit: torch.Tensor  # (R, M) int32: that entry's signed digit
    bucket: torch.Tensor  # (R, M) int64: |digit| - 1, or nbuckets for 0 (dead)


class Partials(NamedTuple):
    """The bucket partial sums the walks emit, compacted per round: slot k of
    round r is lane r * K + k. Emitted partials come first, block after block
    and in walk order; the remaining slots hold bucket ``nbuckets`` at
    infinity with zero coordinates."""

    bucket: torch.Tensor  # (R, K) int32
    points: JacobianPoints  # (18, R * K)


def sort_rounds(digits: torch.Tensor, nbuckets: int) -> SortedRounds:
    """digits: (R, M) int32 signed window digits -> every round sorted by
    bucket in one batched stable sort."""
    mag = digits.abs().to(torch.int64)
    bucket = torch.where(mag == 0, nbuckets, mag - 1)
    order = torch.argsort(bucket, dim=1, stable=True)
    return SortedRounds(order, digits.gather(1, order), bucket.gather(1, order))


def partial_slots(nbuckets: int, nblocks: int, block: int) -> int:
    """K: a round emits one partial per run of equal buckets in each block,
    at most nblocks + nbuckets of them."""
    return min(nbuckets + nblocks, nblocks * (block + 1))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (LimbField arithmetic, any device)
# ---------------------------------------------------------------------------
def plain_bucket_accumulate(
    entries: SortedRounds, px, py, pinf, nbuckets: int, block: int
) -> Partials:
    """The block-sequential walk as a loop over the block's columns, every
    walk of every round one lane: one mixed add per column, then the
    emitted partials compacted by a stable key sort.

    px, py: (18, M) affine coordinates; pinf: (M,) bool. An entry with a
    negative digit adds -P; one with digit 0 is dead (at infinity)."""
    f = limb_field(FQ_PARAMS)
    rounds, m = entries.order.shape
    nblocks = m // block
    lanes = rounds * nblocks
    k = partial_slots(nbuckets, nblocks, block)
    dev = px.device

    def cols(t):  # (R, M) sorted -> (block, R * nblocks): column j = step j of every walk
        return t.reshape(rounds, nblocks, block).permute(2, 0, 1).reshape(block, lanes)

    idx, dig, bkt = cols(entries.order), cols(entries.digit), cols(entries.bucket)
    x = px[:, idx]
    y = py[:, idx]
    y = torch.where((dig < 0).unsqueeze(0), f.neg(y), y)
    inf = pinf[idx] | (dig == 0)
    one = f.const_rows(1, x[:, 0])
    zero = torch.zeros_like(one)

    acc = JacobianPoints(zero, zero, zero, torch.ones(lanes, dtype=torch.bool, device=dev))
    cur = bkt[0]
    em_f, em_d, em_p = [], [], []
    for j in range(block):
        aff = AffinePoints(x[:, j], y[:, j], inf[j])
        same = bkt[j] == cur
        em_f.append(~same)
        em_d.append(cur)
        em_p.append(acc)
        added = plain_mixed_add(acc, aff)
        acc = JacobianPoints(
            f.select(same, added.x, aff.x), f.select(same, added.y, aff.y),
            f.select(same, added.z, one), torch.where(same, added.inf, aff.inf),
        )
        cur = bkt[j]
    em_f.append(torch.ones(lanes, dtype=torch.bool, device=dev))  # each block's last run
    em_d.append(cur)
    em_p.append(acc)

    steps = block + 1

    def per_round(ts):  # steps x (..., lanes) -> (..., R, nblocks * steps), block-major
        t = torch.stack(ts, dim=-1)
        return t.reshape(t.shape[:-2] + (rounds, nblocks * steps))

    em_f, em_d = per_round(em_f), per_round(em_d)
    pos = torch.arange(nblocks * steps, device=dev)
    corder = torch.argsort(torch.where(em_f, pos, pos | (1 << 30)), dim=1, stable=True)[:, :k]
    emitted = em_f.gather(1, corder)
    cd = torch.where(emitted, em_d.gather(1, corder), nbuckets)

    def take(coord):
        t = per_round([getattr(p, coord) for p in em_p])
        if coord == "inf":
            return (t.gather(1, corder) | (cd == nbuckets)).reshape(rounds * k)
        t = t.gather(2, corder.unsqueeze(0).expand(L, -1, -1))
        return torch.where(emitted, t, 0).reshape(L, rounds * k)

    return Partials(cd.to(torch.int32), JacobianPoints(take("x"), take("y"), take("z"), take("inf")))


def _roll(p: JacobianPoints, d: int, dead: torch.Tensor) -> JacobianPoints:
    """Round-wise lane shift of (18, R, n) points: lane i takes lane i - d;
    lanes marked `dead` ((n,), no source lane) become infinity."""
    return JacobianPoints(
        torch.roll(p.x, d, dims=2), torch.roll(p.y, d, dims=2), torch.roll(p.z, d, dims=2),
        torch.roll(p.inf, d, dims=1) | dead,
    )


def _select(mask, p: JacobianPoints, q: JacobianPoints) -> JacobianPoints:
    f = limb_field(FQ_PARAMS)
    return JacobianPoints(
        f.select(mask, p.x, q.x), f.select(mask, p.y, q.y), f.select(mask, p.z, q.z),
        torch.where(mask, p.inf, q.inf),
    )


def _ks_segmented_scan(p: JacobianPoints, starts: torch.Tensor) -> JacobianPoints:
    """Kogge-Stone inclusive segmented scan of group adds along each round's
    lanes; starts: (R, n) bool, True at segment starts."""
    n = starts.shape[1]
    idx = torch.arange(n, device=starts.device)
    fl = starts
    for i in range(max(1, (n - 1).bit_length())):
        d = 1 << i
        valid = idx >= d
        summed = plain_add(p, _roll(p, d, ~valid))
        p = _select(fl | ~valid, p, summed)  # a segment start (or no lane d back) keeps its own
        fl = fl | (torch.roll(fl, d, dims=1) & valid)
    return p


def _suffix_scan(p: JacobianPoints) -> JacobianPoints:
    """Inclusive suffix scan (out[i] = sum_{j >= i} in[j]) along each round."""
    n = p.inf.shape[1]
    idx = torch.arange(n, device=p.inf.device)
    for i in range(max(1, (n - 1).bit_length())):
        d = 1 << i
        p = plain_add(p, _roll(p, -d, idx >= n - d))
    return p


def _ks_in_ranges(p: JacobianPoints, cd: torch.Tensor, nbuckets: int, range_buckets: int) -> JacobianPoints:
    """The segmented scan run on each range of ``range_buckets`` buckets of
    each set alone, as K3b-wide's clusters run it. The ranges are the rows of
    one padded (ranges, width) batch, pad lanes trailing each row as one
    segment at infinity; dead slots (bucket ``nbuckets``, never scattered)
    keep their input."""
    sets, k = cd.shape
    dev = cd.device
    nranges = -(-nbuckets // range_buckets)
    live = (cd < nbuckets).reshape(-1)
    gid = (cd // range_buckets + torch.arange(sets, device=dev).unsqueeze(1) * nranges).reshape(-1)[live]
    counts = torch.bincount(gid, minlength=sets * nranges)
    width = max(1, int(counts.max()))
    flat = gid * width + torch.arange(gid.numel(), device=dev) - (counts.cumsum(0) - counts)[gid]

    def spread(t, fill):  # (..., sets, k) live slots -> (..., ranges, width)
        lead = t.shape[:-2]
        out = torch.full(lead + (sets * nranges * width,), fill, dtype=t.dtype, device=dev)
        out[..., flat] = t.reshape(lead + (sets * k,))[..., live]
        return out.reshape(lead + (sets * nranges, width))

    def gather(t, orig):  # the ranges' lanes back into their slots
        out = orig.reshape(orig.shape[:-2] + (sets * k,)).clone()
        out[..., live] = t.reshape(t.shape[:-2] + (-1,))[..., flat]
        return out.reshape(orig.shape)

    cdg = spread(cd, -1)
    starts = torch.ones_like(cdg, dtype=torch.bool)
    starts[:, 1:] = cdg[:, 1:] != cdg[:, :-1]
    q = JacobianPoints(spread(p.x, 0), spread(p.y, 0), spread(p.z, 0), spread(p.inf, True))
    return JacobianPoints(*(gather(t, o) for t, o in zip(_ks_segmented_scan(q, starts), p)))


def plain_bucket_sums(partials: Partials, nbuckets: int, range_buckets: int | None = None) -> JacobianPoints:
    """Merge each bucket's partials (segmented scan) and scatter the merged
    sums to their buckets: (18, R, nbuckets) points, empty buckets at
    infinity with zero coordinates. ``range_buckets``: merge each range of
    that many buckets alone (K3b-wide's cut; None: each set whole)."""
    cd = partials.bucket.to(torch.int64)
    rounds, k = cd.shape
    pts = partials.points
    p = JacobianPoints(
        pts.x.reshape(L, rounds, k), pts.y.reshape(L, rounds, k),
        pts.z.reshape(L, rounds, k), pts.inf.reshape(rounds, k),
    )
    starts = torch.ones_like(cd, dtype=torch.bool)
    starts[:, 1:] = cd[:, 1:] != cd[:, :-1]
    if range_buckets is None:
        merged = _ks_segmented_scan(p, starts)
    else:
        merged = _ks_in_ranges(p, cd, nbuckets, range_buckets)
    is_end = torch.ones_like(starts)
    is_end[:, :-1] = cd[:, :-1] != cd[:, 1:]
    # Only each round's dump slot `nbuckets` can receive more than one write
    # (which one wins is unspecified on CUDA); it is sliced off below, and
    # each live bucket has exactly one segment end.
    live = is_end & (cd < nbuckets)
    slot = torch.where(live, cd, nbuckets) + torch.arange(rounds, device=cd.device).unsqueeze(1) * (nbuckets + 1)
    slot = slot.reshape(-1)
    zeros = torch.zeros((L, rounds * (nbuckets + 1)), dtype=pts.x.dtype, device=cd.device)

    def scatter(t):
        return zeros.index_copy(1, slot, t.reshape(L, -1)).reshape(L, rounds, nbuckets + 1)[:, :, :nbuckets]

    inf = torch.ones(rounds * (nbuckets + 1), dtype=torch.bool, device=cd.device)
    inf = inf.index_copy(0, slot, (merged.inf | ~live).reshape(-1)).reshape(rounds, nbuckets + 1)
    return JacobianPoints(scatter(merged.x), scatter(merged.y), scatter(merged.z), inf[:, :nbuckets])


def _window_sums(buckets: JacobianPoints) -> JacobianPoints:
    total = _suffix_scan(_suffix_scan(buckets))
    return JacobianPoints(total.x[:, :, 0], total.y[:, :, 0], total.z[:, :, 0], total.inf[:, 0])


def plain_bucket_reduce(partials: Partials, nbuckets: int) -> JacobianPoints:
    """Each round's window sum sum_m (m+1) S_m from its bucket sums S_m via
    the double-suffix-scan identity: an (18, R) batch, lane r = round r."""
    return _window_sums(plain_bucket_sums(partials, nbuckets))


def plain_bucket_reduce_wide(
    partials: Partials, nbuckets: int, range_buckets: int | None = None, segment: int | None = None
) -> JacobianPoints:
    """K3b-wide's function, each bucket set's window sum, with the set's
    partials merged in ranges of ``range_buckets`` buckets as the kernel's
    clusters merge them (None: uncut). Every range starts at a segment start,
    so the result does not depend on the cut. With ``segment`` (a divisor of
    nbuckets: the fused schedule's 2^(c-1) buckets a round) each set's
    buckets are nbuckets / segment windows, suffix-scanned apart: an (18,
    sets * nbuckets / segment) batch, lane s * R + r = set s's window r."""
    sums = plain_bucket_sums(partials, nbuckets, range_buckets)
    if segment is not None:
        lanes = sums.inf.numel() // segment
        sums = JacobianPoints(*(t.reshape(L, lanes, segment) for t in sums[:3]), sums.inf.reshape(lanes, segment))
    return _window_sums(sums)


def digit_rounds(c: int) -> int:
    """Rounds of signed c-bit digits of a 128-bit GLV half: ceil(128 / c)
    windows and the final carry."""
    return -(-128 // c) + 1


def fuse_rounds(digits: torch.Tensor, offset: int) -> torch.Tensor:
    """Signed digits (rounds, ...) -> each digit d of round r as sign(d)
    (r * offset + |d|): with offset 2^(c-1), bucket |D| - 1 is the fused
    schedule's r 2^(c-1) + |d| - 1 in one set of rounds x 2^(c-1)."""
    r = torch.arange(digits.shape[0], device=digits.device, dtype=digits.dtype).reshape((-1,) + (1,) * (digits.ndim - 1))
    return digits + torch.sign(digits) * r * offset


def plain_glv_digits(scalars: torch.Tensor, sets: int, c: int, m: int, round_offset: int = 0) -> torch.Tensor:
    """K4's function as the eager chain: GLV split (``msm/wnaf.py``
    ``split_scalars``) and signed digits (``signed_digits``) of ``sets``
    scalar vectors of n, given as one (18, sets * n) internal-Montgomery Fr
    tensor -> (sets, m) int32: round r's n digits of k1, then its n of k2,
    rounds one after another, zeros up to m; each with its round's
    ``round_offset`` (``fuse_rounds``)."""
    from ..msm.wnaf import signed_digits, split_scalars  # msm imports this module

    n = scalars.shape[1] // sets
    k1, k2 = split_scalars(scalars)
    d1, d2 = (fuse_rounds(signed_digits(k, c), round_offset).reshape(-1, sets, n) for k in (k1, k2))
    digits = torch.cat([d1, d2], dim=2).permute(1, 0, 2).reshape(sets, -1)
    return torch.nn.functional.pad(digits, (0, m - digits.shape[1]))


def plain_window_combine(windows: JacobianPoints, c: int, sets: int = 1) -> JacobianPoints:
    """Each of ``sets`` MSMs' sum_r 2^(c r) W_r by Horner's rule, most
    significant window first: c doublings then one add per round, starting
    from infinity with zero coordinates, the MSMs side by side as lanes.
    windows: (18, sets * R) batch, lane s * R + r = MSM s's round r.
    Returns (sets,)."""
    rounds, dev = windows.inf.shape[0] // sets, windows.x.device
    zero = torch.zeros((L, sets), dtype=torch.int32, device=dev)
    acc = JacobianPoints(zero, zero, zero, torch.ones(sets, dtype=torch.bool, device=dev))
    first = torch.arange(sets, device=dev) * rounds
    for r in reversed(range(rounds)):
        for _ in range(c):
            acc = plain_dbl(acc)
        win = JacobianPoints(*(t[..., first + r] for t in windows))
        acc = plain_add(acc, win)
    return acc


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------
def _check(t: torch.Tensor, shape: tuple, dtype, device) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"MSM kernel takes {shape} {dtype} on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def block_offsets(entries: SortedRounds, block: int) -> torch.Tensor:
    """(R, nblocks) int32: each block's first partial slot in its round, the
    prefix count of the runs (emitted partials) of the blocks before it."""
    rounds, m = entries.bucket.shape
    runs = 1 + (entries.bucket.reshape(rounds, m // block, block).diff(dim=2) != 0).sum(dim=2)
    return (runs.cumsum(dim=1) - runs).to(torch.int32)


def _launch_accumulate(entries: SortedRounds, table: torch.Tensor, nbuckets: int, block: int) -> Partials:
    dev = table.device
    if not table.is_cuda:
        raise ValueError("bucket_accumulate kernel takes CUDA tensors")
    rounds, m = entries.order.shape
    nblocks = m // block
    k = partial_slots(nbuckets, nblocks, block)
    table = _check(table, (table.shape[0], ROW_WORDS), torch.int32, dev)

    def cols(t):  # (R, M) -> (R, block, nblocks): step j of a round's walks is one row
        return t.reshape(rounds, nblocks, block).transpose(1, 2).to(torch.int32).contiguous()

    sidx, sdig = cols(entries.order), cols(entries.digit)
    offsets = block_offsets(entries, block).contiguous()
    cd = torch.full((rounds, k), nbuckets, dtype=torch.int32, device=dev)
    ox, oy, oz = (torch.zeros((L, rounds * k), dtype=torch.int32, device=dev) for _ in range(3))
    oinf = torch.ones(rounds * k, dtype=torch.uint8, device=dev)
    lib = build.get_lib("msm_kernels")
    with torch.cuda.device(dev):
        err = lib.bb_bucket_accumulate(
            table.data_ptr(), sidx.data_ptr(), sdig.data_ptr(), offsets.data_ptr(),
            cd.data_ptr(), ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oinf.data_ptr(),
            rounds, nblocks, block, k, nbuckets, build.field_consts(FQ_PARAMS), build.current_stream(),
        )
    build.check(err, "bucket_accumulate")
    launch_counts["bucket_accumulate"] += 1
    return Partials(cd, JacobianPoints(ox, oy, oz, oinf.view(torch.bool)))


def _launch_reduce(partials: Partials, nbuckets: int) -> JacobianPoints:
    cd = partials.bucket
    dev = cd.device
    if not cd.is_cuda:
        raise ValueError("bucket_reduce kernel takes CUDA tensors")
    rounds, k = cd.shape
    cd = _check(cd, (rounds, k), torch.int32, dev)
    p = partials.points
    x, y, z = (_check(t, (L, rounds * k), torch.int32, dev) for t in (p.x, p.y, p.z))
    inf = _check(p.inf, (rounds * k,), torch.bool, dev).view(torch.uint8)
    scratch32 = torch.empty(6 * L * rounds * (k + nbuckets), dtype=torch.int32, device=dev)
    scratch8 = torch.empty(2 * rounds * (k + nbuckets), dtype=torch.uint8, device=dev)
    ox, oy, oz = (torch.empty((L, rounds), dtype=torch.int32, device=dev) for _ in range(3))
    oinf = torch.empty(rounds, dtype=torch.uint8, device=dev)
    lib = build.get_lib("msm_kernels")
    with torch.cuda.device(dev):
        err = lib.bb_bucket_reduce(
            cd.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), inf.data_ptr(),
            scratch32.data_ptr(), scratch8.data_ptr(),
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oinf.data_ptr(),
            rounds, k, nbuckets, build.field_consts(FQ_PARAMS), build.current_stream(),
        )
    build.check(err, "bucket_reduce")
    launch_counts["bucket_reduce"] += 1
    return JacobianPoints(ox, oy, oz, oinf.view(torch.bool))


def _launch_reduce_wide(
    partials: Partials, nbuckets: int, range_buckets: int, lib=None, segment: int | None = None
) -> JacobianPoints:
    """K3b-wide's launch; ``lib`` is the package's msm_kernels library unless a
    debug build of it is given (tools/time_torch_wide.py)."""
    cd = partials.bucket
    dev = cd.device
    if not cd.is_cuda:
        raise ValueError("bucket_reduce_wide kernel takes CUDA tensors")
    sets, k = cd.shape
    cd = _check(cd, (sets, k), torch.int32, dev)
    p = partials.points
    x, y, z = (_check(t, (L, sets * k), torch.int32, dev) for t in (p.x, p.y, p.z))
    inf = _check(p.inf, (sets * k,), torch.bool, dev).view(torch.uint8)
    scratch32 = torch.empty(3 * L * sets * (k + 2 * nbuckets) + sets * k, dtype=torch.int32, device=dev)
    scratch8 = torch.empty(sets * (k + 2 * nbuckets), dtype=torch.uint8, device=dev)
    done = torch.zeros(sets, dtype=torch.int32, device=dev)
    seg = segment or nbuckets
    lanes = sets * (nbuckets // seg)
    ox, oy, oz = (torch.empty((L, lanes), dtype=torch.int32, device=dev) for _ in range(3))
    oinf = torch.empty(lanes, dtype=torch.uint8, device=dev)
    lib = lib or build.get_lib("msm_kernels")
    with torch.cuda.device(dev):
        err = lib.bb_bucket_reduce_wide(
            cd.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), inf.data_ptr(),
            scratch32.data_ptr(), scratch8.data_ptr(), done.data_ptr(),
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oinf.data_ptr(),
            sets, k, nbuckets, range_buckets, seg, build.field_consts(FQ_PARAMS), build.current_stream(),
        )
    build.check(err, "bucket_reduce_wide")
    launch_counts["bucket_reduce_wide"] += 1
    return JacobianPoints(ox, oy, oz, oinf.view(torch.bool))


def _launch_combine(windows: JacobianPoints, c: int, sets: int) -> JacobianPoints:
    dev = windows.x.device
    if not windows.x.is_cuda:
        raise ValueError("window_combine kernel takes CUDA tensors")
    lanes = windows.inf.shape[0]
    x, y, z = (_check(t, (L, lanes), torch.int32, dev) for t in windows[:3])
    inf = _check(windows.inf, (lanes,), torch.bool, dev).view(torch.uint8)
    ox, oy, oz = (torch.empty((L, sets), dtype=torch.int32, device=dev) for _ in range(3))
    oinf = torch.empty(sets, dtype=torch.uint8, device=dev)
    lib = build.get_lib("msm_kernels")
    with torch.cuda.device(dev):
        err = lib.bb_window_combine(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), inf.data_ptr(),
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oinf.data_ptr(),
            sets, lanes // sets, c, build.field_consts(FQ_PARAMS), build.current_stream(),
        )
    build.check(err, "window_combine")
    launch_counts["window_combine"] += 1
    return JacobianPoints(ox, oy, oz, oinf.view(torch.bool))


def _launch_glv_digits(scalars: torch.Tensor, sets: int, c: int, m: int, round_offset: int) -> torch.Tensor:
    dev = scalars.device
    if not scalars.is_cuda:
        raise ValueError("glv_digits kernel takes CUDA tensors")
    n = scalars.shape[1] // sets
    scalars = _check(scalars, (L, sets * n), torch.int32, dev)
    out = torch.empty((sets, m), dtype=torch.int32, device=dev)
    lib = build.get_lib("msm_kernels")
    with torch.cuda.device(dev):
        err = lib.bb_glv_digits(
            scalars.data_ptr(), out.data_ptr(), sets, n, c, m, round_offset,
            build.field_consts(FR_PARAMS), build.glv_consts(), build.current_stream(),
        )
    build.check(err, "glv_digits")
    launch_counts["glv_digits"] += 1
    return out


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------
def glv_digits(scalars: torch.Tensor, sets: int, c: int, m: int, round_offset: int = 0) -> torch.Tensor:
    """K4: ``sets`` scalar vectors of n, one (18, sets * n) internal-Montgomery
    Fr tensor -> (sets, m) int32 signed c-bit GLV digits: per set, round r's
    n digits of k1, then its n of k2, rounds one after another (m >=
    ``digit_rounds(c)`` * 2n), zeros beyond. ``round_offset``: the fused
    schedule's 2^(c-1), which folds each digit's round into its magnitude
    (``fuse_rounds``)."""
    if scalars.shape[1] % sets or not 1 <= c <= 30 or m < digit_rounds(c) * 2 * (scalars.shape[1] // sets):
        raise ValueError(f"glv_digits: {scalars.shape[1]} scalars in {sets} sets, c = {c}, m = {m}")
    if round_offset < 0 or round_offset * digit_rounds(c) + (1 << (c - 1)) >= 1 << 31:
        raise ValueError(f"glv_digits: round offset {round_offset} at c = {c} leaves int32")
    if scalars.is_cuda:
        return _launch_glv_digits(scalars, sets, c, m, round_offset)
    return plain_glv_digits(scalars, sets, c, m, round_offset)


def bucket_accumulate(entries: SortedRounds, px, py, pinf, nbuckets: int, block: int) -> Partials:
    """K3a: every round's block walks -> compacted bucket partials."""
    if px.is_cuda:
        return _launch_accumulate(entries, point_table(px, py, pinf), nbuckets, block)
    return plain_bucket_accumulate(entries, px, py, pinf, nbuckets, block)


def bucket_accumulate_rows(entries: SortedRounds, rows: torch.Tensor, nbuckets: int, block: int) -> Partials:
    """K3a on entries given as ``point_table`` rows (built once per table)."""
    if rows.is_cuda:
        return _launch_accumulate(entries, rows, nbuckets, block)
    return plain_bucket_accumulate(entries, *row_points(rows), nbuckets, block)


def bucket_reduce(partials: Partials, nbuckets: int) -> JacobianPoints:
    """K3b: compacted partials -> each round's window sum, (18, R)."""
    if partials.bucket.is_cuda:
        return _launch_reduce(partials, nbuckets)
    return plain_bucket_reduce(partials, nbuckets)


def bucket_reduce_wide(
    partials: Partials, nbuckets: int, range_buckets: int | None = None, segment: int | None = None
) -> JacobianPoints:
    """K3b-wide: compacted partials of S bucket sets -> each set's window
    sum, (18, S); ``range_buckets`` buckets per cluster of CTAs (default
    ``wide_range_buckets``). With ``segment`` (the fused schedule: each set
    is R rounds of ``segment`` buckets) each round's window sum, (18, S *
    R), lane s * R + r; the ranges then hold whole rounds."""
    if segment is not None and (nbuckets % segment or (range_buckets and range_buckets % segment)):
        raise ValueError(f"bucket_reduce_wide: segments of {segment} do not cut {nbuckets} buckets "
                         f"in ranges of {range_buckets}")
    if partials.bucket.is_cuda:
        dev = partials.bucket.device
        rb = range_buckets or wide_range_buckets(nbuckets, partials.bucket.shape[0], dev, segment)
        return _launch_reduce_wide(partials, nbuckets, rb, segment=segment)
    return plain_bucket_reduce_wide(partials, nbuckets, range_buckets, segment)


def window_combine(windows: JacobianPoints, c: int, sets: int = 1) -> JacobianPoints:
    """K3c: the window sums of ``sets`` MSMs (18, sets * R), lane s * R + r
    = MSM s's round r -> each MSM, sum_r 2^(c r) W_r, (sets,): one launch."""
    if sets < 1 or windows.inf.shape[0] % sets:
        raise ValueError(f"window_combine: {windows.inf.shape[0]} windows in {sets} sets")
    if windows.x.is_cuda:
        return _launch_combine(windows, c, sets)
    return plain_window_combine(windows, c, sets)
