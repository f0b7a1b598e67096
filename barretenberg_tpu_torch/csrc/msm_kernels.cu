// Pippenger's bucket phase for every round of one MSM, one launch each, and
// the GLV split and signed digits of an MSM's scalars (K4), one launch.
//
// K3a bucket_accumulate: one thread per (round, block of `block` sorted
// entries) walks its block in bucket order, keeping the running sum in
// registers: an entry of the current bucket is mixed-added (an entry at
// infinity leaves the sum as it is, so its arithmetic is skipped), an entry
// of a new bucket emits (bucket, sum) and restarts the sum from the entry.
// Emitted partials go straight to their compacted slot: offsets[] holds
// each block's first slot (the prefix count of the runs of the blocks
// before it in its round). Each walk prefetches its next point-table row
// into registers while it adds the current one, and the caller picks
// `block` per call so that the walks fill the card
// (msm_kernels.accumulate_block).
//
// K3b bucket_reduce: one CTA per round runs, level by level with a CTA
// barrier between levels, (1) the Kogge-Stone segmented inclusive scan
// that merges the partials of one bucket, (2) the scatter of each
// bucket's merged sum to its bucket slot, (3) the inclusive suffix scan
// over the buckets and (4) the second suffix scan, which is only computed
// for the lanes that feed lane 0 (the window sum sum_m (m+1) S_m). Every
// point operation is the one the plain version does on that lane, in the
// same order, so the coordinates are equal limb for limb.
//
// K3b-wide bucket_reduce_wide: the same function for bucket sets too large
// for one CTA - the precomputed-table MSM puts all of its rounds into one
// set (14,848 partials at 2^16 points against 1,536 per round), and the
// rounds-batched MSM hands it its B x R rounds as B x R sets (20,480
// partials a round at 2^20 points, where K3b's one CTA a round leaves most
// of the card idle). The set's
// partials are cut at bucket boundaries into ranges of `range_buckets`
// buckets, one cluster of WIDE_CLUSTER CTAs each; a bucket is never split.
// No add of the segmented scan crosses a segment start, so a range that
// starts at a segment start gives each lane the value the scan over the
// whole set gives it, and only each segment's last lane is kept: the
// cluster computes just the lanes that feed it (at level i those whose
// distance to their segment's end is a multiple of 2^(i+1)), s - 1 adds
// for a segment of s partials, in place, cut evenly over the cluster's CTAs
// with a cluster barrier between levels. Each CTA first finds the first
// slot of every bucket of its range once, by one pass of adjacent
// differences into shared memory, and lists its share of the slots by the
// number of levels that write each (deepest first), so that the lanes of
// level i are the first ones of its list and fill whole warps. The
// cluster then writes every bucket of its range (its merged sum, or
// infinity), and the last cluster of the set to finish (a counter per set)
// runs the two suffix scans over the set's buckets as K3b does, each
// level's lanes spread over its CTAs, which exchange sums through L2. The
// fused Pippenger schedule hands it one set of R x 2^(c-1) buckets (bucket
// r 2^(c-1) + |d| - 1 for round r) whose window sums are per round: the
// suffix scans run in segments of `seg` = 2^(c-1) buckets that no add
// crosses, and every range is a whole number of rounds, so each cluster
// scans its own rounds as soon as it has written their buckets (no counter,
// no waiting for the set) and writes one window sum per round, lane s * R
// + r, the layout K3c reads.
//
// K3c window_combine: the Horner combine of the rounds' window sums,
// most significant first - c doublings of the running sum, then one add of
// the next window - for the MSMs of a commit call in one launch. Each chain
// is serial, and any other grouping of the sums would change the Jacobian
// coordinates, so what bounds a launch is one chain's dependent latency:
// 11 rounds of 13 doublings and one add at c = 13. A Montgomery product
// costs one warp ~1,000 cycles of issue (fe_mul's ~340 multiply-adds), so
// the chain's length in products sets the time. The design spreads each
// point operation's independent products over a group of COMBINE_GROUP
// lanes of one warp: the lanes run the same fe_mul on different operands
// side by side (SIMT), so a level of up to five products costs one
// product's time, and every lane of the group then takes all of the
// level's products by shuffles and computes the sums between levels
// itself. dbl-2009-l is three levels ({X^2, Y^2, YZ}, {B^2, X B, E^2},
// E(D - X3), with D = 2((X + B)^2 - A - C) = 4 X B); add-2007-bl is four,
// its products regrouped to the same field values (S1 = (Y1 Z2) Z2Z2,
// X3 = r^2 - I (H + 2 U1), Y3 = I (r (3 U1 + H) - 2 S1 H) - r^3): a round is 13 x 3 + 4 = 43 product latencies in
// place of 13 x 7 + 16 = 107. Field products and sums are exact and
// canonical, so the coordinates equal the one-thread formulas' limb for
// limb.
//
// K4 glv_digits: one thread per scalar leaves Montgomery form, splits k =
// k1 - k2 lambda (mod r) with the Babai quotients as the high limbs of limb
// products sized to the GLV constants, and writes the signed c-bit digits
// of k1 and k2 in the precomputed table's entry order, each round's row
// coalesced; for the fused schedule each digit carries its round's bucket
// offset (round_digit), so that one sort and K3a see one bucket set.
//
// Layouts: planar (18, lanes) 15-bit limb arrays as everywhere in the
// package, infinity flags one byte per lane; partial slot k of round r is
// lane r * nslots + k. The level buffers live in device memory (L2) and
// are read with ld.global.cg, never through the read-only cache, since
// the same kernel writes them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "point.cuh"

namespace cg = cooperative_groups;

#define ACC_THREADS 128   // K3a: walks per CTA
#define ACC_MIN_BLOCKS 3  // K3a: __launch_bounds__' minimum of resident CTAs per SM
#define REDUCE_THREADS 256
#define WIDE_CLUSTER 8  // K3b-wide: CTAs per cluster (the portable cluster size)
#define DIGIT_THREADS 128
#define COMBINE_GROUP 8     // K3c: lanes per chain (a level has at most five products)
#define COMBINE_THREADS 32  // K3c: one warp a CTA, COMBINE_THREADS / COMBINE_GROUP chains

__device__ __forceinline__ int bucket_of(int d, int nbuckets) {
    int mag = d < 0 ? -d : d;
    return mag == 0 ? nbuckets : mag - 1;
}

// ---------------------------------------------------------------------------
// K3a
// ---------------------------------------------------------------------------
// table: (m, ROW_WORDS) rows. sidx/sdig: (rounds, block, nblocks) entry index
// and signed digit of sorted position b * block + j of each round (step j
// of all walks of a round is one contiguous row, so a warp's reads
// coalesce). offsets: (rounds, nblocks). Outputs (rounds * nslots lanes)
// arrive filled with bucket nbuckets at infinity (zero coordinates); the
// kernel overwrites the slots it emits.
__global__ void __launch_bounds__(ACC_THREADS, ACC_MIN_BLOCKS)
bucket_accumulate_kernel(const uint4* __restrict__ table, const int* __restrict__ sidx,
                         const int* __restrict__ sdig, const int* __restrict__ offsets,
                         int* __restrict__ ocd, Pts out, int rounds, int nblocks, int block,
                         int nslots, int nbuckets, FieldConst fc) {
    long walk = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (walk >= (long)rounds * nblocks) return;
    long r = walk / nblocks;
    long col = r * block * nblocks + walk % nblocks;  // step j at col + j * nblocks
    long stride = (long)rounds * nslots;
    long slot = r * nslots + offsets[walk];
    const fe one = fe_one(fc);

    jpt acc;
    acc.x = acc.y = acc.z = fe_zero();
    acc.inf = true;
    int d = sdig[col];
    int cur = bucket_of(d, nbuckets);
    uint32_t w[ROW_WORDS];
    load_row(table, sidx[col], w);
    for (int j = 0; j < block; ++j) {
        fe x, y;
        bool row_inf;
        unpack_row(w, x, y, row_inf);
        const int dj = d;
        const bool pinf = row_inf || dj == 0;
        if (j + 1 < block) {  // prefetch the next entry while this one computes
            long e = col + (long)(j + 1) * nblocks;
            d = sdig[e];
            load_row(table, sidx[e], w);
        }
        if (dj < 0) y = fe_sub(fe_zero(), y, fc);
        const int bkt = bucket_of(dj, nbuckets);
        if (bkt == cur) {
            if (!pinf) acc = jac_add<true>(acc.x, acc.y, acc.z, acc.inf, x, y, one, false, fc);
        } else {
            acc.inf = acc.inf || cur == nbuckets;
            ocd[slot] = cur;
            store_pt(out, slot, stride, acc);
            ++slot;
            acc.x = x;
            acc.y = y;
            acc.z = one;
            acc.inf = pinf;
            cur = bkt;
        }
    }
    acc.inf = acc.inf || cur == nbuckets;
    ocd[slot] = cur;
    store_pt(out, slot, stride, acc);
}

// ---------------------------------------------------------------------------
// K3b
// ---------------------------------------------------------------------------
enum { KS = 0, SUFFIX = 1, SUFFIX_LANE0 = 2 };

__device__ __forceinline__ int bit_length(int v) { return v <= 0 ? 0 : 32 - __clz(v); }

// cd: (rounds, nslots) bucket of each partial. in0: the partials. ping/pong:
// level buffers like in0; bk0/bk1: (18, rounds * nbuckets) bucket buffers.
// out: (18, rounds) window sums.
__global__ void __launch_bounds__(REDUCE_THREADS, 1)
bucket_reduce_kernel(const int* __restrict__ cd, Pts in0, Pts ping, Pts pong, Pts bk0, Pts bk1,
                     Pts out, int rounds, int nslots, int nbuckets, FieldConst fc) {
    extern __shared__ uint8_t flags[];  // 2 x nslots segment flags, ping-pong
    const int r = blockIdx.x;
    const int* c = cd + (long)r * nslots;
    const long ps = (long)rounds * nslots, pb = (long)r * nslots;
    const long bs = (long)rounds * nbuckets, bb = (long)r * nbuckets;

    jpt inf_pt;
    inf_pt.x = inf_pt.y = inf_pt.z = fe_zero();
    inf_pt.inf = true;
    for (int t = threadIdx.x; t < nslots; t += blockDim.x) flags[t] = t == 0 || c[t] != c[t - 1];
    for (int t = threadIdx.x; t < nbuckets; t += blockDim.x) store_pt(bk0, bb + t, bs, inf_pt);
    __syncthreads();

    const int ks_levels = max(1, bit_length(nslots - 1));
    const int sc_levels = max(1, bit_length(nbuckets - 1));
    const int steps = ks_levels + 1 + 2 * sc_levels;
    for (int step = 0; step < steps; ++step) {
        if (step == ks_levels) {
            // scatter each live bucket's merged sum (its segment's last lane)
            Pts src = ((ks_levels - 1) & 1) ? pong : ping;
            for (int t = threadIdx.x; t < nslots; t += blockDim.x) {
                int b = c[t];
                bool end = t == nslots - 1 || b != c[t + 1];
                if (end && b < nbuckets) store_pt(bk0, bb + b, bs, load_pt_cg(src, pb + t, ps));
            }
            __syncthreads();
            continue;
        }
        int mode, i, n;
        Pts src, dst;
        long base, stride;
        if (step < ks_levels) {
            mode = KS;
            i = step;
            n = nslots;
            src = i == 0 ? in0 : ((i & 1) ? ping : pong);
            dst = (i & 1) ? pong : ping;
            base = pb;
            stride = ps;
        } else if (step < ks_levels + 1 + sc_levels) {
            mode = SUFFIX;
            i = step - ks_levels - 1;
            n = nbuckets;
            src = (i & 1) ? bk1 : bk0;
            dst = (i & 1) ? bk0 : bk1;
            base = bb;
            stride = bs;
        } else {  // in place on the first suffix scan's result
            mode = SUFFIX_LANE0;
            i = step - ks_levels - 1 - sc_levels;
            n = nbuckets;
            src = dst = ((sc_levels - 1) & 1) ? bk0 : bk1;
            base = bb;
            stride = bs;
        }
        const int d = 1 << i;
        // level i of the lane-0 scan needs only the multiples of 2d
        const int work = mode == SUFFIX_LANE0 ? (n + 2 * d - 1) / (2 * d) : n;
        const uint8_t* fi = flags + (i & 1) * nslots;
        uint8_t* fo = flags + ((i + 1) & 1) * nslots;
        for (int t = threadIdx.x; t < work; t += blockDim.x) {
            int lane, other;
            bool take;
            if (mode == KS) {
                lane = t;
                other = t - d;
                take = !fi[t] && t >= d;  // a segment start (or no lane d back) keeps its own sum
                fo[t] = fi[t] | (t >= d && fi[t - d]);
            } else {
                lane = mode == SUFFIX ? t : t * 2 * d;
                other = lane + d;
                take = other < n;
            }
            jpt p = load_pt_cg(src, base + lane, stride);
            if (take) {
                jpt q = load_pt_cg(src, base + other, stride);
                p = jac_add<false>(p.x, p.y, p.z, p.inf, q.x, q.y, q.z, q.inf, fc);
            }
            store_pt(dst, base + lane, stride, p);
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        Pts fin = ((sc_levels - 1) & 1) ? bk0 : bk1;
        store_pt(out, r, rounds, load_pt_cg(fin, bb, bs));
    }
}

// ---------------------------------------------------------------------------
// K3b-wide
// ---------------------------------------------------------------------------
#ifdef BB_WIDE_STAMPS
// Debug build only (tools/time_torch_wide.py): per set, %globaltimer at the
// first CTA's start and at the last end of the merge, the scatter and the
// suffix scans, taken by thread 0 of each CTA after a barrier.
#define WIDE_STAMP_SETS 16
__device__ unsigned long long wide_stamps[WIDE_STAMP_SETS][4];

__device__ __forceinline__ void wide_stamp(int s, int k) {
    if (threadIdx.x != 0 || s >= WIDE_STAMP_SETS) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (k == 0)
        atomicMin(&wide_stamps[s][0], t);
    else
        atomicMax(&wide_stamps[s][k], t);
}

// Copies the stamps of the first `sets` sets to host (sets x 4 words) and
// resets them.
extern "C" int bb_wide_stamps(void* host, int sets) {
    unsigned long long h[WIDE_STAMP_SETS][4];
    cudaError_t e = cudaMemcpyFromSymbol(h, wide_stamps, sizeof(h));
    if (e != cudaSuccess) return (int)e;
    for (int s = 0; s < sets && s < WIDE_STAMP_SETS; ++s)
        for (int k = 0; k < 4; ++k) ((unsigned long long*)host)[4 * s + k] = h[s][k];
    for (int s = 0; s < WIDE_STAMP_SETS; ++s) {
        h[s][0] = ~0ull;
        h[s][1] = h[s][2] = h[s][3] = 0;
    }
    return (int)cudaMemcpyToSymbol(wide_stamps, h, sizeof(h));
}
#else
__device__ __forceinline__ void wide_stamp(int, int) {}
#endif

// First index in [lo, hi) whose bucket is >= v (hi if none); c is sorted.
__device__ __forceinline__ int lower_bound(const int* __restrict__ c, int lo, int hi, int v) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (c[mid] < v)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// CTA `rank`'s share [begin, end) of n items of a level: the items are cut
// into WIDE_CLUSTER contiguous pieces, so that every SM of the cluster takes
// part even when a level has fewer items than the cluster has threads.
struct Share {
    int begin, end;
};

__device__ __forceinline__ Share cta_share(int n, int rank) {
    const int q = (n + WIDE_CLUSTER - 1) / WIDE_CLUSTER;
    return {min(n, rank * q), min(n, (rank + 1) * q)};
}

// The merge levels that write slot t of the segment [first, end]: level i
// adds lane t - 2^i into lane t when end - t is a multiple of 2^(i+1) and t
// - first >= 2^i, so t takes part in levels 0 .. depth - 1 with depth =
// min(trailing zeros of end - t, bit length of t - first).
__device__ __forceinline__ int merge_depth(int t, int first, int end) {
    const int q = end - t;
    return min(q == 0 ? 32 : __ffs(q) - 1, bit_length(t - first));
}

// cd: (sets, nslots) bucket of each partial, sorted within a set (dead
// slots, bucket nbuckets, last). in0: the partials. mid: a buffer like in0
// for the merge's partial sums; bk0/bk1: (18, sets * nbuckets) bucket
// buffers; order: (sets, nslots) words for each CTA's list of its slots,
// deepest first; done: (sets,) zeroed counters. out: (18, sets) window sums.
// Grid: (WIDE_CLUSTER * ceil(nbuckets / range_buckets), sets), one cluster
// of WIDE_CLUSTER CTAs per range; dynamic shared memory: range_buckets + 1
// words.
__global__ void __cluster_dims__(WIDE_CLUSTER, 1, 1) __launch_bounds__(REDUCE_THREADS, 1)
bucket_reduce_wide_kernel(const int* __restrict__ cd, Pts in0, Pts mid, Pts bk0, Pts bk1, Pts out,
                          int* __restrict__ order, unsigned* __restrict__ done, int sets, int nslots,
                          int nbuckets, int range_buckets, int seg, FieldConst fc) {
    extern __shared__ int offs[];  // offs[b - b0]: first slot of bucket b; offs[b1 - b0] = hi
    __shared__ int range[2];
    __shared__ int longest;
    __shared__ int depths[33];  // slots of the CTA's share per merge depth, then list cursors
    __shared__ int deeper[33];  // deeper[i]: slots of the share that level i writes
    __shared__ unsigned last;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int s = blockIdx.y;
    const int* c = cd + (long)s * nslots;
    const long ps = (long)sets * nslots, pb = (long)s * nslots;
    const long bs = (long)sets * nbuckets, bb = (long)s * nbuckets;
    const int ranges = gridDim.x / WIDE_CLUSTER;
    const int b0 = (blockIdx.x / WIDE_CLUSTER) * range_buckets, b1 = min(nbuckets, b0 + range_buckets);
    if (threadIdx.x == 0) {
        range[0] = lower_bound(c, 0, nslots, b0);
        range[1] = lower_bound(c, range[0], nslots, b1);
        longest = 0;
    }
    if (threadIdx.x < 33) depths[threadIdx.x] = 0;
    __syncthreads();
    wide_stamp(s, 0);
    const int lo = range[0], hi = range[1];

    // segment bounds, once: each slot t in [lo, hi] starts the buckets after
    // its left neighbour's up to its own (slot hi: up to b1), so every bucket
    // of the range gets its first slot from one adjacent difference
    for (int t = lo + threadIdx.x; t <= hi; t += blockDim.x) {
        const int prev = t == lo ? b0 - 1 : c[t - 1];
        const int cur = t == hi ? b1 : c[t];
        for (int b = prev + 1; b <= cur; ++b) offs[b - b0] = t;
    }
    __syncthreads();
    for (int b = threadIdx.x; b < b1 - b0; b += blockDim.x) atomicMax(&longest, offs[b + 1] - offs[b]);

    // the CTA's share of the range's slots, listed deepest first, so that
    // the lanes level i writes are the first deeper[i] of the list
    const Share slots = cta_share(hi - lo, rank);
    int* list = order + pb + lo + slots.begin;
    for (int t = lo + slots.begin + threadIdx.x; t < lo + slots.end; t += blockDim.x) {
        const int b = c[t] - b0;
        atomicAdd(&depths[merge_depth(t, offs[b], offs[b + 1] - 1)], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int listed = 0;
        for (int k = 32; k >= 1; --k) {
            const int n = depths[k];
            depths[k] = listed;
            listed += n;
            deeper[k - 1] = listed;
        }
    }
    __syncthreads();
    for (int t = lo + slots.begin + threadIdx.x; t < lo + slots.end; t += blockDim.x) {
        const int b = c[t] - b0;
        const int k = merge_depth(t, offs[b], offs[b + 1] - 1);
        if (k > 0) list[atomicAdd(&depths[k], 1)] = t;
    }
    __syncthreads();

    // (1) merge each bucket's partials over the cluster: level i adds lane
    // t - 2^i into lane t for the lanes t >= first + 2^i with end - t a
    // multiple of 2^(i+1). Lane `first` is never written, and every other
    // lane read at level i was written at level 0, so reads go to in0 only
    // at level 0 and for the segment's first lane.
    const int levels = bit_length(longest - 1);
    for (int i = 0; i < levels; ++i) {
        const int d = 1 << i;
        for (int w = threadIdx.x; w < deeper[i]; w += blockDim.x) {
            const int t = list[w];
            const int first = offs[c[t] - b0];
            const jpt p = load_pt_cg(i == 0 ? in0 : mid, pb + t, ps);
            const jpt q = load_pt_cg(i == 0 || t - d == first ? in0 : mid, pb + t - d, ps);
            store_pt(mid, pb + t, ps, jac_add<false>(p.x, p.y, p.z, p.inf, q.x, q.y, q.z, q.inf, fc));
        }
        __threadfence();
        cluster.sync();
    }
    wide_stamp(s, 1);

    // (2) every bucket of the range: its segment's last lane, or infinity
    // with zero coordinates when it has no partial
    const Share own = cta_share(b1 - b0, rank);
    for (int b = b0 + own.begin + threadIdx.x; b < b0 + own.end; b += blockDim.x) {
        const int first = offs[b - b0], end = offs[b - b0 + 1] - 1;
        jpt v;
        if (end < first) {
            v.x = v.y = v.z = fe_zero();
            v.inf = true;
        } else {
            v = load_pt_cg(end == first ? in0 : mid, pb + end, ps);
        }
        store_pt(bk0, bb + b, bs, v);
    }
    __threadfence();
    cluster.sync();
    wide_stamp(s, 2);
    // the segments this cluster scans: with seg < nbuckets (the fused
    // schedule's rounds) every range holds whole segments and each cluster
    // scans its own right away; with one segment (the whole set) the last
    // cluster of the set to finish scans it
    int sb0 = b0, sn = b1 - b0;
    if (seg == nbuckets) {
        if (rank == 0 && threadIdx.x == 0) last = atomicAdd(done + s, 1u) == (unsigned)ranges - 1;
        cluster.sync();
        const bool is_last = *cluster.map_shared_rank(&last, 0) != 0;
        cluster.sync();  // every CTA has read rank 0's word before any may exit
        if (!is_last) return;
        __threadfence();
        sb0 = 0;
        sn = nbuckets;
    }

    // (3)-(4) per segment of seg buckets: the full first suffix scan, then
    // the second only for the lanes that feed the segment's first lane (in
    // place), as in K3b, each level's lanes spread over the cluster's CTAs;
    // no add crosses a segment's end
    const int segs = sn / seg;
    const int sc_levels = max(1, bit_length(seg - 1));
    for (int step = 0; step < 2 * sc_levels; ++step) {
        const bool lane0 = step >= sc_levels;
        const int i = lane0 ? step - sc_levels : step;
        const Pts src = lane0 ? (((sc_levels - 1) & 1) ? bk0 : bk1) : ((i & 1) ? bk1 : bk0);
        const Pts dst = lane0 ? src : ((i & 1) ? bk0 : bk1);
        const int d = 1 << i;
        const int per = lane0 ? (seg + 2 * d - 1) / (2 * d) : seg;  // lanes of a segment at this level
        const Share lanes = cta_share(segs * per, rank);
        for (int t = lanes.begin + threadIdx.x; t < lanes.end; t += blockDim.x) {
            const int j = lane0 ? (t % per) * 2 * d : t % per;
            const int lane = sb0 + (t / per) * seg + j;
            jpt p = load_pt_cg(src, bb + lane, bs);
            if (j + d < seg) {
                const jpt q = load_pt_cg(src, bb + lane + d, bs);
                p = jac_add<false>(p.x, p.y, p.z, p.inf, q.x, q.y, q.z, q.inf, fc);
            }
            store_pt(dst, bb + lane, bs, p);
        }
        __threadfence();
        cluster.sync();
    }
    if (rank == 0) {  // each segment's window sum, lane s * (nbuckets / seg) + its index
        const Pts fin = ((sc_levels - 1) & 1) ? bk0 : bk1;
        const int nseg = nbuckets / seg;
        for (int g = threadIdx.x; g < segs; g += blockDim.x)
            store_pt(out, (long)s * nseg + sb0 / seg + g, (long)sets * nseg, load_pt_cg(fin, bb + sb0 + g * seg, bs));
    }
    wide_stamp(s, 3);
}

// ---------------------------------------------------------------------------
// K3c
// ---------------------------------------------------------------------------
// Lane `src` of this lane's group's value of v.
__device__ __forceinline__ fe fe_group_from(const fe& v, int src) {
    fe r;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) r.v[k] = __shfl_sync(0xffffffffu, v.v[k], src, COMBINE_GROUP);
    return r;
}

// The operand of this lane's role: v[role] for role < N, else v[0] (a
// spare lane computes a product no one reads).
template <int N>
__device__ __forceinline__ fe fe_role(int role, const fe (&v)[N]) {
    fe r = v[0];
#pragma unroll
    for (int i = 1; i < N; ++i) r = fe_select(role == i, v[i], r);
    return r;
}

// jac_dbl's (x, y, z) in place, by the whole group: every lane of the
// group holds the same point and ends with the same result.
__device__ __forceinline__ void coop_dbl(fe& x, fe& y, fe& z, int role, const FieldConst& fc) {
    // level 1: A = X^2, B = Y^2, YZ
    fe p = fe_mul(fe_role<3>(role, {x, y, y}), fe_role<3>(role, {x, y, z}), fc);
    const fe a = fe_group_from(p, 0), b = fe_group_from(p, 1), yz = fe_group_from(p, 2);
    const fe e = fe_add(fe_dbl(a, fc), a, fc);
    // level 2: C = B^2, X B, F = E^2 (D = 2((X + B)^2 - A - C) = 4 X B)
    p = fe_mul(fe_role<3>(role, {b, x, e}), fe_role<3>(role, {b, b, e}), fc);
    const fe c = fe_group_from(p, 0), xb = fe_group_from(p, 1), f = fe_group_from(p, 2);
    const fe d = fe_dbl(fe_dbl(xb, fc), fc);
    const fe x3 = fe_sub(f, fe_dbl(d, fc), fc);
    // level 3: E (D - X3), the same product on every lane
    y = fe_sub(fe_mul(e, fe_sub(d, x3, fc), fc), fe_dbl(fe_dbl(fe_dbl(c, fc), fc), fc), fc);
    x = x3;
    z = fe_dbl(yz, fc);
}

// jac_add<false>(P1, P2) by the whole group, with its selects for P1 ==
// P2, P1 == -P2 and either operand at infinity.
__device__ __forceinline__ jpt coop_add(const jpt& p1, const jpt& p2, int role, const FieldConst& fc) {
    const fe &x1 = p1.x, &y1 = p1.y, &z1 = p1.z, &x2 = p2.x, &y2 = p2.y, &z2 = p2.z;
    // level 1: Z1Z1 = Z1^2, Z2Z2 = Z2^2, (Z1 + Z2)^2, Y1 Z2, Y2 Z1
    const fe zs = fe_add(z1, z2, fc);
    fe p = fe_mul(fe_role<5>(role, {z1, z2, zs, y1, y2}), fe_role<5>(role, {z1, z2, zs, z2, z1}), fc);
    const fe z1z1 = fe_group_from(p, 0), z2z2 = fe_group_from(p, 1), zz = fe_group_from(p, 2);
    const fe t1 = fe_group_from(p, 3), t2 = fe_group_from(p, 4);
    // level 2: U1 = X1 Z2Z2, U2 = X2 Z1Z1, S1 = (Y1 Z2) Z2Z2, S2 = (Y2 Z1) Z1Z1
    p = fe_mul(fe_role<4>(role, {x1, x2, t1, t2}), fe_role<4>(role, {z2z2, z1z1, z2z2, z1z1}), fc);
    const fe u1 = fe_group_from(p, 0), u2 = fe_group_from(p, 1), s1 = fe_group_from(p, 2), s2 = fe_group_from(p, 3);
    const fe h = fe_sub(u2, u1, fc);
    const fe r = fe_dbl(fe_sub(s2, s1, fc), fc);
    const bool h_zero = fe_is_zero(h), r_zero = fe_is_zero(r);
    const fe h2 = fe_dbl(h, fc);
    const fe w = fe_sub(zz, fe_add(z1z1, z2z2, fc), fc);
    const fe k1 = fe_add(fe_add(fe_dbl(u1, fc), u1, fc), h, fc);
    // level 3: I = (2H)^2, r^2, Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H, r (3 U1 + H), S1 H
    p = fe_mul(fe_role<5>(role, {h2, r, w, r, s1}), fe_role<5>(role, {h2, r, h, k1, h}), fc);
    const fe i = fe_group_from(p, 0), r2 = fe_group_from(p, 1), z3 = fe_group_from(p, 2);
    const fe rk = fe_group_from(p, 3), sh = fe_group_from(p, 4);
    // level 4: I (H + 2 U1) = J + 2V, r^3, I (r (3 U1 + H) - 2 S1 H)
    p = fe_mul(fe_role<3>(role, {i, r, i}),
               fe_role<3>(role, {fe_add(h, fe_dbl(u1, fc), fc), r2, fe_sub(rk, fe_dbl(sh, fc), fc)}), fc);
    fe x3 = fe_sub(r2, fe_group_from(p, 0), fc);
    fe y3 = fe_sub(fe_group_from(p, 2), fe_group_from(p, 1), fc);
    fe zo = z3;

    const bool both = !p1.inf && !p2.inf;
    const bool use_dbl = both && h_zero && r_zero;
    const bool cancel = both && h_zero && !r_zero;
    if (__any_sync(0xffffffffu, use_dbl)) {  // rare: P1 == P2 in some chain of the warp
        fe dx = x1, dy = y1, dz = z1;
        coop_dbl(dx, dy, dz, role, fc);
        x3 = fe_select(use_dbl, dx, x3);
        y3 = fe_select(use_dbl, dy, y3);
        zo = fe_select(use_dbl, dz, zo);
    }
    jpt out;
    out.x = fe_select(p2.inf, x1, fe_select(p1.inf, x2, x3));
    out.y = fe_select(p2.inf, y1, fe_select(p1.inf, y2, y3));
    out.z = fe_select(p2.inf, z1, fe_select(p1.inf, z2, zo));
    out.inf = p2.inf ? p1.inf : (p1.inf ? p2.inf : cancel);
    return out;
}

// win: (18, sets * rounds) window sums, lane s * rounds + r = MSM s's round
// r, as K3b-wide writes them for sets * rounds bucket sets. out: (18, sets),
// one point per MSM, which also holds its running sum between rounds: a
// round loads it, doubles it c times in registers, adds its window and
// stores it back (lane 0 of the group; the group's lanes hold the same
// point). (With the sum carried in registers across rounds, cicc of CUDA
// 12.9 crashes on the one-thread kernel.) The sum starts at infinity with
// zero coordinates; a doubling leaves the infinity flag as it is and
// doubles the coordinates, as the lane-wise point_dbl kernel does. Groups
// past the last MSM shadow it and store nothing, so that every lane of the
// warp takes part in the shuffles.
__global__ void __launch_bounds__(COMBINE_THREADS)
window_combine_kernel(Pts win, int sets, int rounds, int c, Pts out, FieldConst fc) {
    const int role = threadIdx.x % COMBINE_GROUP;
    const int s0 = blockIdx.x * (COMBINE_THREADS / COMBINE_GROUP) + threadIdx.x / COMBINE_GROUP;
    const bool owner = s0 < sets && role == 0;
    const int s = s0 < sets ? s0 : sets - 1;
    const long wstride = (long)sets * rounds, wbase = (long)s * rounds;
    jpt acc;
    acc.x = acc.y = acc.z = fe_zero();
    acc.inf = true;
    if (owner) store_pt(out, s, sets, acc);
    __syncwarp();
#pragma unroll 1
    for (int r = rounds - 1; r >= 0; --r) {
        jpt p = load_pt_cg(out, s, sets);
#pragma unroll 1
        for (int k = 0; k < c; ++k) coop_dbl(p.x, p.y, p.z, role, fc);
        const jpt w = load_pt_cg(win, wbase + r, wstride);
        p = coop_add(p, w, role, fc);
        __syncwarp();  // every lane has read the sum before it is replaced
        if (owner) store_pt(out, s, sets, p);
        __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------
// The GLV constants as 9 x 30-bit limbs, passed by value like FieldConst:
// g2, g1 (the Babai multipliers shifted left by 14, so that the quotient by
// 2^270 is the product's high limbs), -b1, b2 and lambda * 2^270 mod r. Only
// the low G2_LIMBS, G1_LIMBS, B1_LIMBS and B2_LIMBS limbs of the first four
// may be non-zero (bb_glv_digits checks this), so for k < r < 2^254 the
// quotients c1 = floor(k g2 / 2^270) < 2^(254 + 90 - 270) and c2 <
// 2^(254 + 150 - 270) have C1_LIMBS and C2_LIMBS limbs, and q1 = c1 (-b1),
// q2 = c2 b2 < 2^224 need no reduction.
#define G2_LIMBS 3
#define G1_LIMBS 5
#define B1_LIMBS 5
#define B2_LIMBS 3
#define C1_LIMBS 3
#define C2_LIMBS 5
struct GlvConst {
    uint32_t g2[FE_LIMBS], g1[FE_LIMBS], minus_b1[FE_LIMBS], b2[FE_LIMBS], lambda[FE_LIMBS];
};

// The low NOUT 30-bit limbs of a * b for an NA-limb a and an NB-limb b,
// carry-propagated. The limb counts are compile-time, so no product of a
// limb known to be zero is issued: a column sums at most min(NA, NB) <= 9
// products of 30-bit limbs (< 2^63.2) in one 64-bit word, and the carry
// into it is < 2^34 (tests/test_torch_msm_digits.py models this).
template <int NA, int NB, int NOUT>
__device__ __forceinline__ void mul_limbs(const uint32_t* a, const uint32_t* b, uint32_t* out) {
    uint64_t carry = 0;
#pragma unroll
    for (int k = 0; k < NOUT; ++k) {
        uint64_t col = carry;
#pragma unroll
        for (int i = (k < NB ? 0 : k - NB + 1); i <= (k < NA ? k : NA - 1); ++i)
            col += (uint64_t)a[i] * b[k - i];
        out[k] = (uint32_t)col & FE_MASK;
        carry = col >> 30;
    }
}

// Digit d of round r as stored: d itself, or with a round offset (the
// fused Pippenger schedule's one bucket set of rounds x 2^(c-1) buckets)
// sign(d) (r * offset + |d|), so that bucket |D| - 1 = r 2^(c-1) + |d| - 1.
__device__ __forceinline__ int round_digit(int d, int r, int offset) {
    return d > 0 ? d + r * offset : (d < 0 ? d - r * offset : 0);
}

// A half (< 2^128, 30-bit limbs; bits above 128 dropped) as ceil(128 / c)
// signed c-bit windows and the final carry, LSB window first: digit r goes
// to out[r * row], and the window borrows 2^c from the next when it reaches
// 2^(c-1), so digits lie in [-2^(c-1), 2^(c-1)] (before the round offset).
__device__ __forceinline__ void store_signed_digits(const fe& h, int c, int offset, int* out, long row) {
    uint64_t lo = (uint64_t)h.v[0] | ((uint64_t)h.v[1] << 30) | ((uint64_t)h.v[2] << 60);
    uint64_t hi = ((uint64_t)h.v[2] >> 4) | ((uint64_t)h.v[3] << 26) | ((uint64_t)(h.v[4] & 0xFFu) << 56);
    const int nwin = (128 + c - 1) / c;
    const uint32_t wmask = (1u << c) - 1, half = 1u << (c - 1);
    uint32_t carry = 0;
    for (int r = 0; r < nwin; ++r) {
        const uint32_t v = ((uint32_t)lo & wmask) + carry;
        carry = v >= half;
        out[r * row] = round_digit((int)v - (int)(carry << c), r, offset);
        lo = (lo >> c) | (hi << (64 - c));
        hi >>= c;
    }
    out[nwin * row] = round_digit((int)carry, nwin, offset);
}

// One thread per scalar j = b * n + i of set b: leave Montgomery form, split
// k = k1 - k2 lambda (mod r) as the JAX package's split_scalars does, and
// store the signed digits of k1 at out[b * m + r * 2n + i] and of k2 at
// out[b * m + r * 2n + n + i] for each round r; the words of each set from
// rounds * 2n up to m are zeroed by the same threads, grid-strided.
__global__ void __launch_bounds__(DIGIT_THREADS)
glv_digits_kernel(const uint32_t* __restrict__ scalars, int* __restrict__ out, int sets, int n, int c,
                  long m, int offset, FieldConst fc, GlvConst gc) {
    const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
    const long total = (long)sets * n;
    const int rounds = (128 + c - 1) / c + 1;
    const long used = (long)rounds * 2 * n, pad = m - used;
    for (long q = j; q < sets * pad; q += (long)gridDim.x * blockDim.x) out[(q / pad) * m + used + q % pad] = 0;
    if (j >= total) return;
    const long b = j / n, i = j % n;

    fe one = fe_zero();
    one.v[0] = 1;
    const fe k = fe_mul(fe_load(scalars + j, total), one, fc);  // the plain value
    uint32_t p1[FE_LIMBS + C1_LIMBS], p2[FE_LIMBS + C2_LIMBS];
    mul_limbs<FE_LIMBS, G2_LIMBS, FE_LIMBS + C1_LIMBS>(k.v, gc.g2, p1);  // c1: the limbs from 9 on
    mul_limbs<FE_LIMBS, G1_LIMBS, FE_LIMBS + C2_LIMBS>(k.v, gc.g1, p2);  // c2
    fe q1 = fe_zero(), q2 = fe_zero(), lam;
    mul_limbs<C1_LIMBS, B1_LIMBS, C1_LIMBS + B1_LIMBS>(p1 + FE_LIMBS, gc.minus_b1, q1.v);  // q1 = c1 (-b1)
    mul_limbs<C2_LIMBS, B2_LIMBS, C2_LIMBS + B2_LIMBS>(p2 + FE_LIMBS, gc.b2, q2.v);
#pragma unroll
    for (int t = 0; t < FE_LIMBS; ++t) lam.v[t] = gc.lambda[t];
    const fe t1 = fe_sub(q2, q1, fc);                       // k2 = t1 mod 2^128
    const fe t2 = fe_add(fe_mul(t1, lam, fc), k, fc);       // k1 = t1 lambda + k mod 2^128
    int* o = out + b * m + i;
    store_signed_digits(t2, c, offset, o, 2L * n);
    store_signed_digits(t1, c, offset, o + n, 2L * n);
}

// ---------------------------------------------------------------------------
extern "C" int bb_bucket_accumulate(const void* table, const void* sidx, const void* sdig,
                                    const void* offsets, void* ocd, void* ox, void* oy, void* oz,
                                    void* oinf, int rounds, int nblocks, int block, int nslots,
                                    int nbuckets, const uint32_t* consts, void* stream) {
    long walks = (long)rounds * nblocks;
    if (walks <= 0) return 0;
    Pts out = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)oinf};
    const unsigned grid = (unsigned)((walks + ACC_THREADS - 1) / ACC_THREADS);
    bucket_accumulate_kernel<<<grid, ACC_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, (const int*)sidx, (const int*)sdig, (const int*)offsets, (int*)ocd,
        out, rounds, nblocks, block, nslots, nbuckets, field_const_from_host(consts));
    return (int)cudaGetLastError();
}

// The walks K3a holds resident at once on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs x ACC_THREADS), into
// *out.
extern "C" int bb_accumulate_capacity(void* out) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_accumulate_kernel, ACC_THREADS, 0);
    *(int*)out = sms * per_sm * ACC_THREADS;
    return (int)err;
}

// scratch32: 6 x 18 x rounds x (nslots + nbuckets) words (two level
// buffers, two bucket buffers); scratch8: 2 x rounds x (nslots + nbuckets)
// flag bytes.
extern "C" int bb_bucket_reduce(const void* cd, const void* px, const void* py, const void* pz,
                                const void* pinf, void* scratch32, void* scratch8, void* ox,
                                void* oy, void* oz, void* oinf, int rounds, int nslots,
                                int nbuckets, const uint32_t* consts, void* stream) {
    if (rounds <= 0) return 0;
    const long ps = 18L * rounds * nslots, bs = 18L * rounds * nbuckets;
    uint32_t* w = (uint32_t*)scratch32;
    uint8_t* f = (uint8_t*)scratch8;
    Pts in0 = {(uint32_t*)px, (uint32_t*)py, (uint32_t*)pz, (uint8_t*)pinf};
    Pts ping = {w, w + ps, w + 2 * ps, f};
    Pts pong = {w + 3 * ps, w + 4 * ps, w + 5 * ps, f + (long)rounds * nslots};
    uint32_t* wb = w + 6 * ps;
    uint8_t* fb = f + 2L * rounds * nslots;
    Pts bk0 = {wb, wb + bs, wb + 2 * bs, fb};
    Pts bk1 = {wb + 3 * bs, wb + 4 * bs, wb + 5 * bs, fb + (long)rounds * nbuckets};
    Pts out = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)oinf};
    const size_t smem = 2 * (size_t)nslots;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(bucket_reduce_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    bucket_reduce_kernel<<<rounds, REDUCE_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)cd, in0, ping, pong, bk0, bk1, out, rounds, nslots, nbuckets,
        field_const_from_host(consts));
    return (int)cudaGetLastError();
}

// scratch32: 3 x 18 x sets x nslots words (the merge's buffer), 6 x 18 x
// sets x nbuckets (two bucket buffers), then sets x nslots (the slot
// lists); scratch8: sets x (nslots + 2 x nbuckets) flag bytes; done: sets
// zeroed words.
// seg: the suffix scans' segment, nbuckets (one window sum per set) or a
// divisor of nbuckets and of range_buckets (one per segment: the fused
// schedule's rounds); out: (18, sets x nbuckets / seg).
extern "C" int bb_bucket_reduce_wide(const void* cd, const void* px, const void* py, const void* pz,
                                     const void* pinf, void* scratch32, void* scratch8, void* done,
                                     void* ox, void* oy, void* oz, void* oinf, int sets, int nslots,
                                     int nbuckets, int range_buckets, int seg, const uint32_t* consts,
                                     void* stream) {
    if (sets <= 0) return 0;
    if (nslots <= 0 || nbuckets <= 0 || range_buckets <= 0) return (int)cudaErrorInvalidValue;
    if (range_buckets > nbuckets) range_buckets = nbuckets;
    if (seg <= 0 || nbuckets % seg || (seg < nbuckets && range_buckets % seg)) return (int)cudaErrorInvalidValue;
    const long ps = 18L * sets * nslots, bs = 18L * sets * nbuckets;
    uint32_t* w = (uint32_t*)scratch32;
    uint8_t* f = (uint8_t*)scratch8;
    Pts in0 = {(uint32_t*)px, (uint32_t*)py, (uint32_t*)pz, (uint8_t*)pinf};
    Pts mid = {w, w + ps, w + 2 * ps, f};
    uint32_t* wb = w + 3 * ps;
    uint8_t* fb = f + (long)sets * nslots;
    Pts bk0 = {wb, wb + bs, wb + 2 * bs, fb};
    Pts bk1 = {wb + 3 * bs, wb + 4 * bs, wb + 5 * bs, fb + (long)sets * nbuckets};
    Pts out = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)oinf};
    int* order = (int*)(wb + 6 * bs);
    const size_t smem = sizeof(int) * ((size_t)range_buckets + 1);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(bucket_reduce_wide_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int ranges = (nbuckets + range_buckets - 1) / range_buckets;
    const dim3 grid((unsigned)(WIDE_CLUSTER * ranges), (unsigned)sets);
    bucket_reduce_wide_kernel<<<grid, REDUCE_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)cd, in0, mid, bk0, bk1, out, order, (unsigned*)done, sets, nslots, nbuckets,
        range_buckets, seg, field_const_from_host(consts));
    return (int)cudaGetLastError();
}

// The most clusters of bucket_reduce_wide_kernel resident on the device at
// once (cudaOccupancyMaxActiveClusters) with range_buckets buckets per
// cluster, into *out.
extern "C" int bb_wide_max_clusters(int range_buckets, void* out) {
    const size_t smem = sizeof(int) * ((size_t)range_buckets + 1);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(bucket_reduce_wide_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(WIDE_CLUSTER, 1, 1);
    cfg.blockDim = dim3(REDUCE_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    return (int)cudaOccupancyMaxActiveClusters((int*)out, (const void*)bucket_reduce_wide_kernel, &cfg);
}

// scalars: (18, sets * n) internal-Montgomery Fr limbs; out: (sets, m) int32
// with m >= rounds * 2n; fr_consts: Fr's 19 FieldConst words; glv_consts:
// the 45 GlvConst words.
// offset: 0, or the fused schedule's buckets per round (round_digit).
extern "C" int bb_glv_digits(const void* scalars, void* out, int sets, int n, int c, long m, int offset,
                             const uint32_t* fr_consts, const uint32_t* glv_consts, void* stream) {
    if (sets <= 0 || n <= 0) return 0;
    if (c < 1 || c > 30 || m < ((128L + c - 1) / c + 1) * 2 * n || offset < 0) return (int)cudaErrorInvalidValue;
    if ((long)offset * ((128 + c - 1) / c + 1) + (1L << (c - 1)) > 0x7FFFFFFFL) return (int)cudaErrorInvalidValue;
    GlvConst gc;
    uint32_t* w = (uint32_t*)&gc;
    for (int t = 0; t < 5 * FE_LIMBS; ++t) w[t] = glv_consts[t];
    const int widths[4] = {G2_LIMBS, G1_LIMBS, B1_LIMBS, B2_LIMBS};
    for (int v = 0; v < 4; ++v)  // the kernel skips the limbs above each constant's width
        for (int t = widths[v]; t < FE_LIMBS; ++t)
            if (w[v * FE_LIMBS + t] != 0) return (int)cudaErrorInvalidValue;
    const long total = (long)sets * n;
    const unsigned grid = (unsigned)((total + DIGIT_THREADS - 1) / DIGIT_THREADS);
    glv_digits_kernel<<<grid, DIGIT_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)scalars, (int*)out, sets, n, c, m, offset, field_const_from_host(fr_consts), gc);
    return (int)cudaGetLastError();
}

extern "C" int bb_window_combine(const void* wx, const void* wy, const void* wz, const void* winf,
                                 void* ox, void* oy, void* oz, void* oinf, int sets, int rounds, int c,
                                 const uint32_t* consts, void* stream) {
    if (sets <= 0 || rounds <= 0 || c < 0) return (int)cudaErrorInvalidValue;
    Pts win = {(uint32_t*)wx, (uint32_t*)wy, (uint32_t*)wz, (uint8_t*)winf};
    Pts out = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)oinf};
    const int chains = COMBINE_THREADS / COMBINE_GROUP;
    const unsigned grid = (unsigned)((sets + chains - 1) / chains);
    window_combine_kernel<<<grid, COMBINE_THREADS, 0, (cudaStream_t)stream>>>(win, sets, rounds, c, out,
                                                                             field_const_from_host(consts));
    return (int)cudaGetLastError();
}
