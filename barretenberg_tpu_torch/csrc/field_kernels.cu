// K1: lane-wise field ops over planar limb arrays: mul, sqr, add, sub, and
// pow (a^e for an exponent the host knows, the whole square-and-multiply
// chain in one launch). One thread per lane; operands are addressed by
// (limb stride, lane stride) so a broadcast (18, 1) operand (lane stride 0)
// or a strided view needs no materialised copy. And scan: a whole inclusive
// prefix (or suffix) product, or the affine recurrence d_i = m_i d_{i-1} +
// b_i, along each row of an (18, rows, n) array in one launch. And dot (B
// rows against one table, each multiplied lane by lane and summed, in one
// launch) and lincomb (a linear combination of J arrays with host-known
// scalars, in one launch). Plain C interface for ctypes; see field.cuh.
#include <cuda_runtime.h>

#include "field.cuh"

enum FieldOp { OP_MUL = 0, OP_SQR = 1, OP_ADD = 2, OP_SUB = 3 };

template <int OP>
__global__ void __launch_bounds__(256)
field_op_kernel(const uint32_t* __restrict__ a, long a_ls, long a_ns,
                const uint32_t* __restrict__ b, long b_ls, long b_ns,
                uint32_t* __restrict__ out, long n, FieldConst fc) {
    long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    fe x = fe_load(a + lane * a_ns, a_ls);
    fe r;
    if (OP == OP_SQR) {
        r = fe_sqr(x, fc);
    } else {
        fe y = fe_load(b + lane * b_ns, b_ls);
        if (OP == OP_MUL) r = fe_mul(x, y, fc);
        else if (OP == OP_ADD) r = fe_add(x, y, fc);
        else r = fe_sub(x, y, fc);
    }
    fe_store(out + lane, n, r);
}

// The exponent of field_pow, by value: bit i is (w[i / 32] >> (i % 32)) & 1;
// nbits is its bit length (0 for the exponent 0).
#define EXP_WORDS 8
struct Exponent {
    uint32_t w[EXP_WORDS];
    int nbits;
};

// a^e per lane: square-and-multiply over e's bits, most significant first.
// The first (set) bit starts the accumulator at a, so e = 1 returns a; e = 0
// returns one; 0^e = 0 for e > 0. The chain of 253 squarings and 109-126
// multiplications of an inversion is serial in each lane: the accumulator
// stays in registers, the loop stays rolled (one inlined copy of fe_mul for
// the squaring and one for the multiply), and every lane reads the same
// exponent bit, so a warp never diverges.
__global__ void __launch_bounds__(256)
field_pow_kernel(const uint32_t* __restrict__ a, long a_ls, long a_ns,
                 uint32_t* __restrict__ out, long n, Exponent e, FieldConst fc) {
    long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const fe x = fe_load(a + lane * a_ns, a_ls);
    fe acc = e.nbits == 0 ? fe_one(fc) : x;
#pragma unroll 1
    for (int i = e.nbits - 2; i >= 0; --i) {
        acc = fe_sqr(acc, fc);
        if ((e.w[i >> 5] >> (i & 31)) & 1u) acc = fe_mul(acc, x, fc);
    }
    fe_store(out + lane, n, acc);
}

// ---------------------------------------------------------------------------
// scan
// ---------------------------------------------------------------------------
// A scan value: (m) for a product, (m, b) for the affine recurrence, whose
// combine of an earlier f and a later s is (m_s m_f, m_s b_f + b_s). Field
// products and sums are exact and fe_mul's output canonical, so every
// association gives the same limbs: the tiles, warps and threads below
// group the combines as they like and still equal the plain version's
// Hillis-Steele levels bit for bit.
//
// What bounds a scan on the card is the dependent chain of combines of a
// tile, since a combine costs a warp ~1,000 cycles of issue (one or two
// fe_mul) and the card has 528 warp schedulers: at 2^16 the whole scan is
// ~8 products a scheduler, while a tile's chain is its thread's items, the
// warp's shuffle levels, the warps' totals, the look-back and the final
// combines. The plan (the wrapper's scan_plan) picks the tile from the row:
// a row of at most 32 elements is one warp of one element a lane; one of at
// most SCAN_THREADS x SCAN_MAX_ITEMS is one CTA with the fewest items a
// thread that cover it; neither has a look-back or flags. Longer rows take
// tiles of SCAN_THREADS threads of 4 items while all tiles fit on the SMs
// at once (2^16: 128 tiles on 132 SMs), else of SCAN_MAX_ITEMS, chained by
// a decoupled look-back in which each lane of warp 0 folds a block of up to
// SCAN_LOOK_ITEMS earlier tiles, so a window covers 128 tiles and a tile
// reaches its prefix in about 8 combines even while no earlier tile has
// published its inclusive prefix yet.
enum ScanMode { SCAN_PROD = 0, SCAN_AFFINE = 1 };

#define SCAN_THREADS 128                          // threads of a tiled CTA
#define SCAN_MAX_ITEMS 8                          // consecutive elements per thread, at most
#define SCAN_LOOK_ITEMS 4                         // earlier tiles a look-back lane folds per step
#define SCAN_WARPS (SCAN_THREADS / 32)
#define SCAN_PAD(e) ((e) + ((e) >> 5))            // one spare word per 32: conflict-free
#define SCAN_EXTRA 16                             // slots after the tile: warp totals, prefixes
enum { FLAG_NONE = 0, FLAG_AGG = 1, FLAG_INC = 2 };

template <int MODE>
struct Sv {
    fe m, b;
};

template <int MODE>
__device__ __forceinline__ Sv<MODE> sv_identity(const FieldConst& fc) {
    Sv<MODE> r;
    r.m = fe_one(fc);
    r.b = fe_zero();
    return r;
}

// f earlier, s later.
template <int MODE>
__device__ __forceinline__ Sv<MODE> sv_combine(const Sv<MODE>& f, const Sv<MODE>& s, const FieldConst& fc) {
    Sv<MODE> r;
    r.m = fe_mul(s.m, f.m, fc);
    r.b = MODE == SCAN_AFFINE ? fe_add(fe_mul(s.m, f.b, fc), s.b, fc) : s.b;
    return r;
}

// Shared memory: word k of component c of slot e at sm[(c * 9 + k) * slots + SCAN_PAD(e)].
template <int MODE>
__device__ __forceinline__ void sv_put(uint32_t* sm, int slots, int e, const Sv<MODE>& v) {
    const int p = SCAN_PAD(e);
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) sm[k * slots + p] = v.m.v[k];
    if (MODE == SCAN_AFFINE) {
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k) sm[(FE_LIMBS + k) * slots + p] = v.b.v[k];
    }
}

template <int MODE>
__device__ __forceinline__ Sv<MODE> sv_get(const uint32_t* sm, int slots, int e) {
    const int p = SCAN_PAD(e);
    Sv<MODE> v;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) v.m.v[k] = sm[k * slots + p];
    if (MODE == SCAN_AFFINE) {
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k) v.b.v[k] = sm[(FE_LIMBS + k) * slots + p];
    }
    return v;
}

// __shfl_up_sync (UP) or __shfl_down_sync of every word.
template <int MODE, bool UP>
__device__ __forceinline__ Sv<MODE> sv_shfl(const Sv<MODE>& v, int d) {
    Sv<MODE> r;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k)
        r.m.v[k] = UP ? __shfl_up_sync(0xffffffffu, v.m.v[k], d) : __shfl_down_sync(0xffffffffu, v.m.v[k], d);
    if (MODE == SCAN_AFFINE) {
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k)
            r.b.v[k] = UP ? __shfl_up_sync(0xffffffffu, v.b.v[k], d) : __shfl_down_sync(0xffffffffu, v.b.v[k], d);
    }
    return r;
}

template <int MODE>
__device__ __forceinline__ Sv<MODE> sv_shfl_idx(const Sv<MODE>& v, int src) {
    Sv<MODE> r;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) r.m.v[k] = __shfl_sync(0xffffffffu, v.m.v[k], src);
    if (MODE == SCAN_AFFINE) {
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k) r.b.v[k] = __shfl_sync(0xffffffffu, v.b.v[k], src);
    }
    return r;
}

// A tile's published value (its total, or its inclusive prefix in the row):
// 18 words per slot, written by one thread before its flag, read through L2.
template <int MODE>
__device__ __forceinline__ void sv_publish(uint32_t* slot, const Sv<MODE>& v) {
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) slot[k] = v.m.v[k];
    if (MODE == SCAN_AFFINE) {
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k) slot[FE_LIMBS + k] = v.b.v[k];
    }
}

template <int MODE>
__device__ __forceinline__ Sv<MODE> sv_read(const uint32_t* slot) {
    Sv<MODE> v;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) v.m.v[k] = __ldcg(slot + k);
    if (MODE == SCAN_AFFINE) {
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k) v.b.v[k] = __ldcg(slot + FE_LIMBS + k);
    }
    return v;
}

struct ScanArgs {
    const uint32_t* a;  // the product's operand, or m
    long a_ls, a_rs, a_ns;
    const uint32_t* b;  // the affine recurrence's b
    long b_ls, b_rs, b_ns;
    uint32_t* out;      // (18, rows, n), contiguous
    int rows;
    long n;
    int items;          // consecutive elements per thread
    int tiles;          // tiles per row; 1: one CTA a row, no look-back
    int slots;          // words between two limb rows of shared memory
    int reverse;        // 1: suffix scan (the product only)
    int* state;         // tiles > 1: [0] the next tile to take, [1] CTAs done,
                        // [2 + i] tile i's FLAG_*; zero at launch, left zero
    uint32_t* agg;      // (rows * tiles, 18) tile totals, in a buffer of their
    uint32_t* inc;      // (rows * tiles, 18) inclusive prefixes    own (no flag
                        // of a later, longer launch may land on stale data)
};

// Warp 0 of tile t > 0 of a row: what precedes the tile. Lane L folds the
// `per` tiles look - L per, ..., look - L per - per + 1 (nearest first,
// stopping at an inclusive prefix or at the row's start); lanes past the
// first that stopped take the identity, the warp folds the lanes (lane L
// holds later tiles than lane L + 1), and the next step starts below the
// window unless a lane stopped.
template <int MODE>
__device__ __forceinline__ Sv<MODE> scan_look_back(const ScanArgs& s, int row0, int t, const Sv<MODE>& ident,
                                                   const FieldConst& fc) {
    const int lane = threadIdx.x & 31;
    volatile int* flags = s.state + 2;
    Sv<MODE> excl = ident;
    int look = t - 1;
#pragma unroll 1
    while (true) {
        const int per = min((look + 32) / 32, SCAN_LOOK_ITEMS);
        const int hi = look - lane * per;
        Sv<MODE> v = ident;
        bool stop = false;
#pragma unroll 1
        for (int j = 0; j < per; ++j) {
            const int k = hi - j;
            if (k < 0) {
                stop = true;
                break;
            }
            // the tile's CTA is running and publishes within microseconds; a
            // flag still unset after ~2^22 polls is a fault: abort the
            // launch rather than hang the card
            int f, polls = 0;
            do {
                f = flags[row0 + k];
                if (++polls == (1 << 22)) __trap();
            } while (f == FLAG_NONE);
            __threadfence();
            v = sv_combine<MODE>(sv_read<MODE>((f == FLAG_INC ? s.inc : s.agg) + (long)(row0 + k) * 2 * FE_LIMBS), v, fc);
            if (f == FLAG_INC) {
                stop = true;
                break;
            }
        }
        const unsigned stops = __ballot_sync(0xffffffffu, stop);
        const int first = stops ? __ffs(stops) - 1 : 31;  // lanes 0..first count
        if (lane > first) v = ident;
#pragma unroll 1
        for (int d = 1; d <= first; d <<= 1) {
            const Sv<MODE> o = sv_shfl<MODE, false>(v, d);
            if (lane + d < 32) v = sv_combine<MODE>(o, v, fc);
        }
        excl = sv_combine<MODE>(v, excl, fc);  // lane 0's is the one kept
        if (stops) return excl;
        look -= 32 * per;
    }
}

// One CTA per tile of blockDim.x x items consecutive elements of one row.
// Chained tiles (tiles > 1) are taken in the order CTAs start (an atomic
// counter), so every tile a CTA waits on belongs to a CTA already running.
// The CTA loads its tile into shared memory (coalesced), each thread scans
// its items serially, the thread totals are scanned across each warp with
// shuffles and warp 0 scans the warp totals by shuffles; a chained tile
// publishes its total at once, warp 0 looks back for what precedes it
// (scan_look_back) and publishes its inclusive prefix. Every element then
// takes its prefix with one combine and the tile is stored coalesced. The
// last CTA of a chained launch to finish clears the flags and counters for
// the next launch on the stream.
template <int MODE>
__global__ void __launch_bounds__(SCAN_THREADS)
field_scan_kernel(ScanArgs s, FieldConst fc) {
    extern __shared__ uint32_t sm[];
    __shared__ int tile_id;
    __shared__ bool last;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nthreads = blockDim.x, nwarps = nthreads >> 5, items = s.items, slots = s.slots;
    const int tile = nthreads * items;
    const int slot_wtot = tile, slot_wex = tile + SCAN_WARPS, slot_excl = tile + 2 * SCAN_WARPS;
    const bool chained = s.tiles > 1;
    if (chained) {
        if (tid == 0) tile_id = atomicAdd(s.state, 1);
        __syncthreads();
    }
    const int id = chained ? tile_id : (int)blockIdx.x;
    const int row = id / s.tiles, t = id % s.tiles;
    const long first = (long)t * tile;
    const Sv<MODE> ident = sv_identity<MODE>(fc);

    // load the tile (positions past n hold the identity)
    for (int e = tid; e < tile; e += nthreads) {
        const long pos = first + e;
        Sv<MODE> x = ident;
        if (pos < s.n) {
            const long i = s.reverse ? s.n - 1 - pos : pos;
            x.m = fe_load(s.a + row * s.a_rs + i * s.a_ns, s.a_ls);
            if (MODE == SCAN_AFFINE) x.b = fe_load(s.b + row * s.b_rs + i * s.b_ns, s.b_ls);
        }
        sv_put<MODE>(sm, slots, e, x);
    }
    __syncthreads();

    // each thread's run, inclusive, in place
    const int e0 = tid * items;
    Sv<MODE> run = sv_get<MODE>(sm, slots, e0);
#pragma unroll 1
    for (int j = 1; j < items; ++j) {
        run = sv_combine<MODE>(run, sv_get<MODE>(sm, slots, e0 + j), fc);
        sv_put<MODE>(sm, slots, e0 + j, run);
    }
    // the warp's inclusive scan of the thread totals; a one-warp CTA stops
    // at the last lane that holds an element (its total is not needed)
    const long live = (s.n - first + items - 1) / items;
    const int levels_to = nwarps == 1 && live < 32 ? (int)live : 32;
#pragma unroll 1
    for (int d = 1; d < levels_to; d <<= 1) {
        const Sv<MODE> o = sv_shfl<MODE, true>(run, d);
        if (lane >= d) run = sv_combine<MODE>(o, run, fc);
    }
    Sv<MODE> lane_ex = sv_shfl<MODE, true>(run, 1);
    if (lane == 0) lane_ex = ident;
    if (lane == 31) sv_put<MODE>(sm, slots, slot_wtot + warp, run);
    __syncthreads();

    // warp 0: the warp totals' exclusive scan, the tile's total, and for a
    // chained tile its publication and look-back
    if (warp == 0) {
        Sv<MODE> wt = lane < nwarps ? sv_get<MODE>(sm, slots, slot_wtot + lane) : ident;
#pragma unroll 1
        for (int d = 1; d < nwarps; d <<= 1) {
            const Sv<MODE> o = sv_shfl<MODE, true>(wt, d);
            if (lane >= d) wt = sv_combine<MODE>(o, wt, fc);
        }
        Sv<MODE> wex = sv_shfl<MODE, true>(wt, 1);
        if (lane == 0) wex = ident;
        if (lane < nwarps) sv_put<MODE>(sm, slots, slot_wex + lane, wex);
        Sv<MODE> excl = ident;
        if (chained) {
            const Sv<MODE> agg = sv_shfl_idx<MODE>(wt, nwarps - 1);
            uint32_t* my_agg = s.agg + (long)id * 2 * FE_LIMBS;
            uint32_t* my_inc = s.inc + (long)id * 2 * FE_LIMBS;
            volatile int* flags = s.state + 2;
            if (lane == 0) {
                sv_publish<MODE>(t == 0 ? my_inc : my_agg, agg);
                __threadfence();
                flags[id] = t == 0 ? FLAG_INC : FLAG_AGG;
            }
            if (t > 0) {
                excl = scan_look_back<MODE>(s, id - t, t, ident, fc);
                if (lane == 0) {
                    sv_publish<MODE>(my_inc, sv_combine<MODE>(excl, agg, fc));
                    __threadfence();
                    flags[id] = FLAG_INC;
                }
            }
        }
        if (lane == 0) sv_put<MODE>(sm, slots, slot_excl, excl);
    }
    __syncthreads();

    // every element takes what precedes its thread's run
    const Sv<MODE> pre = sv_combine<MODE>(
        sv_combine<MODE>(sv_get<MODE>(sm, slots, slot_excl), sv_get<MODE>(sm, slots, slot_wex + warp), fc),
        lane_ex, fc);
#pragma unroll 1
    for (int j = 0; j < items; ++j)
        sv_put<MODE>(sm, slots, e0 + j, sv_combine<MODE>(pre, sv_get<MODE>(sm, slots, e0 + j), fc));
    __syncthreads();

    // store the tile (coalesced): the product, or the recurrence's d
    const long ls = (long)s.rows * s.n;
    for (int e = tid; e < tile; e += nthreads) {
        const long pos = first + e;
        if (pos >= s.n) break;
        const long i = s.reverse ? s.n - 1 - pos : pos;
        const Sv<MODE> v = sv_get<MODE>(sm, slots, e);
        fe_store(s.out + row * s.n + i, ls, MODE == SCAN_AFFINE ? v.b : v.m);
    }

    // the last CTA to finish leaves the state zero for the next launch: every
    // other CTA has taken its tile and ended its look-back
    if (chained) {
        const int total = s.rows * s.tiles;
        if (tid == 0) {
            __threadfence();
            last = atomicAdd(s.state + 1, 1) == total - 1;
        }
        __syncthreads();
        if (last) {
            __threadfence();
            for (int i = tid; i < total; i += nthreads) s.state[2 + i] = FLAG_NONE;
            if (tid == 0) {
                s.state[0] = 0;
                s.state[1] = 0;
            }
        }
    }
}

template <int MODE>
static int launch_scan(const ScanArgs& args, int threads, const FieldConst& fc, cudaStream_t stream) {
    const size_t smem = sizeof(uint32_t) * (MODE == SCAN_AFFINE ? 2 : 1) * FE_LIMBS * args.slots;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(field_scan_kernel<MODE>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    field_scan_kernel<MODE><<<(unsigned)((long)args.rows * args.tiles), threads, smem, stream>>>(args, fc);
    return (int)cudaGetLastError();
}

// mode: 0 the product of a (reverse: 1 for the suffix product; b unused),
// 1 the affine recurrence with m = a. Element i of row r of an operand is
// at base + r * rs + i * ns, limb stride ls; out is (18, rows, n)
// contiguous. The plan (scan_plan in kernels/field_kernels.py): threads
// (32, or SCAN_THREADS), items per thread (1, 2, 4 or 8) and tiles per row,
// ceil(n / (threads x items)). With tiles > 1: state, state_words int32
// words, zero, that the launch leaves zero - 2 counters and a flag per tile,
// 2 + rows x tiles words; data, data_words words of any content - each
// tile's total and inclusive prefix, 18 words each, 36 per tile (both
// unused, and may be null, when tiles == 1).
extern "C" int bb_field_scan(int mode, int reverse, const void* a, long a_ls, long a_rs, long a_ns,
                             const void* b, long b_ls, long b_rs, long b_ns, void* out, int rows, long n,
                             int threads, int items, long tiles, void* state, long state_words, void* data,
                             long data_words, const uint32_t* consts, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (mode == SCAN_AFFINE && reverse) return (int)cudaErrorInvalidValue;
    if ((threads != 32 && threads != SCAN_THREADS) || items < 1 || items > SCAN_MAX_ITEMS || (items & (items - 1)))
        return (int)cudaErrorInvalidValue;
    const long tile = (long)threads * items;
    if (tiles != (n + tile - 1) / tile || (long)rows * tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
    if (tiles > 1 && (threads != SCAN_THREADS || state == nullptr || data == nullptr ||
                      state_words < 2 + (long)rows * tiles || data_words < (long)rows * tiles * 4 * FE_LIMBS))
        return (int)cudaErrorInvalidValue;
    ScanArgs args;
    args.a = (const uint32_t*)a;
    args.a_ls = a_ls;
    args.a_rs = a_rs;
    args.a_ns = a_ns;
    args.b = (const uint32_t*)b;
    args.b_ls = b_ls;
    args.b_rs = b_rs;
    args.b_ns = b_ns;
    args.out = (uint32_t*)out;
    args.rows = rows;
    args.n = n;
    args.items = items;
    args.tiles = (int)tiles;
    args.slots = SCAN_PAD((int)tile + SCAN_EXTRA);
    args.reverse = reverse;
    args.state = (int*)state;
    args.agg = (uint32_t*)data;
    args.inc = tiles > 1 ? args.agg + (long)rows * tiles * 2 * FE_LIMBS : nullptr;
    const FieldConst fc = field_const_from_host(consts);
    cudaStream_t st = (cudaStream_t)stream;
    switch (mode) {
        case SCAN_PROD: return launch_scan<SCAN_PROD>(args, threads, fc, st);
        case SCAN_AFFINE: return launch_scan<SCAN_AFFINE>(args, threads, fc, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// dot
// ---------------------------------------------------------------------------
// out[:, r] = sum_i rows[r][:, i] * table[:, i] (Montgomery products, field
// sum) for B rows of n lanes against one table: a batch of polynomial
// evaluations against one power table. The grid is (CTAs per row, B): each
// thread sums its grid-stride lanes of its CTA's row with one accumulator
// in registers (B accumulators a thread held 130-168 registers and ran at
// 3 CTAs an SM; the rows' CTAs re-read the table through L2 instead); the
// warp folds its threads' sums by shuffles, warp 0 folds the warps' sums
// from shared memory, and each CTA writes its partial to global scratch and
// takes its row's ticket; the CTA that takes a row's last ticket folds that
// row's partials the same way, writes the row's sum and resets the ticket
// for the next launch on the stream. Field sums are exact and fe_add
// canonical, so any grouping gives the plain tree's limbs bit for bit.
#define DOT_THREADS 128
#define DOT_WARPS (DOT_THREADS / 32)
#define DOT_MAX_ROWS 8   // rows per launch: the wrapper splits a larger batch

// The rows by value: row r's element i, limb k at p[r][k * ls[r] + i * ns[r]].
struct DotRows {
    const uint32_t* p[DOT_MAX_ROWS];
    long ls[DOT_MAX_ROWS];
    long ns[DOT_MAX_ROWS];
};

// Lane 0 of each warp ends with the sum of its first `width` lanes (a lane
// reading past the warp's end gets its own value back, which lane 0 never
// reads).
__device__ __forceinline__ fe dot_shfl_sum(fe acc, int width, const FieldConst& fc) {
#pragma unroll 1
    for (int d = width / 2; d > 0; d >>= 1) {
        fe o;
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k) o.v[k] = __shfl_down_sync(0xffffffffu, acc.v[k], d);
        acc = fe_add(acc, o, fc);
    }
    return acc;
}

// Thread 0's result is the sum of every thread's acc. sm: DOT_WARPS * 9
// words, free on entry, read until the caller's next __syncthreads.
__device__ __forceinline__ fe dot_cta_sum(fe acc, uint32_t* sm, const FieldConst& fc) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    acc = dot_shfl_sum(acc, 32, fc);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k) sm[warp * FE_LIMBS + k] = acc.v[k];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k) acc.v[k] = lane < DOT_WARPS ? sm[lane * FE_LIMBS + k] : 0u;
        acc = dot_shfl_sum(acc, DOT_WARPS, fc);
    }
    return acc;
}

// tickets: one per row, zero at launch and again at the end; partials:
// gridDim.y * gridDim.x * 9 words.
__global__ void __launch_bounds__(DOT_THREADS)
field_dot_kernel(const __grid_constant__ DotRows rows, const uint32_t* __restrict__ t, long t_ls, long t_ns,
                 uint32_t* __restrict__ out, long o_ls, long o_ns, long n,
                 unsigned* tickets, uint32_t* partials, FieldConst fc) {
    __shared__ uint32_t sm[DOT_WARPS * FE_LIMBS];
    __shared__ bool last;
    const int r = blockIdx.y;
    const uint32_t* row = rows.p[r];
    const long r_ls = rows.ls[r], r_ns = rows.ns[r];
    fe acc = fe_zero();
    const long step = (long)gridDim.x * DOT_THREADS;
#pragma unroll 1
    for (long i = (long)blockIdx.x * DOT_THREADS + threadIdx.x; i < n; i += step)
        acc = fe_add(acc, fe_mul(fe_load(row + i * r_ns, r_ls), fe_load(t + i * t_ns, t_ls), fc), fc);
    acc = dot_cta_sum(acc, sm, fc);
    uint32_t* mine = partials + (long)r * gridDim.x * FE_LIMBS;
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k) mine[(long)blockIdx.x * FE_LIMBS + k] = acc.v[k];
        __threadfence();
        last = atomicAdd(tickets + r, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    // the row's last CTA: every other CTA of the row has written and fenced its partial
    __threadfence();
    acc = fe_zero();
#pragma unroll 1
    for (int c = threadIdx.x; c < (int)gridDim.x; c += DOT_THREADS) {
        fe v;
#pragma unroll
        for (int k = 0; k < FE_LIMBS; ++k) v.v[k] = __ldcg(mine + (long)c * FE_LIMBS + k);
        acc = fe_add(acc, v, fc);
    }
    acc = dot_cta_sum(acc, sm, fc);
    if (threadIdx.x == 0) {
        fe_store(out + r * o_ns, o_ls, acc);
        tickets[r] = 0u;
    }
}

// ---------------------------------------------------------------------------
// lincomb
// ---------------------------------------------------------------------------
// out[:, i] = sum_j s_j * a_j[:, i] for J arrays of n lanes and host-known
// scalars s_j (internal Montgomery form, so fe_mul gives value(a_j) s_j).
// One thread per lane (grid-stride), the sum in registers; the terms
// arrive by value and are read from the constant bank (__grid_constant__,
// no per-thread copy), so each operand is read once and the result written
// once, neighbouring threads on neighbouring addresses of each limb row.
#define LINCOMB_THREADS 256
#define LINCOMB_MAX_TERMS 12  // terms per launch: the wrapper splits a longer list

struct LincombTerms {
    const uint32_t* p[LINCOMB_MAX_TERMS];
    long ls[LINCOMB_MAX_TERMS];
    long ns[LINCOMB_MAX_TERMS];
    uint32_t s[LINCOMB_MAX_TERMS][FE_LIMBS];
    int count;
};

__global__ void __launch_bounds__(LINCOMB_THREADS)
field_lincomb_kernel(const __grid_constant__ LincombTerms terms, uint32_t* __restrict__ out, long n,
                     FieldConst fc) {
    const long step = (long)gridDim.x * LINCOMB_THREADS;
#pragma unroll 1
    for (long i = (long)blockIdx.x * LINCOMB_THREADS + threadIdx.x; i < n; i += step) {
        fe acc = fe_zero();
#pragma unroll 1
        for (int j = 0; j < terms.count; ++j) {
            fe s;
#pragma unroll
            for (int k = 0; k < FE_LIMBS; ++k) s.v[k] = terms.s[j][k];
            acc = fe_add(acc, fe_mul(fe_load(terms.p[j] + i * terms.ns[j], terms.ls[j]), s, fc), fc);
        }
        fe_store(out + i, n, acc);
    }
}

// consts: 19 words = p[9], one[9], ninv (30-bit limbs), host memory.
extern "C" int bb_field_op(int op, const void* a, long a_ls, long a_ns,
                           const void* b, long b_ls, long b_ns,
                           void* out, long n, const uint32_t* consts, void* stream) {
    if (n <= 0) return 0;
    FieldConst fc = field_const_from_host(consts);
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* pa = (const uint32_t*)a;
    const uint32_t* pb = (const uint32_t*)b;
    uint32_t* po = (uint32_t*)out;
    switch (op) {
        case OP_MUL: field_op_kernel<OP_MUL><<<blocks, threads, 0, s>>>(pa, a_ls, a_ns, pb, b_ls, b_ns, po, n, fc); break;
        case OP_SQR: field_op_kernel<OP_SQR><<<blocks, threads, 0, s>>>(pa, a_ls, a_ns, pb, b_ls, b_ns, po, n, fc); break;
        case OP_ADD: field_op_kernel<OP_ADD><<<blocks, threads, 0, s>>>(pa, a_ls, a_ns, pb, b_ls, b_ns, po, n, fc); break;
        case OP_SUB: field_op_kernel<OP_SUB><<<blocks, threads, 0, s>>>(pa, a_ls, a_ns, pb, b_ls, b_ns, po, n, fc); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// exp_words: EXP_WORDS words of the exponent, least significant first, host
// memory; nbits: its bit length (<= 32 * EXP_WORDS).
extern "C" int bb_field_pow(const void* a, long a_ls, long a_ns, void* out, long n,
                            const uint32_t* exp_words, int nbits, const uint32_t* consts,
                            void* stream) {
    if (n <= 0) return 0;
    if (nbits < 0 || nbits > 32 * EXP_WORDS) return (int)cudaErrorInvalidValue;
    Exponent e;
    for (int k = 0; k < EXP_WORDS; ++k) e.w[k] = exp_words[k];
    e.nbits = nbits;
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    field_pow_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, a_ls, a_ns, (uint32_t*)out, n, e, field_const_from_host(consts));
    return (int)cudaGetLastError();
}

// rows: DOT_MAX_ROWS at most; row_args: 3 longs per row in host memory -
// base address, limb stride, lane stride; out: element r at out + r * o_ns,
// limb stride o_ls; ctas: CTAs per row (at least one); scratch:
// scratch_words words, DOT_MAX_ROWS tickets (zero), then rows * ctas * 9
// words of partials.
extern "C" int bb_field_dot(int rows, const long* row_args, const void* table, long t_ls, long t_ns,
                            void* out, long o_ls, long o_ns, long n, int ctas, void* scratch,
                            long scratch_words, const uint32_t* consts, void* stream) {
    if (n <= 0 || rows <= 0) return 0;
    if (rows > DOT_MAX_ROWS || ctas < 1 || scratch_words < DOT_MAX_ROWS + (long)rows * ctas * FE_LIMBS)
        return (int)cudaErrorInvalidValue;
    DotRows r;
    for (int k = 0; k < rows; ++k) {
        r.p[k] = (const uint32_t*)row_args[3 * k];
        r.ls[k] = row_args[3 * k + 1];
        r.ns[k] = row_args[3 * k + 2];
    }
    field_dot_kernel<<<dim3(ctas, rows), DOT_THREADS, 0, (cudaStream_t)stream>>>(
        r, (const uint32_t*)table, t_ls, t_ns, (uint32_t*)out, o_ls, o_ns, n, (unsigned*)scratch,
        (uint32_t*)scratch + DOT_MAX_ROWS, field_const_from_host(consts));
    return (int)cudaGetLastError();
}

// The CTAs of field_dot_kernel resident on the current device at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), into *out.
extern "C" int bb_field_dot_ctas(void* out) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, field_dot_kernel, DOT_THREADS, 0);
    *(int*)out = sms * per_sm;
    return (int)err;
}

// terms: LINCOMB_MAX_TERMS at most; term_args: 3 longs per term in host
// memory - base address, limb stride, lane stride; scalars: 32 bytes per
// term, host memory, the scalar's internal Montgomery form (value R' mod
// p) as a little-endian integer; out: (18, n) contiguous.
extern "C" int bb_field_lincomb(int count, const long* term_args, const uint8_t* scalars, void* out,
                                long n, const uint32_t* consts, void* stream) {
    if (n <= 0) return 0;
    if (count < 1 || count > LINCOMB_MAX_TERMS) return (int)cudaErrorInvalidValue;
    LincombTerms t;
    for (int j = 0; j < count; ++j) {
        t.p[j] = (const uint32_t*)term_args[3 * j];
        t.ls[j] = term_args[3 * j + 1];
        t.ns[j] = term_args[3 * j + 2];
        uint64_t w[5] = {0, 0, 0, 0, 0};
        for (int b = 0; b < 32; ++b) w[b / 8] |= (uint64_t)scalars[32 * j + b] << (8 * (b % 8));
        for (int k = 0; k < FE_LIMBS; ++k) {  // bits [30k, 30k + 30)
            const int bit = 30 * k, word = bit / 64, off = bit % 64;
            uint64_t v = w[word] >> off;
            if (off > 34) v |= w[word + 1] << (64 - off);
            t.s[j][k] = (uint32_t)v & FE_MASK;
        }
    }
    t.count = count;
    const long blocks = (n + LINCOMB_THREADS - 1) / LINCOMB_THREADS;
    field_lincomb_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), LINCOMB_THREADS, 0, (cudaStream_t)stream>>>(
        t, (uint32_t*)out, n, field_const_from_host(consts));
    return (int)cudaGetLastError();
}
