// The lane-wise point chains, one launch each.
//
// K3d scalar_mul_bits: the small-MSM double-and-add. Per lane, from
// infinity with zero coordinates, for each bit most significant first:
// acc = dbl(acc), then acc = mixed_add(acc, P) kept where the bit is 1 -
// the plain loop's point operations in its order, infinity flag included,
// so the Jacobian coordinates are equal limb for limb. The add is computed
// for every bit and selected, as the plain loop does: a warp runs it
// whenever one of its lanes has the bit set anyway, and nvcc 12.9's cicc
// crashes when the add's result is carried under a branch (see below).
// Lane l reads point l % n, so B MSMs over one point set need no tiled
// copy. Bound by one thread's dependent chain (254 doublings and 254 mixed
// adds, ~4,600 Montgomery products), not by the card's rates: CTAs are one
// warp each so that the lanes spread over as many SMs as there are warps,
// and the chain's time is set by fe_mul's dependent work per digit
// (field.cuh's lazy-carry columns keep it short).
//
// K3e fixed_base: the fixed-base window multiplication of SRS generation.
// Per lane, from infinity, for windows w = 0, 1, ...: acc = mixed_add(acc,
// table[w * per_window + digit[w]]), the plain loop's order. An add to
// infinity gives the table point itself (z = one) and an add of a table
// point at infinity leaves acc as it is, so both skip their arithmetic (the
// first window's add is always one of them) and the coordinates stay the
// plain loop's. Bound by operations (11 products per add at 2^16 lanes):
// the accumulator stays in registers across all windows, and each table
// entry is one 80-byte row (four 16-byte loads) of a table that fits in L2.
//
// K3f table_rows: the rows of the precomputed Pippenger table, row r
// holding 2^(r c) P. One thread per point runs all (rows - 1) * c
// doublings from the affine point (z = one), the plain loop's doublings in
// its order with the infinity flag left as it is, and stores the Jacobian
// point after every c of them. Bound by operations ((rows - 1) * c * 7
// products per lane); each lane's chain is long (130 doublings at 2^16
// points), so its CTAs are one warp each, as K3d's, to spread a small
// table's lanes over the SMs; normalising the rows to affine is left to one
// batched normalisation outside.
//
// K3g windowed_walk: arbitrary-base scalar multiplication by signed c-bit
// windows, one thread per lane. The lane first builds its table T[m] = m P
// for m = 0 .. 2^(c-1) - T[0] at infinity with zero coordinates, then one
// mixed add of P per entry, the plain table's order - then walks the digit
// rounds most significant first: c doublings of the running sum, then one
// full Jacobian add of entry |d| of the table, with y negated where d < 0,
// for each digit set. Windowed mode (one set): the digits of the full
// 254-bit scalar, computed here from the lane's Montgomery Fr scalar (its
// plain value, ceil(254 / c) windows with borrow recoding and the final
// carry, least significant first into a local array). GLV mode (two sets):
// K4's digits of k1 against T and of k2 against psi(T) = (beta x, -y, z),
// an entry's image computed as it is read (one product), sharing the
// doublings. The point operations are the plain walk's, in its order, with
// the infinity flags, so the coordinates are equal limb for limb. The
// table (2^(c-1) + 1 Jacobian points, 1.9 KB a lane at c = 5) lives in
// device memory, each lane's entries contiguous and each entry seven
// 16-byte words: in shared memory it would cap an SM at three one-warp
// CTAs (61 KB each), where registers allow about ten, and the walk is bound
// by one thread's chain of dependent products (at c = 5 about 2,700 for
// the windowed walk's 52 rounds), which more resident warps hide; an
// entry's 112 bytes are read once per add of 16 products. The running sum
// passes through the output between rounds, as in K3c (see below).
//
// K3d, K3e and K3f carry their sum in registers from one iteration to the next. nvcc
// 12.9's cicc crashes (segmentation fault) on some loops that carry
// jac_add's result so: on a conditional jac_add<true> whose first
// operand's infinity flag is the carried one (K3d with the add under
// `if (bit)`, K3e with the add under `if (!inf)` alone). The forms below
// build; K3c (msm_kernels.cu) passes its sum through memory instead.
#include <cuda_runtime.h>

#include "point.cuh"

#define SMB_THREADS 32
#define FB_THREADS 128
#define TR_THREADS 32
#define WALK_THREADS 32
#define WALK_MAX_C 16         // K3g: widest window (digits fit a short)
#define WALK_MAX_ROUNDS 256   // K3g: the windowed mode's local digit array
#define ENTRY_VEC 7           // K3g: one table entry, 28 words as 16-byte vectors

// px, py: (18, n) affine points, pinf: (n,). bits: (nbits, lanes) bytes,
// MSB first. out: (18, lanes) Jacobian points.
__global__ void __launch_bounds__(SMB_THREADS)
scalar_mul_bits_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                       const uint8_t* __restrict__ pinf, long n, const uint8_t* __restrict__ bits,
                       int nbits, Pts out, long lanes, FieldConst fc) {
    const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const long pl = lane % n;
    const fe x2 = fe_load(px + pl, n);
    const fe y2 = fe_load(py + pl, n);
    const bool i2 = pinf[pl] != 0;
    const fe one = fe_one(fc);
    jpt acc;
    acc.x = acc.y = acc.z = fe_zero();
    acc.inf = true;
#pragma unroll 1
    for (int k = 0; k < nbits; ++k) {
        jac d = jac_dbl(acc.x, acc.y, acc.z, fc);
        acc.x = d.x;
        acc.y = d.y;
        acc.z = d.z;
        const jpt a = jac_add<true>(acc.x, acc.y, acc.z, acc.inf, x2, y2, one, i2, fc);
        const bool bit = bits[(long)k * lanes + lane] != 0;
        acc.x = fe_select(bit, a.x, acc.x);
        acc.y = fe_select(bit, a.y, acc.y);
        acc.z = fe_select(bit, a.z, acc.z);
        acc.inf = bit ? a.inf : acc.inf;
    }
    store_pt(out, lane, lanes, acc);
}

// table: (windows * per_window, ROW_WORDS) rows. digits: (windows, n) bytes.
// out: (18, n) Jacobian points.
__global__ void __launch_bounds__(FB_THREADS)
fixed_base_kernel(const uint4* __restrict__ table, const uint8_t* __restrict__ digits, int windows,
                  int per_window, Pts out, long n, FieldConst fc) {
    const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const fe one = fe_one(fc);
    jpt acc;
    acc.x = acc.y = acc.z = fe_zero();
    acc.inf = true;
    uint32_t w[ROW_WORDS];
#pragma unroll 1
    for (int win = 0; win < windows; ++win) {
        load_row(table, (long)win * per_window + digits[(long)win * n + lane], w);
        fe x, y;
        bool inf;
        unpack_row(w, x, y, inf);
        if (inf) continue;  // acc + infinity = acc
        if (acc.inf) {      // infinity + Q = (Q.x, Q.y, one)
            acc.x = x;
            acc.y = y;
            acc.z = one;
            acc.inf = false;
        } else {
            acc = jac_add<true>(acc.x, acc.y, acc.z, false, x, y, one, false, fc);
        }
    }
    store_pt(out, lane, n, acc);
}

// px, py: (18, n) affine points, pinf: (n,). out: (18, (rows - 1) * n)
// Jacobian points, row r (1 <= r < rows) at lanes [(r - 1) n, r n).
__global__ void __launch_bounds__(TR_THREADS)
table_rows_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                  const uint8_t* __restrict__ pinf, long n, int rows, int c, Pts out,
                  FieldConst fc) {
    const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    jpt acc;
    acc.x = fe_load(px + lane, n);
    acc.y = fe_load(py + lane, n);
    acc.z = fe_one(fc);
    acc.inf = pinf[lane] != 0;
    const long stride = (long)(rows - 1) * n;
#pragma unroll 1
    for (int r = 1; r < rows; ++r) {
#pragma unroll 1
        for (int k = 0; k < c; ++k) {
            jac d = jac_dbl(acc.x, acc.y, acc.z, fc);
            acc.x = d.x;
            acc.y = d.y;
            acc.z = d.z;
        }
        store_pt(out, (long)(r - 1) * n + lane, stride, acc);
    }
}

// One K3g table entry: x, y, z as 9 x 30-bit words each, then the
// infinity flag, as seven 16-byte words.
__device__ __forceinline__ void store_entry(uint4* e, const jpt& v) {
    uint32_t w[4 * ENTRY_VEC];
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        w[k] = v.x.v[k];
        w[FE_LIMBS + k] = v.y.v[k];
        w[2 * FE_LIMBS + k] = v.z.v[k];
    }
    w[3 * FE_LIMBS] = v.inf ? 1u : 0u;
#pragma unroll
    for (int q = 0; q < ENTRY_VEC; ++q) e[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
}

__device__ __forceinline__ jpt load_entry(const uint4* e) {
    uint32_t w[4 * ENTRY_VEC];
#pragma unroll
    for (int q = 0; q < ENTRY_VEC; ++q) {
        const uint4 t = __ldcg(e + q);
        w[4 * q] = t.x;
        w[4 * q + 1] = t.y;
        w[4 * q + 2] = t.z;
        w[4 * q + 3] = t.w;
    }
    jpt v;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        v.x.v[k] = w[k];
        v.y.v[k] = w[FE_LIMBS + k];
        v.z.v[k] = w[2 * FE_LIMBS + k];
    }
    v.inf = w[3 * FE_LIMBS] != 0;
    return v;
}

// px, py: (18, n) affine points, pinf: (n,). GLV: digits (rounds, 2, n)
// int32, k1's then k2's per round; else scalars (18, n) internal-Montgomery
// Fr. table: n x (2^(c-1) + 1) entries. out: (18, n) Jacobian points.
template <bool GLV>
__global__ void __launch_bounds__(WALK_THREADS)
windowed_walk_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                     const uint8_t* __restrict__ pinf, long n, const uint32_t* __restrict__ scalars,
                     const int* __restrict__ digits, int c, int rounds, uint4* __restrict__ table,
                     Pts out, FieldConst fq, FieldConst fr, fe beta) {
    const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const int size = (1 << (c - 1)) + 1;
    uint4* tab = table + lane * size * ENTRY_VEC;
    const fe x2 = fe_load(px + lane, n);
    const fe y2 = fe_load(py + lane, n);
    const bool i2 = pinf[lane] != 0;
    const fe one = fe_one(fq);
    jpt acc;
    acc.x = acc.y = acc.z = fe_zero();
    acc.inf = true;
    store_entry(tab, acc);
    store_pt(out, lane, n, acc);
#pragma unroll 1
    for (int m = 1; m < size; ++m) {  // T[m] = T[m - 1] + P, through memory
        jpt t = load_entry(tab + (m - 1) * ENTRY_VEC);
        t = jac_add<true>(t.x, t.y, t.z, t.inf, x2, y2, one, i2, fq);
        store_entry(tab + m * ENTRY_VEC, t);
    }

    short dig[GLV ? 1 : WALK_MAX_ROUNDS];
    if (!GLV) {  // the plain value's signed windows, least significant first
        fe k = fe_load(scalars + lane, n);
        fe plain_one = fe_zero();
        plain_one.v[0] = 1;
        k = fe_mul(k, plain_one, fr);
        const uint32_t mask = (1u << c) - 1, half = 1u << (c - 1);
        uint32_t carry = 0;
#pragma unroll 1
        for (int r = 0; r < rounds - 1; ++r) {
            const int lo = r * c, w = lo / 30, sh = lo % 30;
            uint64_t bits = (uint64_t)k.v[w] >> sh;
            if (w + 1 < FE_LIMBS) bits |= (uint64_t)k.v[w + 1] << (30 - sh);
            const uint32_t v = ((uint32_t)bits & mask) + carry;
            carry = v >= half;
            dig[r] = (short)((int)v - (int)(carry << c));
        }
        dig[rounds - 1] = (short)carry;
    }

#pragma unroll 1
    for (int r = rounds - 1; r >= 0; --r) {
        jpt a = load_pt_cg(out, lane, n);
#pragma unroll 1
        for (int k = 0; k < c; ++k) {
            jac d = jac_dbl(a.x, a.y, a.z, fq);
            a.x = d.x;
            a.y = d.y;
            a.z = d.z;
        }
        const int d1 = GLV ? digits[(long)r * 2 * n + lane] : (int)dig[r];
        jpt e = load_entry(tab + (d1 < 0 ? -d1 : d1) * ENTRY_VEC);
        e.y = fe_select(d1 < 0, fe_sub(fe_zero(), e.y, fq), e.y);
        a = jac_add<false>(a.x, a.y, a.z, a.inf, e.x, e.y, e.z, e.inf, fq);
        if (GLV) {  // psi(T)[|d2|] = (beta x, -y, z), negated again where d2 < 0
            const int d2 = digits[(long)r * 2 * n + n + lane];
            jpt e2 = load_entry(tab + (d2 < 0 ? -d2 : d2) * ENTRY_VEC);
            e2.x = fe_mul(e2.x, beta, fq);
            e2.y = fe_select(d2 < 0, e2.y, fe_sub(fe_zero(), e2.y, fq));
            a = jac_add<false>(a.x, a.y, a.z, a.inf, e2.x, e2.y, e2.z, e2.inf, fq);
        }
        store_pt(out, lane, n, a);
    }
}

extern "C" int bb_scalar_mul_bits(const void* px, const void* py, const void* pinf, long n,
                                  const void* bits, int nbits, void* ox, void* oy, void* oz,
                                  void* oinf, long lanes, const uint32_t* consts, void* stream) {
    if (lanes <= 0) return 0;
    if (n <= 0 || lanes % n != 0) return (int)cudaErrorInvalidValue;
    Pts out = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)oinf};
    const unsigned blocks = (unsigned)((lanes + SMB_THREADS - 1) / SMB_THREADS);
    scalar_mul_bits_kernel<<<blocks, SMB_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint8_t*)pinf, n, (const uint8_t*)bits,
        nbits, out, lanes, field_const_from_host(consts));
    return (int)cudaGetLastError();
}

extern "C" int bb_fixed_base(const void* table, const void* digits, int windows, int per_window,
                             void* ox, void* oy, void* oz, void* oinf, long n,
                             const uint32_t* consts, void* stream) {
    if (n <= 0) return 0;
    if (windows <= 0 || per_window <= 0) return (int)cudaErrorInvalidValue;
    Pts out = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)oinf};
    const unsigned blocks = (unsigned)((n + FB_THREADS - 1) / FB_THREADS);
    fixed_base_kernel<<<blocks, FB_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, (const uint8_t*)digits, windows, per_window, out, n,
        field_const_from_host(consts));
    return (int)cudaGetLastError();
}

extern "C" int bb_table_rows(const void* px, const void* py, const void* pinf, long n, int rows,
                             int c, void* ox, void* oy, void* oz, void* oinf,
                             const uint32_t* consts, void* stream) {
    if (n <= 0 || rows <= 1) return 0;
    if (c <= 0) return (int)cudaErrorInvalidValue;
    Pts out = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)oinf};
    const unsigned blocks = (unsigned)((n + TR_THREADS - 1) / TR_THREADS);
    table_rows_kernel<<<blocks, TR_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint8_t*)pinf, n, rows, c, out,
        field_const_from_host(consts));
    return (int)cudaGetLastError();
}

// glv: 1 for GLV mode (src: (rounds, 2, n) int32 digits), 0 for windowed
// mode (src: (18, n) internal-Montgomery Fr scalars). table: n x (2^(c-1)
// + 1) x 28 words of scratch. beta: Fq's cube root of unity as 9 words.
extern "C" int bb_windowed_walk(int glv, const void* px, const void* py, const void* pinf, long n,
                                const void* src, int c, int rounds, void* table, void* ox, void* oy,
                                void* oz, void* oinf, const uint32_t* fq_consts, const uint32_t* fr_consts,
                                const uint32_t* beta_words, void* stream) {
    if (n <= 0) return 0;
    if (c < 1 || c > WALK_MAX_C || rounds < 1 || rounds > WALK_MAX_ROUNDS || src == nullptr)
        return (int)cudaErrorInvalidValue;
    if (!glv && (rounds - 1) * c < 254) return (int)cudaErrorInvalidValue;  // the windows cover the scalar
    Pts out = {(uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)oinf};
    fe beta;
    for (int k = 0; k < FE_LIMBS; ++k) beta.v[k] = beta_words[k];
    const unsigned blocks = (unsigned)((n + WALK_THREADS - 1) / WALK_THREADS);
    const FieldConst fq = field_const_from_host(fq_consts), fr = field_const_from_host(fr_consts);
    if (glv)
        windowed_walk_kernel<true><<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)px, (const uint32_t*)py, (const uint8_t*)pinf, n, nullptr, (const int*)src, c,
            rounds, (uint4*)table, out, fq, fr, beta);
    else
        windowed_walk_kernel<false><<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)px, (const uint32_t*)py, (const uint8_t*)pinf, n, (const uint32_t*)src, nullptr,
            c, rounds, (uint4*)table, out, fq, fr, beta);
    return (int)cudaGetLastError();
}
