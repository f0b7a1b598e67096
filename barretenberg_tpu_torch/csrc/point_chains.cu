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
// All three carry their sum in registers from one iteration to the next. nvcc
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
