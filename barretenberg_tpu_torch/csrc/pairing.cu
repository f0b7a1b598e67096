// The BN254 optimal-ate pairing's two chains, one launch each.
//
// K5a miller_loop: the whole Miller loop for B lanes, one thread a lane
// (pairing.cpp:162-251; the JAX package's _miller_jit,
// pairing/device.py:132-152). The lines of each distinct G2 point Q come
// precomputed from the host (pairing/tower.precompute_miller_lines), one
// table row of (o, vw, vv) per line, 18 x 15-bit limbs a coordinate; a
// lane reads the rows of its Q and scales vw by its P.y and vv by its P.x
// as it reads them (the host's fq2_scale, as a product in Montgomery
// form). From f = 1, each NAF step is one Fq12 squaring and two sparse
// line products, with lines i1[s] and i2[s]; index `nlines` is the identity
// line (o = 1, vw = vv = 0) that a zero digit takes, so the step is
// uniform; then the two Frobenius add-lines (the last two rows). f lives in
// per-lane device scratch, 108 words a lane, lane-interleaved so that a
// warp's accesses to one word are one 128-byte line.
//
// K5b final_exp: one thread per group of g consecutive lanes. It folds the
// group's Miller values with Fq12 products (the verifier / SRS-check
// shape, prod e(P_i, Q_i)), then runs the easy part and the
// Fuentes-Castaneda chain (pairing.cpp:253-331) as straight-line calls, in
// the order of the JAX package's register program (pairing/device.py:
// 160-188), on FE_EXP_SLOTS Fq12 registers in per-group device scratch,
// lane-interleaved as above. Exp-by-neg-z keeps the JAX package's uniform
// step: a cyclotomic squaring, then mul(r, a) computed for every bit and
// selected.
//
// Both are long serial chains of Montgomery products on one thread (about
// 8,400 a lane in K5a, 14,600 a group in K5b), bound by each product's
// dependent latency, not by the card's rates: CTAs are one warp each so
// that the lanes spread over as many SMs as there are warps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tower.cuh"

#define PAIR_THREADS 32
#define MILLER_MAX_STEPS 96
#define LINE_WORDS (3 * 2 * 18)  // one table row: (o, vw, vv), 18 limbs a coordinate
#define FE_EXP_SLOTS 7  // K5b's Fq12 registers a group

struct MillerSteps {
    int n;                       // NAF steps
    short i1[MILLER_MAX_STEPS];  // first line of each step
    short i2[MILLER_MAX_STEPS];  // second line (nlines: the identity line)
};

// f = f * (line `idx` of the table `q`, scaled by P); idx == nlines reads the
// identity line. The row read is clamped and the identity selected, so no
// tower op sits under a branch.
__device__ __noinline__ void line_mul(V f, const uint32_t* __restrict__ q, int idx, int nlines, const fe& px,
                                      const fe& py) {
    const bool ident = idx >= nlines;
    const uint32_t* row = q + (long)(ident ? nlines - 1 : idx) * LINE_WORDS;
    const fq2 one = f2_one(), zero = f2_zero();
    fq2 o = {fe_load(row, 1), fe_load(row + 18, 1)};
    fq2 vw = {q_mul(fe_load(row + 36, 1), py), q_mul(fe_load(row + 54, 1), py)};
    fq2 vv = {q_mul(fe_load(row + 72, 1), px), q_mul(fe_load(row + 90, 1), px)};
    o = {fe_select(ident, one.c0, o.c0), fe_select(ident, one.c1, o.c1)};
    vw = {fe_select(ident, zero.c0, vw.c0), fe_select(ident, zero.c1, vw.c1)};
    vv = {fe_select(ident, zero.c0, vv.c0), fe_select(ident, zero.c1, vv.c1)};
    f12_sparse_mul(f, o, vw, vv);
}

__global__ void __launch_bounds__(PAIR_THREADS)
miller_loop_kernel(const uint32_t* __restrict__ lines, int nlines, const int* __restrict__ qidx,
                   const uint32_t* __restrict__ px, const uint32_t* __restrict__ py, uint32_t* __restrict__ out,
                   uint32_t* __restrict__ scratch, long n, MillerSteps st) {
    const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const fe x = fe_load(px + lane, n), y = fe_load(py + lane, n);
    const uint32_t* q = lines + (long)qidx[lane] * nlines * LINE_WORDS;
    const V f = {scratch + lane, n};
    f12_one(f);
#pragma unroll 1
    for (int s = 0; s < st.n; ++s) {
        f12_sqr(f, f);
        line_mul(f, q, st.i1[s], nlines, x, y);
        line_mul(f, q, st.i2[s], nlines, x, y);
    }
    line_mul(f, q, nlines - 2, nlines, x, y);
    line_mul(f, q, nlines - 1, nlines, x, y);
    for (int e = 0; e < 12; ++e) fe_store(out + (long)e * 18 * n + lane, n, ld_fe(f, e));
}

__device__ __forceinline__ V reg(uint32_t* scratch, long groups, long g, int r) {
    return {scratch + (long)r * FQ12_WORDS * groups + g, groups};
}

// Fq12 lane `lane` of a (2, 3, 2, 18, lanes) tensor into the view r
__device__ __noinline__ void load_f12(V r, const uint32_t* __restrict__ f, long lanes, long lane) {
    for (int e = 0; e < 12; ++e) st_fe(r, e, fe_load(f + (long)e * 18 * lanes + lane, lanes));
}

__global__ void __launch_bounds__(PAIR_THREADS)
final_exp_kernel(const uint32_t* __restrict__ f, uint32_t* __restrict__ out, uint32_t* __restrict__ scratch,
                 long groups, int gsize) {
    const long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= groups) return;
    const long lanes = groups * gsize;
    const V s0 = reg(scratch, groups, g, 0), s1 = reg(scratch, groups, g, 1), s2 = reg(scratch, groups, g, 2),
            s3 = reg(scratch, groups, g, 3), s4 = reg(scratch, groups, g, 4), s5 = reg(scratch, groups, g, 5),
            s6 = reg(scratch, groups, g, 6);
    load_f12(s0, f, lanes, g * gsize);
#pragma unroll 1
    for (int j = 1; j < gsize; ++j) {
        load_f12(s1, f, lanes, g * gsize + j);
        f12_mul(s0, s0, s1);
    }
    // the easy part: elt = f^((p^6 - 1)(p^2 + 1))
    f12_conj(s1, s0);
    f12_inv(s2, s0);
    f12_mul(s1, s1, s2);  // f^(p^6 - 1)
    f12_frob(s2, s1, 2);
    f12_mul(s0, s1, s2);  // elt
    // the hard part; s5 is exp-by-neg-z's product
    f12_expz(s1, s0, s5);  // A = elt^-z
    f12_csq(s1, s1);       // B = A^2
    f12_csq(s2, s1);       // C = B^2
    f12_mul(s2, s2, s1);   // D = C B
    f12_expz(s3, s2, s5);  // E = D^-z
    f12_csq(s4, s3);       // F = E^2
    f12_expz(s6, s4, s5);  // G = F^-z
    f12_conj(s2, s2);      // H = conj(D)
    f12_conj(s6, s6);      // I = conj(G)
    f12_mul(s6, s6, s3);   // J = I E
    f12_mul(s2, s2, s6);   // K = H J
    f12_mul(s1, s1, s2);   // L = B K
    f12_mul(s3, s3, s2);   // M = E K
    f12_mul(s3, s3, s0);   // N = M elt
    f12_frob(s4, s1, 1);   // O = L^p
    f12_mul(s4, s4, s3);   // P = O N
    f12_frob(s3, s2, 2);   // Q = K^(p^2)
    f12_mul(s4, s4, s3);   // R = P Q
    f12_conj(s0, s0);      // S = conj(elt)
    f12_mul(s1, s1, s0);   // T = L S
    f12_frob(s1, s1, 3);   // U = T^(p^3)
    f12_mul(s4, s4, s1);   // R U
    for (int e = 0; e < 12; ++e) fe_store(out + (long)e * 18 * groups + g, groups, ld_fe(s4, e));
}

static cudaError_t set_tower_consts(const uint32_t* fq_consts, const uint32_t* tower_words, void* stream) {
    const TowerConst t = tower_const_from_host(fq_consts, tower_words);
    return cudaMemcpyToSymbolAsync(TC, &t, sizeof(t), 0, cudaMemcpyHostToDevice, (cudaStream_t)stream);
}

// lines: (nq, nlines, 3, 2, 18) int32 limbs; qidx: (n,) int32 < nq; px, py:
// (18, n); out: (2, 3, 2, 18, n); scratch: 108 * n words; i1 / i2: steps
// shorts each in host memory.
extern "C" int bb_miller_loop(const void* lines, int nlines, const void* qidx, const void* px, const void* py,
                              void* out, void* scratch, long n, int steps, const short* i1, const short* i2,
                              const uint32_t* fq_consts, const uint32_t* tower_words, void* stream) {
    if (n <= 0) return 0;
    if (steps < 0 || steps > MILLER_MAX_STEPS || nlines < 2) return (int)cudaErrorInvalidValue;
    MillerSteps st;
    st.n = steps;
    for (int s = 0; s < steps; ++s) {
        if (i1[s] < 0 || i1[s] >= nlines || i2[s] < 0 || i2[s] > nlines) return (int)cudaErrorInvalidValue;
        st.i1[s] = i1[s];
        st.i2[s] = i2[s];
    }
    cudaError_t err = set_tower_consts(fq_consts, tower_words, stream);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((n + PAIR_THREADS - 1) / PAIR_THREADS);
    miller_loop_kernel<<<blocks, PAIR_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)lines, nlines, (const int*)qidx, (const uint32_t*)px, (const uint32_t*)py, (uint32_t*)out,
        (uint32_t*)scratch, n, st);
    return (int)cudaGetLastError();
}

// f: (2, 3, 2, 18, groups * gsize); out: (2, 3, 2, 18, groups); scratch:
// FE_EXP_SLOTS * 108 * groups words.
extern "C" int bb_final_exp(const void* f, void* out, void* scratch, long groups, int gsize,
                            const uint32_t* fq_consts, const uint32_t* tower_words, void* stream) {
    if (groups <= 0) return 0;
    if (gsize < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = set_tower_consts(fq_consts, tower_words, stream);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((groups + PAIR_THREADS - 1) / PAIR_THREADS);
    final_exp_kernel<<<blocks, PAIR_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)f, (uint32_t*)out, (uint32_t*)scratch, groups, gsize);
    return (int)cudaGetLastError();
}
