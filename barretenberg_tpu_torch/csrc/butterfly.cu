// K2: one radix-2 DIT butterfly stage over Fr on the view
// x5 = (18, G, 2, h, nb): for every (g, t, lane)
//   w = x[g,1,t,lane] * tw[t];  out[g,0,t,lane] = x[g,0,t,lane] + w;
//                               out[g,1,t,lane] = x[g,0,t,lane] - w.
// One thread per butterfly: multiply, add and subtract happen in registers,
// so a stage reads and writes the array exactly once. The twiddle operand is
// addressed by (limb stride, element stride): a stage's twiddles are a
// strided slice of the domain's one power table and are never copied.
#include <cuda_runtime.h>

#include "field.cuh"

__global__ void __launch_bounds__(256)
butterfly_stage_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                       long tw_ls, long tw_es, uint32_t* __restrict__ out,
                       long h, long nb, long count, long limb_stride, FieldConst fc) {
    long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= count) return;
    long lane = idx % nb;
    long rest = idx / nb;
    long t = rest % h;
    long g = rest / h;
    long e_off = ((g * 2) * h + t) * nb + lane;
    long o_off = e_off + h * nb;
    fe e = fe_load(x + e_off, limb_stride);
    fe o = fe_load(x + o_off, limb_stride);
    fe w = fe_load(tw + t * tw_es, tw_ls);
    fe m = fe_mul(o, w, fc);
    fe_store(out + e_off, limb_stride, fe_add(e, m, fc));
    fe_store(out + o_off, limb_stride, fe_sub(e, m, fc));
}

// x, out: contiguous (18, G, 2, h, nb); tw: (18, h) with the given strides.
extern "C" int bb_butterfly_stage(const void* x, const void* tw, long tw_ls, long tw_es,
                                  void* out, long g, long h, long nb,
                                  const uint32_t* consts, void* stream) {
    long count = g * h * nb;
    if (count <= 0) return 0;
    FieldConst fc = field_const_from_host(consts);
    const int threads = 256;
    const unsigned blocks = (unsigned)((count + threads - 1) / threads);
    butterfly_stage_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)tw, tw_ls, tw_es, (uint32_t*)out,
        h, nb, count, 2 * count, fc);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2b: a range of radix-2 DIT stages [s0, s0 + b) of the FFT over Fr on tiles
// held in shared memory. Stage s pairs the elements whose indices differ in
// bit s, so stages s0..s0+b-1 stay inside groups of 2^b elements at stride
// 2^s0 (index = hi * 2^(s0+b) + m * 2^s0 + lo, m < 2^b). A CTA loads 2^cl
// groups of neighbouring lo ("columns", so one limb row of a group row is
// 4 * 2^cl contiguous bytes), runs the b stages on them with a
// __syncthreads() between stages, and writes them back.
//
// The pass that starts at stage 0 reads its input through the bit
// reversal: for output j = blk * 2^b + t, bitrev(j) = bitrev_b(t) *
// 2^(k-b) + bitrev_(k-b)(blk), so a CTA takes the blocks whose bitrev_(k-b)
// are neighbours ("columns" again, read at stride 2^(k-b)) and writes each
// block's 2^b outputs contiguously.
//
// A scale is folded into the pass that owns it: before the stages at the
// input index (forward transforms: coset powers g^i and/or a constant), or
// after them at the output index (inverse transforms: 1/n times a constant,
// and/or g^-j). The constant arrives by value.
//
// Shared memory holds the tile in the 9 x 30-bit register form, limb-major
// (word k of tile element e at k * tile + e, tile element e = m * 2^cl + c),
// 36 bytes per element. The twiddle of stage s for global index j is
// tw[(j mod 2^s) * 2^(k-1-s)], read from the domain's one power table.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned brev_bits(unsigned v, int bits) {
    return bits == 0 ? 0u : __brev(v) >> (32 - bits);
}

__device__ __forceinline__ fe smem_fe_load(const uint32_t* s, int tile, int e) {
    fe r;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) r.v[k] = s[k * tile + e];
    return r;
}

__device__ __forceinline__ void smem_fe_store(uint32_t* s, int tile, int e, const fe& a) {
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) s[k * tile + e] = a.v[k];
}

struct PassScale {
    const uint32_t* tab;  // (18, n) table indexed like the array, or null
    long tab_ls, tab_es;
    fe c;                 // constant (internal Montgomery form), if has_const
    int has_const;
    int at_output;        // 0: before the stages, at the input index; 1: after, at the output index
};

__device__ __forceinline__ fe apply_scale(fe v, long idx, const PassScale& sc, const FieldConst& fc) {
    if (sc.tab) v = fe_mul(v, fe_load(sc.tab + idx * sc.tab_es, sc.tab_ls), fc);
    if (sc.has_const) v = fe_mul(v, sc.c, fc);
    return v;
}

extern __shared__ uint32_t fft_tile[];

__global__ void __launch_bounds__(256)
fft_pass_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, long n, int log2n,
                const uint32_t* __restrict__ tw, long tw_ls, long tw_es,
                int s0, int b, int cl, PassScale sc, FieldConst fc) {
    const int C = 1 << cl;
    const int rows = 1 << b;
    const int tile = rows << cl;
    const bool first = s0 == 0;
    const bool pre = (sc.tab || sc.has_const) && !sc.at_output;
    const bool post = (sc.tab || sc.has_const) && sc.at_output;
    const long cta = blockIdx.x;
    // later passes: CTA = (hi, block of C neighbouring lo)
    const long lo_blocks = first ? 1 : (1L << (s0 - cl));
    const long hi = cta / lo_blocks;
    const long lo_base = first ? 0 : (cta % lo_blocks) * C;

    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
        const int c = e & (C - 1), r = e >> cl;
        long g;
        int m;
        if (first) {
            g = ((long)r << (log2n - b)) + cta * C + c;
            m = (int)brev_bits((unsigned)r, b);
        } else {
            g = (hi << (s0 + b)) + ((long)r << s0) + lo_base + c;
            m = r;
        }
        fe v = fe_load(x + g, n);
        if (pre) v = apply_scale(v, g, sc, fc);
        smem_fe_store(fft_tile, tile, m * C + c, v);
    }
    __syncthreads();

    for (int sp = 0; sp < b; ++sp) {
        const int s = s0 + sp;
        const int half = 1 << sp;
        for (int u = threadIdx.x; u < (tile >> 1); u += blockDim.x) {
            const int c = u & (C - 1), q = u >> cl;
            const int mlo = ((q >> sp) << (sp + 1)) | (q & (half - 1));
            const long lo = first ? 0 : lo_base + c;  // a first-pass column is a block: no lo bits
            const long jmod = ((long)(mlo & (half - 1)) << s0) + lo;  // j mod 2^s
            const fe w = fe_load(tw + (jmod << (log2n - 1 - s)) * tw_es, tw_ls);
            const int elo = mlo * C + c, ehi = elo + (half << cl);
            const fe ev = smem_fe_load(fft_tile, tile, elo);
            const fe t = fe_mul(smem_fe_load(fft_tile, tile, ehi), w, fc);
            smem_fe_store(fft_tile, tile, elo, fe_add(ev, t, fc));
            smem_fe_store(fft_tile, tile, ehi, fe_sub(ev, t, fc));
        }
        __syncthreads();
    }

    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
        int m, c;
        long g;
        if (first) {  // block-contiguous writes: m fastest
            m = e & (rows - 1);
            c = e >> b;
            g = ((long)brev_bits((unsigned)(cta * C + c), log2n - b) << b) + m;
        } else {
            c = e & (C - 1);
            m = e >> cl;
            g = (hi << (s0 + b)) + ((long)m << s0) + lo_base + c;
        }
        fe v = smem_fe_load(fft_tile, tile, m * C + c);
        if (post) v = apply_scale(v, g, sc, fc);
        fe_store(out + g, n, v);
    }
}

// x, out: contiguous (18, n), n = 2^log2n; tw: (18, >= n/2) twiddle powers
// with the given strides. Runs stages [s0, s0 + b) with 2^cl columns per
// CTA, a tile of at most 2^max_tile_log elements (the wrapper checks the
// plan and owns the limit). sc_tab: (18, n) scale table or null; sc_const:
// 9 words of a 30-bit-limb constant (host memory) or null; sc_out: apply
// the scale after the stages (else before).
extern "C" int bb_fft_pass(const void* x, void* out, long n, int log2n,
                           const void* tw, long tw_ls, long tw_es, int s0, int b, int cl, int max_tile_log,
                           const void* sc_tab, long sc_ls, long sc_es, const uint32_t* sc_const,
                           int sc_out, const uint32_t* consts, void* stream) {
    if (n != (1L << log2n) || b < 0 || s0 < 0 || s0 + b > log2n || cl < 0 || b + cl > max_tile_log)
        return (int)cudaErrorInvalidValue;
    if (s0 == 0 ? cl > log2n - b : cl > s0) return (int)cudaErrorInvalidValue;
    PassScale sc;
    sc.tab = (const uint32_t*)sc_tab;
    sc.tab_ls = sc_ls;
    sc.tab_es = sc_es;
    sc.has_const = sc_const != nullptr;
    for (int k = 0; k < FE_LIMBS; ++k) sc.c.v[k] = sc_const ? sc_const[k] : 0u;
    sc.at_output = sc_out;
    const int tile = 1 << (b + cl);
    const size_t smem = (size_t)FE_LIMBS * sizeof(uint32_t) * tile;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(fft_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int threads = tile / 2 < 1 ? 1 : (tile / 2 > 256 ? 256 : tile / 2);
    const unsigned blocks = (unsigned)(n / tile);
    fft_pass_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, n, log2n, (const uint32_t*)tw, tw_ls, tw_es,
        s0, b, cl, sc, field_const_from_host(consts));
    return (int)cudaGetLastError();
}
