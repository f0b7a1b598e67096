// K1: lane-wise field ops over planar limb arrays: mul, sqr, add, sub, and
// pow (a^e for an exponent the host knows, the whole square-and-multiply
// chain in one launch). One thread per lane; operands are addressed by
// (limb stride, lane stride) so a broadcast (18, 1) operand (lane stride 0)
// or a strided view needs no materialised copy. Plain C interface for
// ctypes; see field.cuh.
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
