// K1: lane-wise field ops over planar limb arrays: mul, sqr, add, sub.
// One thread per lane; operands are addressed by (limb stride, lane stride)
// so a broadcast (18, 1) operand (lane stride 0) or a strided view needs no
// materialised copy. Plain C interface for ctypes; see field.cuh.
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
