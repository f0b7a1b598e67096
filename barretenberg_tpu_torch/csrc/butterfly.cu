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
