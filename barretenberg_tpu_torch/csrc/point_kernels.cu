// K3: complete masked G1 Jacobian group law over Fq, one thread per lane.
//   dbl        dbl-2009-l (a = 0)
//   add        add-2007-bl, with lane selects for P == Q (-> dbl),
//              P == -Q (-> infinity) and either operand at infinity
//   mixed_add  madd-2007-bl with the same selects; the affine operand has z = 1
// The group law itself is in point.cuh. All intermediates of one point
// operation stay in registers; coordinates are contiguous (18, n) planar
// limb arrays, infinity masks one byte per lane in and out.
#include <cuda_runtime.h>

#include "point.cuh"

__global__ void __launch_bounds__(128)
point_dbl_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                 const uint32_t* __restrict__ pz, uint32_t* __restrict__ ox,
                 uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long n, FieldConst fc) {
    long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    jac r = jac_dbl(fe_load(px + lane, n), fe_load(py + lane, n), fe_load(pz + lane, n), fc);
    fe_store(ox + lane, n, r.x);
    fe_store(oy + lane, n, r.y);
    fe_store(oz + lane, n, r.z);
}

// MIXED: the second operand is affine (no z2 array; z2 = 1).
template <bool MIXED>
__global__ void __launch_bounds__(128)
point_add_kernel(const uint32_t* __restrict__ px1, const uint32_t* __restrict__ py1,
                 const uint32_t* __restrict__ pz1, const uint8_t* __restrict__ pi1,
                 const uint32_t* __restrict__ px2, const uint32_t* __restrict__ py2,
                 const uint32_t* __restrict__ pz2, const uint8_t* __restrict__ pi2,
                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                 uint32_t* __restrict__ oz, uint8_t* __restrict__ oi, long n, FieldConst fc) {
    long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    fe z2 = MIXED ? fe_one(fc) : fe_load(pz2 + lane, n);
    jpt r = jac_add<MIXED>(fe_load(px1 + lane, n), fe_load(py1 + lane, n), fe_load(pz1 + lane, n),
                           pi1[lane] != 0, fe_load(px2 + lane, n), fe_load(py2 + lane, n), z2,
                           pi2[lane] != 0, fc);
    fe_store(ox + lane, n, r.x);
    fe_store(oy + lane, n, r.y);
    fe_store(oz + lane, n, r.z);
    oi[lane] = r.inf ? 1 : 0;
}

extern "C" int bb_point_dbl(const void* x, const void* y, const void* z,
                            void* ox, void* oy, void* oz, long n,
                            const uint32_t* consts, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    point_dbl_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, field_const_from_host(consts));
    return (int)cudaGetLastError();
}

// mixed != 0: (x2, y2, i2) is an affine batch and z2 is ignored (may be null).
extern "C" int bb_point_add(int mixed, const void* x1, const void* y1, const void* z1,
                            const void* i1, const void* x2, const void* y2, const void* z2,
                            const void* i2, void* ox, void* oy, void* oz, void* oi, long n,
                            const uint32_t* consts, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    FieldConst fc = field_const_from_host(consts);
    if (mixed) {
        point_add_kernel<true><<<blocks, threads, 0, s>>>(
            (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint8_t*)i1,
            (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2, (const uint8_t*)i2,
            (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)oi, n, fc);
    } else {
        point_add_kernel<false><<<blocks, threads, 0, s>>>(
            (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint8_t*)i1,
            (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2, (const uint8_t*)i2,
            (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)oi, n, fc);
    }
    return (int)cudaGetLastError();
}
