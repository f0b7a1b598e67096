// K3: complete masked G1 Jacobian group law over Fq, one thread per lane.
//   dbl        dbl-2009-l (a = 0)
//   add        add-2007-bl, with lane selects for P == Q (-> dbl),
//              P == -Q (-> infinity) and either operand at infinity
//   mixed_add  madd-2007-bl with the same selects; the affine operand has z = 1
// All intermediates of one point operation stay in registers / local memory;
// coordinates are contiguous (18, n) planar limb arrays, infinity masks one
// byte per lane in and out.
#include <cuda_runtime.h>

#include "field.cuh"

struct jac {
    fe x, y, z;
};

__device__ __forceinline__ jac jac_dbl(const fe& x, const fe& y, const fe& z, const FieldConst& fc) {
    fe a = fe_sqr(x, fc);
    fe b = fe_sqr(y, fc);
    fe c = fe_sqr(b, fc);
    fe d = fe_sub(fe_sqr(fe_add(x, b, fc), fc), fe_add(a, c, fc), fc);
    d = fe_dbl(d, fc);
    fe e = fe_add(fe_dbl(a, fc), a, fc);
    fe f = fe_sqr(e, fc);
    jac r;
    r.x = fe_sub(f, fe_dbl(d, fc), fc);
    r.y = fe_sub(fe_mul(e, fe_sub(d, r.x, fc), fc),
                 fe_dbl(fe_dbl(fe_dbl(c, fc), fc), fc), fc);
    r.z = fe_dbl(fe_mul(y, z, fc), fc);
    return r;
}

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
    fe x1 = fe_load(px1 + lane, n), y1 = fe_load(py1 + lane, n), z1 = fe_load(pz1 + lane, n);
    fe x2 = fe_load(px2 + lane, n), y2 = fe_load(py2 + lane, n);
    bool i1 = pi1[lane] != 0, i2 = pi2[lane] != 0;

    fe z1z1 = fe_sqr(z1, fc);
    fe u2 = fe_mul(x2, z1z1, fc);
    fe s2 = fe_mul(y2, fe_mul(z1, z1z1, fc), fc);
    fe u1, s1, z2, z2z2;
    if (MIXED) {
        u1 = x1;
        s1 = y1;
        z2 = fe_one(fc);
    } else {
        z2 = fe_load(pz2 + lane, n);
        z2z2 = fe_sqr(z2, fc);
        u1 = fe_mul(x1, z2z2, fc);
        s1 = fe_mul(y1, fe_mul(z2, z2z2, fc), fc);
    }
    fe h = fe_sub(u2, u1, fc);
    fe r = fe_dbl(fe_sub(s2, s1, fc), fc);
    bool h_zero = fe_is_zero(h), r_zero = fe_is_zero(r);

    fe i, z3;
    if (MIXED) {
        fe hh = fe_sqr(h, fc);
        i = fe_dbl(fe_dbl(hh, fc), fc);
        z3 = fe_sub(fe_sqr(fe_add(z1, h, fc), fc), fe_add(z1z1, hh, fc), fc);
    } else {
        i = fe_sqr(fe_dbl(h, fc), fc);
        z3 = fe_mul(fe_sub(fe_sqr(fe_add(z1, z2, fc), fc), fe_add(z1z1, z2z2, fc), fc), h, fc);
    }
    fe j = fe_mul(h, i, fc);
    fe v = fe_mul(u1, i, fc);
    fe x3 = fe_sub(fe_sqr(r, fc), fe_add(j, fe_dbl(v, fc), fc), fc);
    fe y3 = fe_sub(fe_mul(r, fe_sub(v, x3, fc), fc), fe_dbl(fe_mul(s1, j, fc), fc), fc);

    bool both = !i1 && !i2;
    bool use_dbl = both && h_zero && r_zero;
    bool cancel = both && h_zero && !r_zero;
    if (use_dbl) {  // rare lane: P == Q
        jac d = jac_dbl(x1, y1, z1, fc);
        x3 = d.x;
        y3 = d.y;
        z3 = d.z;
    }
    x3 = fe_select(i2, x1, fe_select(i1, x2, x3));
    y3 = fe_select(i2, y1, fe_select(i1, y2, y3));
    z3 = fe_select(i2, z1, fe_select(i1, z2, z3));
    bool inf = i2 ? i1 : (i1 ? i2 : cancel);
    fe_store(ox + lane, n, x3);
    fe_store(oy + lane, n, y3);
    fe_store(oz + lane, n, z3);
    oi[lane] = inf ? 1 : 0;
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
