// Per-thread G1 Jacobian group law over Fq (a = 0), shared by the lane-wise
// point kernels (point_kernels.cu), the point chains (point_chains.cu) and
// the MSM bucket kernels (msm_kernels.cu), so that every kernel runs the
// same sequence of field operations and produces the same coordinates:
//   jac_dbl         dbl-2009-l
//   jac_add<false>  add-2007-bl, with the selects for P == Q (-> dbl),
//                   P == -Q (-> infinity) and either operand at infinity
//   jac_add<true>   madd-2007-bl with the same selects; the caller passes
//                   z2 = one (the affine operand's z)
// and the point layouts the MSM and chain kernels share: planar (18, lanes)
// 15-bit limb arrays with one infinity byte per lane (Pts), and 80-byte
// affine point-table rows (ROW_WORDS), read with four 16-byte loads.
#pragma once

#include "field.cuh"

struct jac {
    fe x, y, z;
};

// A Jacobian point with its infinity flag.
struct jpt {
    fe x, y, z;
    bool inf;
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

// P + Q. MIXED: Q is affine and z2 must be the Montgomery one.
template <bool MIXED>
__device__ __forceinline__ jpt jac_add(const fe& x1, const fe& y1, const fe& z1, bool i1,
                                       const fe& x2, const fe& y2, const fe& z2, bool i2,
                                       const FieldConst& fc) {
    fe z1z1 = fe_sqr(z1, fc);
    fe u2 = fe_mul(x2, z1z1, fc);
    fe s2 = fe_mul(y2, fe_mul(z1, z1z1, fc), fc);
    fe u1, s1, z2z2;
    if (MIXED) {
        u1 = x1;
        s1 = y1;
    } else {
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
    jpt out;
    out.x = fe_select(i2, x1, fe_select(i1, x2, x3));
    out.y = fe_select(i2, y1, fe_select(i1, y2, y3));
    out.z = fe_select(i2, z1, fe_select(i1, z2, z3));
    out.inf = i2 ? i1 : (i1 ? i2 : cancel);
    return out;
}

#define ROW_WORDS 20  // one point-table row: x, y (9 x 30-bit each), inf, pad

__device__ __forceinline__ void load_row(const uint4* __restrict__ table, long idx,
                                         uint32_t (&w)[ROW_WORDS]) {
    const uint4* row = table + idx * (ROW_WORDS / 4);
#pragma unroll
    for (int q = 0; q < ROW_WORDS / 4; ++q) {
        uint4 t = __ldg(row + q);
        w[4 * q] = t.x;
        w[4 * q + 1] = t.y;
        w[4 * q + 2] = t.z;
        w[4 * q + 3] = t.w;
    }
}

// x, y and the infinity flag of a loaded row.
__device__ __forceinline__ void unpack_row(const uint32_t (&w)[ROW_WORDS], fe& x, fe& y, bool& inf) {
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        x.v[k] = w[k];
        y.v[k] = w[FE_LIMBS + k];
    }
    inf = w[2 * FE_LIMBS] != 0;
}

struct Pts {
    uint32_t* x;
    uint32_t* y;
    uint32_t* z;
    uint8_t* inf;
};

__device__ __forceinline__ void store_pt(const Pts& p, long lane, long stride, const jpt& v) {
    fe_store(p.x + lane, stride, v.x);
    fe_store(p.y + lane, stride, v.y);
    fe_store(p.z + lane, stride, v.z);
    p.inf[lane] = v.inf ? 1 : 0;
}

// Loads that bypass the read-only and L1 caches (ld.global.cg): for
// buffers the same kernel writes, such as a running sum passed through
// device memory from one loop iteration to the next.
__device__ __forceinline__ fe fe_load_cg(const uint32_t* base, long limb_stride) {
    fe r;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        uint32_t lo = __ldcg(base + (long)(2 * k) * limb_stride);
        uint32_t hi = __ldcg(base + (long)(2 * k + 1) * limb_stride);
        r.v[k] = lo | (hi << 15);
    }
    return r;
}

__device__ __forceinline__ jpt load_pt_cg(const Pts& p, long lane, long stride) {
    jpt v;
    v.x = fe_load_cg(p.x + lane, stride);
    v.y = fe_load_cg(p.y + lane, stride);
    v.z = fe_load_cg(p.z + lane, stride);
    v.inf = __ldcg(p.inf + lane) != 0;
    return v;
}
