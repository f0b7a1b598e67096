// Per-thread Fq2 / Fq6 / Fq12 tower arithmetic for the pairing kernels
// (reference: fields/field2.hpp, field6.hpp, field12.hpp; the JAX package's
// fields/quadratic.py and fields/tower.py, whose formulas these are).
//
// Layout. An Fq2 element is two fe (field.cuh: 9 x 30-bit limbs, internal
// Montgomery form R' = 2^270) and lives in registers. An Fq6 value is three
// Fq2 (c0 + c1 v + c2 v^2, v^3 = xi = 9 + i) and an Fq12 value two Fq6
// (c0 + c1 w, w^2 = v): 54 and 108 words. Those do not fit in registers
// beside the temporaries of a product, so they live in memory - per-lane
// scratch in device memory, or a function's local arrays - and every Fq6 /
// Fq12 function takes them by a strided view V (word k at p[k * s]) and is
// __noinline__: each compiles alone with a small register set, and no
// tower value is carried in registers across a loop or a branch (nvcc
// 12.9's cicc crashed on a point add's result carried so, see
// point_chains.cu). Fq12 word k sits at fe index k / 9, fe index e =
// (i * 3 + j) * 2 + c for w-coordinate i, v-coordinate j and Fq2 component
// c - the order of the package's (2, 3, 2, 18, n) tensors.
//
// Every function reads all of its operands before it writes its result, so
// a result may alias an operand. Field products and sums are exact and
// canonical, so each function gives the JAX package's values bit for bit.
//
// The constants (the field's, the Frobenius coefficients, the inversion
// exponent p - 2 and the BN parameter z) arrive from the Python wrapper into
// the constant bank TC before each launch; nothing is typed in here.
#pragma once
#include "field.cuh"

#define FQ2_WORDS (2 * FE_LIMBS)
#define FQ6_WORDS (3 * FQ2_WORDS)
#define FQ12_WORDS (2 * FQ6_WORDS)
#define TOWER_EXP_WORDS 8

struct TowerConst {
    FieldConst fq;
    // [k - 1][C1, C2, W][component]: xi^((p^k-1)/3), xi^(2(p^k-1)/3), xi^((p^k-1)/6)
    uint32_t frob[3][3][2][FE_LIMBS];
    uint32_t inv_exp[TOWER_EXP_WORDS];  // p - 2, little-endian 32-bit words
    int inv_bits;
    unsigned long long z;               // the BN parameter
    int z_bits;                         // its bit length
};

// host words: frob (162), inv_exp (8), inv_bits, z low, z high, z_bits
#define TOWER_HOST_WORDS (3 * 3 * 2 * FE_LIMBS + TOWER_EXP_WORDS + 4)

__constant__ TowerConst TC;

static inline TowerConst tower_const_from_host(const uint32_t* fq_consts, const uint32_t* w) {
    TowerConst t;
    t.fq = field_const_from_host(fq_consts);
    int i = 0;
    for (int k = 0; k < 3; ++k)
        for (int c = 0; c < 3; ++c)
            for (int h = 0; h < 2; ++h)
                for (int l = 0; l < FE_LIMBS; ++l) t.frob[k][c][h][l] = w[i++];
    for (int l = 0; l < TOWER_EXP_WORDS; ++l) t.inv_exp[l] = w[i++];
    t.inv_bits = (int)w[i++];
    t.z = (unsigned long long)w[i] | ((unsigned long long)w[i + 1] << 32);
    i += 2;
    t.z_bits = (int)w[i];
    return t;
}

// ---------------------------------------------------------------------------
// Fq (the constants from the bank) and Fq2 in registers
// ---------------------------------------------------------------------------
__device__ __forceinline__ fe q_mul(const fe& a, const fe& b) { return fe_mul(a, b, TC.fq); }
__device__ __forceinline__ fe q_add(const fe& a, const fe& b) { return fe_add(a, b, TC.fq); }
__device__ __forceinline__ fe q_sub(const fe& a, const fe& b) { return fe_sub(a, b, TC.fq); }
__device__ __forceinline__ fe q_dbl(const fe& a) { return fe_add(a, a, TC.fq); }

// a^(p-2), square-and-multiply MSB first from a at the top bit, as K1 pow
// runs it (0 -> 0).
__device__ __noinline__ fe q_inv(fe a) {
    fe acc = a;
#pragma unroll 1
    for (int i = TC.inv_bits - 2; i >= 0; --i) {
        acc = q_mul(acc, acc);
        if ((TC.inv_exp[i >> 5] >> (i & 31)) & 1u) acc = q_mul(acc, a);
    }
    return acc;
}

struct fq2 {
    fe c0, c1;
};

__device__ __forceinline__ fq2 f2_add(const fq2& a, const fq2& b) { return {q_add(a.c0, b.c0), q_add(a.c1, b.c1)}; }
__device__ __forceinline__ fq2 f2_sub(const fq2& a, const fq2& b) { return {q_sub(a.c0, b.c0), q_sub(a.c1, b.c1)}; }
__device__ __forceinline__ fq2 f2_dbl(const fq2& a) { return f2_add(a, a); }

__device__ __forceinline__ fq2 f2_neg(const fq2& a) {
    const fe z = fe_zero();
    return {q_sub(z, a.c0), q_sub(z, a.c1)};
}

__device__ __forceinline__ fq2 f2_conj(const fq2& a) { return {a.c0, q_sub(fe_zero(), a.c1)}; }

// Karatsuba over i^2 = -1 (field2.hpp:23-49)
__device__ __forceinline__ fq2 f2_mul(const fq2& a, const fq2& b) {
    const fe t0 = q_mul(a.c0, b.c0);
    const fe t1 = q_mul(a.c1, b.c1);
    const fe t2 = q_mul(q_add(a.c0, a.c1), q_add(b.c0, b.c1));
    return {q_sub(t0, t1), q_sub(t2, q_add(t0, t1))};
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 i (field2.hpp:51-63)
__device__ __forceinline__ fq2 f2_sqr(const fq2& a) {
    const fe t = q_mul(a.c0, a.c1);
    return {q_mul(q_add(a.c0, a.c1), q_sub(a.c0, a.c1)), q_add(t, t)};
}

// a * xi = (9 a0 - a1) + (9 a1 + a0) i, 9a = 8a + a
__device__ __forceinline__ fq2 f2_mul_xi(const fq2& a) {
    return {q_sub(q_add(q_dbl(q_dbl(q_dbl(a.c0))), a.c0), a.c1),
            q_add(q_add(q_dbl(q_dbl(q_dbl(a.c1))), a.c1), a.c0)};
}

// conj(a) / norm(a) (field2.hpp:146-165); 0 -> 0
__device__ __forceinline__ fq2 f2_inv(const fq2& a) {
    const fe inv = q_inv(q_add(q_mul(a.c0, a.c0), q_mul(a.c1, a.c1)));
    return {q_mul(a.c0, inv), q_sub(fe_zero(), q_mul(a.c1, inv))};
}

__device__ __forceinline__ fq2 f2_const(int k, int which) {
    fq2 r;
#pragma unroll
    for (int l = 0; l < FE_LIMBS; ++l) {
        r.c0.v[l] = TC.frob[k - 1][which][0][l];
        r.c1.v[l] = TC.frob[k - 1][which][1][l];
    }
    return r;
}

__device__ __forceinline__ fq2 f2_one() { return {fe_one(TC.fq), fe_zero()}; }
__device__ __forceinline__ fq2 f2_zero() { return {fe_zero(), fe_zero()}; }

// ---------------------------------------------------------------------------
// Views of tower values in memory
// ---------------------------------------------------------------------------
struct V {
    uint32_t* p;
    long s;
};

__device__ __forceinline__ V at(V v, int word) { return {v.p + (long)word * v.s, v.s}; }
__device__ __forceinline__ V fq6_of(V v, int i) { return at(v, i * FQ6_WORDS); }

__device__ __forceinline__ fe ld_fe(V v, int e) {
    fe r;
#pragma unroll
    for (int l = 0; l < FE_LIMBS; ++l) r.v[l] = v.p[(long)(e * FE_LIMBS + l) * v.s];
    return r;
}

__device__ __forceinline__ void st_fe(V v, int e, const fe& x) {
#pragma unroll
    for (int l = 0; l < FE_LIMBS; ++l) v.p[(long)(e * FE_LIMBS + l) * v.s] = x.v[l];
}

__device__ __forceinline__ fq2 ld2(V v, int j) { return {ld_fe(v, 2 * j), ld_fe(v, 2 * j + 1)}; }

__device__ __forceinline__ void st2(V v, int j, const fq2& x) {
    st_fe(v, 2 * j, x.c0);
    st_fe(v, 2 * j + 1, x.c1);
}

// ---------------------------------------------------------------------------
// Fq6 (field6.hpp)
// ---------------------------------------------------------------------------
__device__ __noinline__ void f6_add(V r, V a, V b) {
    for (int j = 0; j < 3; ++j) st2(r, j, f2_add(ld2(a, j), ld2(b, j)));
}

__device__ __noinline__ void f6_sub(V r, V a, V b) {
    for (int j = 0; j < 3; ++j) st2(r, j, f2_sub(ld2(a, j), ld2(b, j)));
}

__device__ __noinline__ void f6_neg(V r, V a) {
    for (int j = 0; j < 3; ++j) st2(r, j, f2_neg(ld2(a, j)));
}

__device__ __noinline__ void f6_copy(V r, V a) {
    for (int k = 0; k < FQ6_WORDS; ++k) r.p[(long)k * r.s] = a.p[(long)k * a.s];
}

// a * v = (xi a2, a0, a1)
__device__ __noinline__ void f6_mul_nr(V r, V a) {
    const fq2 x0 = ld2(a, 0), x1 = ld2(a, 1), x2 = ld2(a, 2);
    st2(r, 0, f2_mul_xi(x2));
    st2(r, 1, x0);
    st2(r, 2, x1);
}

// Toom/Karatsuba cubic mul (field6.hpp:44-124): six Fq2 products
__device__ __noinline__ void f6_mul(V r, V a, V b) {
    const fq2 t0 = f2_mul(ld2(a, 0), ld2(b, 0));
    const fq2 t1 = f2_mul(ld2(a, 1), ld2(b, 1));
    const fq2 t2 = f2_mul(ld2(a, 2), ld2(b, 2));
    const fq2 u0 = f2_sub(f2_mul(f2_add(ld2(a, 1), ld2(a, 2)), f2_add(ld2(b, 1), ld2(b, 2))), f2_add(t1, t2));
    const fq2 u1 = f2_sub(f2_mul(f2_add(ld2(a, 0), ld2(a, 1)), f2_add(ld2(b, 0), ld2(b, 1))), f2_add(t0, t1));
    const fq2 u2 = f2_sub(f2_mul(f2_add(ld2(a, 0), ld2(a, 2)), f2_add(ld2(b, 0), ld2(b, 2))), f2_add(t0, t2));
    st2(r, 0, f2_add(t0, f2_mul_xi(u0)));
    st2(r, 1, f2_add(u1, f2_mul_xi(t2)));
    st2(r, 2, f2_add(u2, t1));
}

// a * (o, 0, vv): the product above with b1 = 0 (five Fq2 products)
__device__ __noinline__ void f6_mul_02(V r, V a, const fq2& o, const fq2& vv) {
    const fq2 t0 = f2_mul(ld2(a, 0), o);
    const fq2 t2 = f2_mul(ld2(a, 2), vv);
    const fq2 c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(ld2(a, 1), ld2(a, 2)), vv), t2)));
    const fq2 c1 = f2_add(f2_sub(f2_mul(f2_add(ld2(a, 0), ld2(a, 1)), o), t0), f2_mul_xi(t2));
    const fq2 c2 = f2_sub(f2_mul(f2_add(ld2(a, 0), ld2(a, 2)), f2_add(o, vv)), f2_add(t0, t2));
    st2(r, 0, c0);
    st2(r, 1, c1);
    st2(r, 2, c2);
}

// a * (0, vw, 0) = (xi a2 vw, a0 vw, a1 vw)
__device__ __noinline__ void f6_mul_1(V r, V a, const fq2& vw) {
    const fq2 c0 = f2_mul_xi(f2_mul(ld2(a, 2), vw));
    const fq2 c1 = f2_mul(ld2(a, 0), vw);
    const fq2 c2 = f2_mul(ld2(a, 1), vw);
    st2(r, 0, c0);
    st2(r, 1, c1);
    st2(r, 2, c2);
}

// (field6.hpp:184-228)
__device__ __noinline__ void f6_inv(V r, V a) {
    const fq2 a0 = ld2(a, 0), a1 = ld2(a, 1), a2 = ld2(a, 2);
    const fq2 c0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)));
    const fq2 c1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1));
    const fq2 c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2));
    const fq2 t = f2_inv(f2_add(f2_mul(a0, c0), f2_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2)))));
    st2(r, 0, f2_mul(c0, t));
    st2(r, 1, f2_mul(c1, t));
    st2(r, 2, f2_mul(c2, t));
}

// (field6.hpp:267-293): conjugate each coordinate for odd k, scale c1 / c2
__device__ __noinline__ void f6_frob(V r, V a, int k) {
    for (int j = 0; j < 3; ++j) {
        fq2 x = ld2(a, j);
        if (k & 1) x = f2_conj(x);
        if (j > 0) x = f2_mul(x, f2_const(k, j - 1));
        st2(r, j, x);
    }
}

// ---------------------------------------------------------------------------
// Fq12 (field12.hpp)
// ---------------------------------------------------------------------------
#define LOCAL6(name)            \
    uint32_t name##_w[FQ6_WORDS]; \
    const V name = {name##_w, 1}

__device__ __noinline__ void f12_copy(V r, V a) {
    for (int k = 0; k < FQ12_WORDS; ++k) r.p[(long)k * r.s] = a.p[(long)k * a.s];
}

__device__ __noinline__ void f12_one(V r) {
    const fe one = fe_one(TC.fq), zero = fe_zero();
    for (int e = 0; e < 12; ++e) st_fe(r, e, e == 0 ? one : zero);
}

// r = m ? a : r, word by word (the uniform step's select: no tower op under
// a branch)
__device__ __noinline__ void f12_select(V r, bool m, V a) {
    for (int k = 0; k < FQ12_WORDS; ++k) {
        const uint32_t x = a.p[(long)k * a.s], y = r.p[(long)k * r.s];
        r.p[(long)k * r.s] = m ? x : y;
    }
}

__device__ __noinline__ void f12_mul(V r, V a, V b) {
    LOCAL6(t0);
    LOCAL6(t1);
    LOCAL6(sa);
    LOCAL6(sb);
    f6_mul(t0, fq6_of(a, 0), fq6_of(b, 0));
    f6_mul(t1, fq6_of(a, 1), fq6_of(b, 1));
    f6_add(sa, fq6_of(a, 0), fq6_of(a, 1));
    f6_add(sb, fq6_of(b, 0), fq6_of(b, 1));
    f6_mul(sa, sa, sb);  // (a0 + a1)(b0 + b1); a and b are read
    f6_add(sb, t0, t1);
    f6_sub(fq6_of(r, 1), sa, sb);
    f6_mul_nr(t1, t1);
    f6_add(fq6_of(r, 0), t0, t1);
}

// c0 = (a0 + a1)(a0 + v a1) - (t + v t), c1 = 2t, t = a0 a1
__device__ __noinline__ void f12_sqr(V r, V a) {
    LOCAL6(t);
    LOCAL6(s);
    LOCAL6(q);
    f6_mul(t, fq6_of(a, 0), fq6_of(a, 1));
    f6_add(s, fq6_of(a, 0), fq6_of(a, 1));
    f6_mul_nr(q, fq6_of(a, 1));
    f6_add(q, fq6_of(a, 0), q);  // a is read
    f6_mul(s, s, q);
    f6_mul_nr(q, t);
    f6_add(q, t, q);
    f6_sub(fq6_of(r, 0), s, q);
    f6_add(fq6_of(r, 1), t, t);
}

// unitary inverse (field12.hpp:230)
__device__ __noinline__ void f12_conj(V r, V a) {
    if (r.p != a.p) f6_copy(fq6_of(r, 0), fq6_of(a, 0));
    f6_neg(fq6_of(r, 1), fq6_of(a, 1));
}

__device__ __noinline__ void f12_inv(V r, V a) {
    LOCAL6(t);
    LOCAL6(u);
    f6_mul(t, fq6_of(a, 0), fq6_of(a, 0));
    f6_mul(u, fq6_of(a, 1), fq6_of(a, 1));
    f6_mul_nr(u, u);
    f6_sub(t, t, u);
    f6_inv(t, t);
    f6_mul(fq6_of(r, 0), fq6_of(a, 0), t);
    f6_mul(fq6_of(r, 1), fq6_of(a, 1), t);
    f6_neg(fq6_of(r, 1), fq6_of(r, 1));
}

// (field12.hpp:200-222)
__device__ __noinline__ void f12_frob(V r, V a, int k) {
    f6_frob(fq6_of(r, 0), fq6_of(a, 0), k);
    f6_frob(fq6_of(r, 1), fq6_of(a, 1), k);
    const fq2 w = f2_const(k, 2);
    for (int j = 0; j < 3; ++j) st2(fq6_of(r, 1), j, f2_mul(ld2(fq6_of(r, 1), j), w));
}

// Granger-Scott cyclotomic squaring (field12.hpp:224), the host tower's
// coordinate mapping: x0..x2 = c0's, x3..x5 = c1's Fq2 coordinates
__device__ __noinline__ void f12_csq(V r, V a) {
    uint32_t z_w[FQ12_WORDS];
    const V z = {z_w, 1};
    {
        const fq2 x0 = ld2(a, 0), x4 = ld2(a, 4);
        const fq2 t0 = f2_sqr(x4), t1 = f2_sqr(x0);
        const fq2 t6 = f2_sub(f2_sqr(f2_add(x4, x0)), f2_add(t0, t1));
        const fq2 s = f2_add(f2_mul_xi(t0), t1);
        st2(z, 0, f2_add(f2_dbl(f2_sub(s, x0)), s));
        st2(z, 4, f2_add(f2_dbl(f2_add(t6, x4)), t6));
    }
    {
        const fq2 x2 = ld2(a, 2), x3 = ld2(a, 3);
        const fq2 t2 = f2_sqr(x2), t3 = f2_sqr(x3);
        const fq2 t7 = f2_sub(f2_sqr(f2_add(x2, x3)), f2_add(t2, t3));
        const fq2 s = f2_add(f2_mul_xi(t2), t3);
        st2(z, 1, f2_add(f2_dbl(f2_sub(s, ld2(a, 1))), s));
        st2(z, 5, f2_add(f2_dbl(f2_add(t7, ld2(a, 5))), t7));
    }
    {
        const fq2 x5 = ld2(a, 5), x1 = ld2(a, 1);
        const fq2 t4 = f2_sqr(x5), t5 = f2_sqr(x1);
        const fq2 t8 = f2_mul_xi(f2_sub(f2_sqr(f2_add(x5, x1)), f2_add(t4, t5)));
        const fq2 s = f2_add(f2_mul_xi(t4), t5);
        st2(z, 2, f2_add(f2_dbl(f2_sub(s, ld2(a, 2))), s));
        st2(z, 3, f2_add(f2_dbl(f2_add(t8, ld2(a, 3))), t8));
    }
    f12_copy(r, z);
}

// f = f * line, the line the sparse element with c0 = (o, 0, vv), c1 = (0,
// vw, 0) (field12.hpp sparse_mul): 14 Fq2 products in place of 18
__device__ __noinline__ void f12_sparse_mul(V f, const fq2& o, const fq2& vw, const fq2& vv) {
    LOCAL6(t0);
    LOCAL6(t1);
    LOCAL6(s);
    LOCAL6(l);
    f6_mul_02(t0, fq6_of(f, 0), o, vv);
    f6_mul_1(t1, fq6_of(f, 1), vw);
    f6_add(s, fq6_of(f, 0), fq6_of(f, 1));
    st2(l, 0, o);
    st2(l, 1, vw);
    st2(l, 2, vv);
    f6_mul(s, s, l);  // (f0 + f1)(o, vw, vv); f is read
    f6_add(l, t0, t1);
    f6_sub(fq6_of(f, 1), s, l);
    f6_mul_nr(t1, t1);
    f6_add(fq6_of(f, 0), t0, t1);
}

// a^(-z) for a cyclotomic a (pairing.cpp:269-284): cyclotomic squarings over
// z's bits below its top bit, MSB first, each followed by mul(r, a) kept
// where the bit is set, then the unitary inverse. t: scratch, r != a.
__device__ __noinline__ void f12_expz(V r, V a, V t) {
    f12_copy(r, a);
#pragma unroll 1
    for (int i = TC.z_bits - 2; i >= 0; --i) {
        f12_csq(r, r);
        f12_mul(t, r, a);
        f12_select(r, (TC.z >> i) & 1ull, t);
    }
    f12_conj(r, r);
}
