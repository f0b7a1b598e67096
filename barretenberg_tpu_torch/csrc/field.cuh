// Per-thread BN254 prime-field arithmetic for the CUDA kernels.
//
// Storage contract (shared with the plain PyTorch version and the JAX
// package): a field element is 18 limbs of 15 bits, least significant
// first, planar - limb i of lane j lives at base[i * limb_stride + j *
// lane_stride] - canonical (< p), in internal Montgomery form with
// R' = 2^270.
//
// In registers an element is repacked to 9 limbs of 30 bits (two stored
// limbs each), so R' = 2^(9*30) stays the Montgomery radix and a Hopper
// thread multiplies with mul.wide.u32 into 64-bit accumulators: one
// operand-scanning Montgomery multiply is 162 wide multiplies plus 9 for
// the quotient digits, each column summed in its own 64-bit word.
// The modulus, -p^-1 mod 2^30 and R' mod p arrive in a FieldConst passed
// by value to each kernel (param space is a constant bank), filled in by
// the Python wrapper from the package's FieldParams - nothing is typed in
// here.
#pragma once
#include <stdint.h>

#define FE_LIMBS 9          // 30-bit limbs held in registers
#define FE_MASK 0x3FFFFFFFu
#define LIMB15_MASK 0x7FFFu

struct FieldConst {
    uint32_t p[FE_LIMBS];    // modulus
    uint32_t one[FE_LIMBS];  // R' mod p (Montgomery one)
    uint32_t ninv;           // -p^-1 mod 2^30
};

struct fe {
    uint32_t v[FE_LIMBS];
};

// Host side: consts is 19 words in host memory - p[9], one[9], ninv.
static inline FieldConst field_const_from_host(const uint32_t* consts) {
    FieldConst fc;
    for (int k = 0; k < FE_LIMBS; ++k) {
        fc.p[k] = consts[k];
        fc.one[k] = consts[FE_LIMBS + k];
    }
    fc.ninv = consts[2 * FE_LIMBS];
    return fc;
}

__device__ __forceinline__ fe fe_load(const uint32_t* __restrict__ base, long limb_stride) {
    fe r;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        uint32_t lo = base[(long)(2 * k) * limb_stride];
        uint32_t hi = base[(long)(2 * k + 1) * limb_stride];
        r.v[k] = lo | (hi << 15);
    }
    return r;
}

__device__ __forceinline__ void fe_store(uint32_t* __restrict__ base, long limb_stride, const fe& a) {
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        base[(long)(2 * k) * limb_stride] = a.v[k] & LIMB15_MASK;
        base[(long)(2 * k + 1) * limb_stride] = a.v[k] >> 15;
    }
}

__device__ __forceinline__ fe fe_zero() {
    fe r;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) r.v[k] = 0;
    return r;
}

__device__ __forceinline__ fe fe_one(const FieldConst& fc) {
    fe r;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) r.v[k] = fc.one[k];
    return r;
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) acc |= a.v[k];
    return acc == 0;
}

__device__ __forceinline__ fe fe_select(bool m, const fe& a, const fe& b) {
    fe r;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) r.v[k] = m ? a.v[k] : b.v[k];
    return r;
}

// a (< 2p, normalised 30-bit limbs) -> a mod p, branch-free.
__device__ __forceinline__ fe fe_cond_sub_p(const fe& a, const FieldConst& fc) {
    fe d;
    uint32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        uint32_t v = a.v[k] - fc.p[k] - borrow;  // wraps mod 2^32 when negative
        borrow = v >> 31;                        // operands < 2^30, so bit 31 = sign
        d.v[k] = v & FE_MASK;
    }
    return fe_select(borrow == 0, d, a);
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b, const FieldConst& fc) {
    fe s;
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        uint32_t v = a.v[k] + b.v[k] + carry;  // < 2^31 + 1
        s.v[k] = v & FE_MASK;
        carry = v >> 30;
    }
    // a + b < 2p < 2^255 fits 270 bits: the top carry is zero
    return fe_cond_sub_p(s, fc);
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b, const FieldConst& fc) {
    fe d;
    uint32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        uint32_t v = a.v[k] - b.v[k] - borrow;
        borrow = v >> 31;
        d.v[k] = v & FE_MASK;
    }
    fe e;
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        uint32_t v = d.v[k] + fc.p[k] + carry;
        e.v[k] = v & FE_MASK;
        carry = v >> 30;
    }
    return fe_select(borrow != 0, e, d);
}

__device__ __forceinline__ fe fe_dbl(const fe& a, const FieldConst& fc) {
    return fe_add(a, a, fc);
}

// Montgomery product a * b * 2^-270 mod p, canonical output.
// Operand scanning with lazy carries: per digit b[i] one pass adds a*b[i]
// and m*p into nine 64-bit column sums and shifts them down one column;
// only the lowest column is reduced (its carry goes to the next), so a
// digit's dependent work is a few instructions, not a 9-limb carry chain,
// and a thread running a long chain of products waits less on each.
// Bounds: a, b < p, so limbs are < 2^30 and the top limbs of a, b and p
// < 2^14; a column's products and carry-in stay below 2^63.4 for both
// BN254 moduli (tests/test_torch_field_bounds.py checks this bound).
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b, const FieldConst& fc) {
    uint64_t t[FE_LIMBS];  // at digit i, slot j holds column i + j
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < FE_LIMBS; ++i) {
        uint32_t bi = b.v[i];
        uint64_t t0 = t[0] + (uint64_t)a.v[0] * bi;
        uint32_t m = ((uint32_t)t0 * fc.ninv) & FE_MASK;
        t0 += (uint64_t)m * fc.p[0];  // low 30 bits now zero
#pragma unroll
        for (int j = 1; j < FE_LIMBS; ++j) t[j - 1] = t[j] + (uint64_t)a.v[j] * bi + (uint64_t)m * fc.p[j];
        t[0] += t0 >> 30;
        t[FE_LIMBS - 1] = 0;
    }
    // columns 9..17 -> 30-bit limbs; the result < 2p < 2^255 has no carry out
    fe r;
    uint64_t carry = 0;
#pragma unroll
    for (int k = 0; k < FE_LIMBS; ++k) {
        uint64_t v = t[k] + carry;
        r.v[k] = (uint32_t)v & FE_MASK;
        carry = v >> 30;
    }
    return fe_cond_sub_p(r, fc);
}

__device__ __forceinline__ fe fe_sqr(const fe& a, const FieldConst& fc) {
    return fe_mul(a, a, fc);
}
