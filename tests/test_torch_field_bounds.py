"""The 64-bit column bound of the CUDA kernels' Montgomery product.

`fe_mul` in `barretenberg_tpu_torch/csrc/field.cuh` sums each column of
a * b + m * p in one 64-bit word and reduces only the lowest column per digit,
so its correctness rests on no column sum reaching 2^64. These tests model
that loop step by step with Python integers:

- an upper bound on every 64-bit intermediate, from the loop run with every
  limb of a and b at its largest value (2^30 - 1, the top limb at p's top
  limb, as a, b < p) and every quotient digit m at 2^30 - 1 (each step only
  adds, multiplies and shifts right, so larger inputs never give smaller
  intermediates);
- the model's output against a * b * 2^-270 mod p on edge and seeded
  operands, each intermediate checked below 2^64 on the way.
"""

import numpy as np
import pytest

from barretenberg_tpu_torch.fields.params import FQ_PARAMS, FR_PARAMS, R_INTERNAL

LIMBS, BITS = 9, 30
MASK = (1 << BITS) - 1
WORD = 1 << 64
PARAMS = {"fq": FQ_PARAMS, "fr": FR_PARAMS}


def limbs(v: int) -> list:
    return [(v >> (BITS * k)) & MASK for k in range(LIMBS)]


def fe_mul_model(a: list, b: list, p: list, ninv: int, m_of=None):
    """field.cuh's fe_mul before its final conditional subtraction: returns
    (30-bit result limbs, carry out of the top limb, largest 64-bit
    intermediate). m_of(t0, ninv) gives the quotient digit; by default the
    kernel's (t0 * ninv) mod 2^30."""
    m_of = m_of or (lambda t0, n: (t0 * n) & MASK)
    t = [0] * LIMBS
    top = 0
    for i in range(LIMBS):
        t0 = t[0] + a[0] * b[i]
        m = m_of(t0, ninv)
        t0 += m * p[0]
        top = max(top, t0)
        for j in range(1, LIMBS):
            t[j - 1] = t[j] + a[j] * b[i] + m * p[j]
            top = max(top, t[j - 1])
        t[0] += t0 >> BITS
        top = max(top, t[0])
        t[LIMBS - 1] = 0
    out, carry = [], 0
    for k in range(LIMBS):
        v = t[k] + carry
        top = max(top, v)
        out.append(v & MASK)
        carry = v >> BITS
    return out, carry, top


@pytest.mark.parametrize("field", sorted(PARAMS))
def test_fe_mul_columns_stay_below_2_64(field):
    p = PARAMS[field].modulus
    pl = limbs(p)
    widest = [MASK] * (LIMBS - 1) + [pl[-1]]
    _, carry, top = fe_mul_model(widest, widest, pl, 0, m_of=lambda t0, n: MASK)
    assert top < 2**63.4 < WORD
    assert carry == 0


@pytest.mark.parametrize("field", sorted(PARAMS))
def test_fe_mul_model_is_the_montgomery_product(field):
    p = PARAMS[field].modulus
    pl = limbs(p)
    ninv = (-pow(p, -1, 1 << BITS)) % (1 << BITS)
    rinv = pow(R_INTERNAL, -1, p)
    rng = np.random.default_rng(3)
    edge = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, R_INTERNAL % p, (1 << 253) % p]
    seeded = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(24)]
    values = edge + seeded
    for a in values:
        for b in edge + seeded[:4]:
            out, carry, top = fe_mul_model(limbs(a), limbs(b), pl, ninv)
            assert top < WORD and carry == 0
            r = sum(v << (BITS * k) for k, v in enumerate(out))
            assert r < 2 * p
            assert r % p == a * b * rinv % p


def _section(src: str, start: str, end: str) -> str:
    return src[src.index(start) : src.index(end, src.index(start))]


@pytest.mark.parametrize("source, start, end", [
    ("msm_kernels.cu", "// K3c\n", "// K4\n"),
    ("field_kernels.cu", "// scan\n", "// dot\n"),
])
def test_redesigned_kernels_add_no_64_bit_accumulator(source, start, end):
    """K3c's cooperative point operations and K1 scan's tiles compute every
    product with fe_mul and every sum with fe_add / fe_sub, so the bound
    above is the only 64-bit column bound they rest on: their sections of
    the source declare no 64-bit word of their own."""
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "barretenberg_tpu_torch", "csrc", source)
    with open(path) as f:
        body = _section(f.read(), start, end)
    assert "fe_mul" in body
    assert "uint64_t" not in body and "long long" not in body
