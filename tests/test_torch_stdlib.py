"""The port's stdlib gadgets on the CPU: field_t, bool_t, Uint32, BitArray,
SHA-256 and MiMC give the JAX package's values and native arithmetic's
(hashlib's NIST vectors for SHA-256, Python integers for the rest), their
circuits are satisfied, and forged witnesses break them as in the JAX
tests. The composer state these gadgets leave is held against the JAX
package's in tests/test_torch_composer.py."""

import hashlib

import pytest
import torch

from barretenberg_tpu.stdlib import mimc as j_mimc

from barretenberg_tpu_torch.composer import StandardComposer
from barretenberg_tpu_torch.fields.params import FR_MODULUS as P
from barretenberg_tpu_torch.stdlib import BitArray, Uint32, bool_t, field_t, mimc as t_mimc, sha256, witness_t

from test_torch_composer import assert_proofs_equal
from torch_circuits import JAX, MASK, NIST_VECTORS, PORT, STDLIB_CIRCUITS

torch.set_num_threads(1)


def _cipher(x: int, k: int) -> int:
    for c in t_mimc.ROUND_CONSTANTS:
        x = pow((x + k + c) % P, 7, P)
    return x


def _native() -> dict:
    """What the gadgets of each STDLIB_CIRCUITS circuit must return."""
    a, b = 11, 23
    bools = []
    for x in (0, 1):
        for y in (0, 1):
            bools += [x & y, x | y, x ^ y, 1 - x, int(x == y), (1 - x) & y, x ^ y, (1 - x) | (1 - y)]
    arith = [(0xDEADBEEF + 0x12345678) & MASK, (0xDEADBEEF - 0x12345678) & MASK,
             (0x12345678 - 0xDEADBEEF) & MASK, (0xDEADBEEF * 0x12345678) & MASK]
    for x, y in ((0xDEADBEEF, 0x1234), (0x12345678, 0xDEADBEEF), (0xFFFFFFFF, 1),
                 (0xFFFFFFFF, 0xFFFFFFFF), (7, 3)):
        arith += [x // y, x % y]
    arith += [14, 2]
    x, y = 0xCAFEF00D, 0x31415926
    bitwise = [x & y, x | y, x ^ y, ~x & MASK]
    for s in (1, 3, 13, 31):
        bitwise += [x >> s, (x << s) & MASK, ((x >> s) | (x << (32 - s))) & MASK,
                    ((x << s) | (x >> (32 - s))) & MASK]
    bitwise += [True, False, True, True, False, True, True]
    carry = sum(0xFFFFFFFF - i * 7 for i in range(50)) & MASK
    return {
        "field_add_mul_div": [a * 5 + 3, a * b, a + b, (a + b) * pow(b, -1, P) % P,
                              ((a - b) * pow(7, -1, P) - 2 * b) % P],
        "bool_truth_tables": [bool(v) for v in bools],
        "uint32_arithmetic": arith,
        "uint32_bitwise": bitwise,
        "uint32_lazy_carry": [carry, carry],
        "uint32_small": [(0xAABBCCDD + 0x11223344) & MASK],
        **{f"sha256_{k}": [hashlib.sha256(m).digest()] for k, m in NIST_VECTORS.items()},
        "mimc7_standard": [t_mimc.mimc7_host([1, 2, 3])],
        "mimc7_native": [t_mimc.mimc7_host([77, 88])],
        "mimc_cipher": [_cipher(12345, 678)],
    }


NATIVE = _native()


@pytest.mark.parametrize("name", sorted(STDLIB_CIRCUITS))
def test_gadgets_equal_jax_and_native(name):
    tctx, tvals = STDLIB_CIRCUITS[name](PORT)
    _, jvals = STDLIB_CIRCUITS[name](JAX)
    assert tvals == jvals == NATIVE[name]
    assert tctx.check_circuit()


def test_mimc_round_constants_and_host_oracle():
    assert t_mimc.ROUND_CONSTANTS == j_mimc.ROUND_CONSTANTS
    assert len(t_mimc.ROUND_CONSTANTS) == t_mimc.NUM_ROUNDS == 91
    for values in ([], [0], [1, 2, 3], [77, 88], [P - 1, 12345, 0]):
        assert t_mimc.mimc7_host(values) == j_mimc.mimc7_host(values)
    assert t_mimc.mimc7_host([5]) == (_cipher(5, 0) + 5) % P


def test_mimc_composers_agree():
    """test_stdlib.py::TestMiMC::test_mimc7_composers_agree: the standard
    composer's five gates a round and the MiMC composer's native gate."""
    (ctx_s, out_s), (ctx_m, out_m) = STDLIB_CIRCUITS["mimc7_standard"](PORT), STDLIB_CIRCUITS["mimc7_native"](PORT)
    values = [77, 88]
    ctx = StandardComposer()
    out = t_mimc.mimc7([field_t.from_witness(witness_t(ctx, v)) for v in values])
    assert out.get_value() == out_m[0] == t_mimc.mimc7_host(values)
    assert ctx.check_circuit() and ctx_m.check_circuit() and ctx_s.check_circuit()
    # a round: one add gate (x + k), then x^2, x^4, x^6, x^7 as poly gates;
    # a block: two adds into the next key
    assert ctx.n == 2 * 91 * 5 + 2 * 2


def test_forged_witnesses_break_circuits():
    """The JAX tests' soundness checks: a forged assert_equal, AND output,
    division quotient and SHA-256 output bit."""
    ctx = StandardComposer()
    x = field_t.from_witness(witness_t(ctx, 5))
    (x + 1).assert_equal(field_t(ctx, value=5))
    assert not ctx.check_circuit()

    ctx = StandardComposer()
    z = bool_t.from_witness(witness_t(ctx, 1)) & bool_t.from_witness(witness_t(ctx, 1))
    ctx.variables[z.witness_index] = 0
    assert not ctx.check_circuit()

    ctx = StandardComposer()
    q = Uint32.from_witness(witness_t(ctx, 1000)) // Uint32.from_witness(witness_t(ctx, 7))
    assert ctx.check_circuit() and q.get_value() == 142
    idx = q._accumulator().witness_index
    ctx.variables[idx] += 1
    assert not ctx.check_circuit()

    ctx = StandardComposer()
    out = sha256(BitArray.from_string(ctx, b"abc"))
    assert ctx.check_circuit()
    idx = out[0].witness_index
    ctx.variables[idx] = 1 - ctx.variables[idx]
    assert not ctx.check_circuit()


def test_bitarray_layout():
    """Bit 0 is the LSB of the last word; the first byte is the most
    significant (bitarray.tcc), and words round-trip through Uint32."""
    ctx = StandardComposer()
    data = bytes(range(1, 9))
    bits = BitArray.from_string(ctx, data)
    assert bits.length == 64 and bits.to_bytes() == data
    assert bits.get_value() == int.from_bytes(data, "big")
    words = bits.to_uint32s()
    assert [w.get_value() for w in words] == [0x01020304, 0x05060708]
    assert BitArray.from_uint32s(words).to_bytes() == data


@pytest.mark.slow
def test_uint32_circuit_proof_bytes_equal_jax():
    """test_stdlib.py's small uint32 circuit (n = 512) proved by the port to
    the JAX prover's bytes. Marked slow: about five minutes for each
    package's prove on a CPU."""
    jctx, _ = STDLIB_CIRCUITS["uint32_small"](JAX)
    tctx, _ = STDLIB_CIRCUITS["uint32_small"](PORT)
    assert_proofs_equal(jctx, tctx, {"w_o_shifted_eval": False, "q_mimc_coefficient_eval": False})
