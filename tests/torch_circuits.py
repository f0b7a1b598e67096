"""The JAX package's test circuits, written once against a composer module and
a stdlib module, so that the same code builds each circuit with the JAX
package and with its port (tests/test_torch_composer.py,
tests/test_torch_stdlib.py).

Each function mirrors a circuit of tests/test_composer.py,
test_composers_extra.py, test_extended_composer.py or test_stdlib.py and
returns ``(composer, values)``: the composer in the state that test leaves
it before ``preprocess`` (after ``create_dummy_gates`` where the test calls
it), and the gadgets' outputs as host values."""

from __future__ import annotations

import types

import barretenberg_tpu.composer as j_composer
import barretenberg_tpu.stdlib as j_stdlib

import barretenberg_tpu_torch.composer as t_composer
import barretenberg_tpu_torch.stdlib as t_stdlib
from barretenberg_tpu_torch.fields.params import FR_MODULUS as P

JAX = types.SimpleNamespace(composer=j_composer, stdlib=j_stdlib)
PORT = types.SimpleNamespace(composer=t_composer, stdlib=t_stdlib)

MASK = 0xFFFFFFFF
NIST_VECTORS = {
    "abc": b"abc",
    "empty": b"",
    "two_block": b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
}


# ---------------------------------------------------------------- composers
def standard(ns, num_pairs: int = 6, unsatisfied: bool = False):
    """test_composer.py::build_circuit (and its unsatisfied variant)."""
    c = ns.composer
    ctx = c.StandardComposer()
    for i in range(num_pairs):
        if unsatisfied:
            a, b = 3 + i, 5 + i
            prod = (a * b + 1) % P
        else:
            a, b = 3 + i, 7 + 2 * i
            prod = a * b % P
        a_idx = ctx.add_variable(a)
        b_idx = ctx.add_variable(b)
        c_idx = ctx.add_variable(prod)
        if unsatisfied:
            ctx.create_mul_gate(c.MulTriple(a_idx, b_idx, c_idx, 1, P - 1, 0))
            d_idx = ctx.add_variable((a + b) % P)
        else:
            d_idx = ctx.add_variable((a + b) % P)
            ctx.create_mul_gate(c.MulTriple(a_idx, b_idx, c_idx, 1, P - 1, 0))
        ctx.create_add_gate(c.AddTriple(a_idx, b_idx, d_idx, 1, 1, P - 1, 0))
    ctx.create_dummy_gates()
    return ctx, []


def boolean(ns, tamper: bool = False):
    """test_composers_extra.py::build_bool_circuit."""
    c = ns.composer
    ctx = c.BoolComposer()
    for a, b in ((1, 0), (1, 1), (0, 0), (0, 1)):
        a_idx = ctx.add_variable(a)
        b_idx = ctx.add_variable(b)
        c_idx = ctx.add_variable(a * b % P)
        d_idx = ctx.add_variable((a + b) % P)
        ctx.create_bool_gate(a_idx)
        ctx.create_bool_gate(b_idx)
        ctx.create_mul_gate(c.MulTriple(a_idx, b_idx, c_idx, 1, P - 1, 0))
        ctx.create_add_gate(c.AddTriple(a_idx, b_idx, d_idx, 1, 1, P - 1, 0))
    if tamper:
        x = ctx.add_variable(2)
        y = ctx.add_variable(4)
        ctx.create_bool_gate(x)
        ctx.create_mul_gate(c.MulTriple(x, x, y, 1, P - 1, 0))
    ctx.create_dummy_gates()
    return ctx, []


def mimc(ns, rounds: int = 3, tamper: bool = False):
    """test_composers_extra.py::build_mimc_circuit."""
    c = ns.composer
    ctx = c.MiMCComposer()
    x, k = 11, 223
    x_idx = ctx.add_variable(x)
    k_idx = ctx.add_variable(k)
    for r in range(rounds):
        const = 5 + r
        t = (x + k + const) % P
        cubed = pow(t, 3, P)
        out = t * cubed % P * cubed % P
        if tamper and r == rounds - 1:
            out = (out + 1) % P
        cubed_idx = ctx.add_variable(cubed)
        out_idx = ctx.add_variable(out)
        ctx.create_mimc_gate(c.MiMCQuadruplet(x_idx, k_idx, cubed_idx, out_idx, const))
        x_idx, x = out_idx, out
    ctx.create_dummy_gates()
    return ctx, []


def extended_chain(ns, length: int = 6):
    """test_extended_composer.py::build_chain_circuit."""
    s = ns.stdlib
    ctx = ns.composer.ExtendedComposer()
    acc = s.field_t.from_witness(s.witness_t(ctx, 1))
    for i in range(length):
        acc = acc + s.field_t.from_witness(s.witness_t(ctx, i + 2))
    acc.assert_equal(s.field_t(ctx, value=1 + sum(i + 2 for i in range(length))))
    ctx.create_dummy_gates()
    return ctx, [acc.get_value()]


def _add(ns, ctx, a, b, o):
    ctx.create_add_gate(ns.composer.AddTriple(a, b, o, 1, 1, P - 1, 0))


def extended_basic_add(ns):
    """test_extended_composer.py::test_basic_add_chain_gate_counts (no
    dummy gates)."""
    ctx = ns.composer.ExtendedComposer()
    w = [ctx.add_variable(v) for v in (1, 1, 2, 1, 3, 1, 4)]
    _add(ns, ctx, w[0], w[1], w[2])
    _add(ns, ctx, w[2], w[3], w[4])
    _add(ns, ctx, w[4], w[5], w[6])
    return ctx, []


def extended_basic_mul_add(ns):
    """test_extended_composer.py::test_basic_mul_add_gate_counts."""
    ctx = ns.composer.ExtendedComposer()
    w = [ctx.add_variable(v) for v in (2, 3, 6, 1, 7, 1, 8)]
    ctx.create_mul_gate(ns.composer.MulTriple(w[0], w[1], w[2], 1, P - 1, 0))
    _add(ns, ctx, w[2], w[3], w[4])
    _add(ns, ctx, w[4], w[5], w[6])
    return ctx, []


def extended_anchoring(ns):
    """test_extended_composer.py::test_anchoring_rewrite_between_adjacent_quads
    (and test_anchored_chain_proves_and_verifies)."""
    ctx = ns.composer.ExtendedComposer()
    a, b, cc, d, e, f, g, h, i_ = (ctx.add_variable(v) for v in (1, 2, 3, 4, 7, 5, 12, 6, 18))
    _add(ns, ctx, a, b, cc)
    _add(ns, ctx, cc, d, e)
    _add(ns, ctx, e, f, g)
    _add(ns, ctx, g, h, i_)
    ctx.create_dummy_gates()
    return ctx, []


def extended_bad_witness(ns):
    """test_extended_composer.py::test_extended_composer_rejects_bad_witness."""
    s = ns.stdlib
    ctx = ns.composer.ExtendedComposer()
    a = s.field_t.from_witness(s.witness_t(ctx, 3))
    b = s.field_t.from_witness(s.witness_t(ctx, 4))
    c = a + b
    d = c + a
    ctx.variables[d.witness_index] = 11
    ctx.create_dummy_gates()
    return ctx, []


def extended_mixed(ns):
    """test_extended_composer.py::test_extended_composer_mixed_gates."""
    s = ns.stdlib
    ctx = ns.composer.ExtendedComposer()
    a = s.field_t.from_witness(s.witness_t(ctx, 5))
    b = s.field_t.from_witness(s.witness_t(ctx, 7))
    c = a * b
    d = c + a
    e = d * b
    f = e + d + c
    f.assert_equal(s.field_t(ctx, value=f.get_value()))
    ctx.create_dummy_gates()
    return ctx, [f.get_value()]


# ------------------------------------------------------------------- stdlib
def field_add_mul_div(ns):
    """test_stdlib.py::TestFieldT::test_add_mul_div, with the lazy-constant
    and assert_equal circuits."""
    s = ns.stdlib
    ctx = ns.composer.StandardComposer()
    a = s.field_t.from_witness(s.witness_t(ctx, 11))
    b = s.field_t.from_witness(s.witness_t(ctx, 23))
    lazy = a * 5 + 3
    c = a * b
    d = a + b
    e = d / b
    f = (a - b) / 7 - 2 * b
    (a + a).assert_equal(s.field_t(ctx, value=22))
    ctx.create_dummy_gates()
    return ctx, [v.get_value() for v in (lazy, c, d, e, f)]


def bool_truth_tables(ns):
    """test_stdlib.py::TestBoolT::test_truth_tables, all four inputs in one
    circuit."""
    s = ns.stdlib
    ctx = ns.composer.StandardComposer()
    values = []
    for a in (0, 1):
        for b in (0, 1):
            x = s.bool_t.from_witness(s.witness_t(ctx, a))
            y = s.bool_t.from_witness(s.witness_t(ctx, b))
            for v in (x & y, x | y, x ^ y, ~x, x == y, (~x) & y, (~x) ^ (~y), (~x) | (~y)):
                values.append(v.get_value())
    ctx.create_dummy_gates()
    return ctx, values


def uint32_arithmetic(ns):
    """test_stdlib.py::TestUint32::test_arithmetic_vs_native and
    test_divmod_vs_native."""
    U, w = ns.stdlib.Uint32, ns.stdlib.witness_t
    ctx = ns.composer.StandardComposer()
    a, b = 0xDEADBEEF, 0x12345678
    ua, ub = U.from_witness(w(ctx, a)), U.from_witness(w(ctx, b))
    values = [(ua + ub).get_value(), (ua - ub).get_value(), (ub - ua).get_value(),
              (ua * ub).normalize().get_value()]
    for x, y in ((0xDEADBEEF, 0x1234), (0x12345678, 0xDEADBEEF), (0xFFFFFFFF, 1),
                 (0xFFFFFFFF, 0xFFFFFFFF), (7, 3)):
        ux, uy = U.from_witness(w(ctx, x)), U.from_witness(w(ctx, y))
        values += [(ux // uy).get_value(), (ux % uy).get_value()]
    values += [(U(ctx, value=100) // U(ctx, value=7)).get_value(),
               (U(ctx, value=100) % U(ctx, value=7)).get_value()]
    ctx.create_dummy_gates()
    return ctx, values


def uint32_bitwise(ns):
    """test_stdlib.py::TestUint32::test_bitwise_and_shifts_vs_native and
    test_comparisons."""
    U, w = ns.stdlib.Uint32, ns.stdlib.witness_t
    ctx = ns.composer.StandardComposer()
    a, b = 0xCAFEF00D, 0x31415926
    ua, ub = U.from_witness(w(ctx, a)), U.from_witness(w(ctx, b))
    values = [(ua & ub).get_value(), (ua | ub).get_value(), (ua ^ ub).get_value(), (~ua).get_value()]
    for s in (1, 3, 13, 31):
        values += [(ua >> s).get_value(), (ua << s).get_value(), ua.ror(s).get_value(), ua.rol(s).get_value()]
    uc, ud = U.from_witness(w(ctx, 100)), U.from_witness(w(ctx, 200))
    values += [(uc < ud).get_value(), (ud < uc).get_value(), (ud > uc).get_value(), (uc <= ud).get_value(),
               (uc >= ud).get_value(), uc.eq(U(ctx, value=100)).get_value(), uc.ne(ud).get_value()]
    ctx.create_dummy_gates()
    return ctx, values


def uint32_lazy_carry(ns):
    """test_stdlib.py::TestUint32::test_lazy_carry_chain."""
    U, w = ns.stdlib.Uint32, ns.stdlib.witness_t
    ctx = ns.composer.StandardComposer()
    total = U(ctx, value=0)
    for i in range(50):
        total = total + U.from_witness(w(ctx, 0xFFFFFFFF - i * 7))
    values = [total.get_value(), total.normalize().get_value()]
    ctx.create_dummy_gates()
    return ctx, values


def uint32_small(ns):
    """test_stdlib.py::TestUint32::test_prove_and_verify_small_uint32_circuit."""
    U, w = ns.stdlib.Uint32, ns.stdlib.witness_t
    ctx = ns.composer.StandardComposer()
    ua = U.from_witness(w(ctx, 0xAABBCCDD))
    ub = U.from_witness(w(ctx, 0x11223344))
    out = (ua + ub).normalize()
    ctx.create_dummy_gates()
    return ctx, [out.get_value()]


def sha256(ns, msg: bytes):
    """test_stdlib.py::TestSha256::test_nist_vectors."""
    ctx = ns.composer.StandardComposer()
    out = ns.stdlib.sha256(ns.stdlib.BitArray.from_string(ctx, msg))
    return ctx, [out.to_bytes()]


def mimc7_standard(ns):
    """test_stdlib.py::TestMiMC::test_mimc7_standard_composer_matches_host."""
    s = ns.stdlib
    ctx = ns.composer.StandardComposer()
    out = s.mimc7([s.field_t.from_witness(s.witness_t(ctx, v)) for v in (1, 2, 3)])
    return ctx, [out.get_value()]


def mimc7_native(ns):
    """test_stdlib.py::TestMiMC::test_mimc7_composers_agree (MiMC side)."""
    s = ns.stdlib
    ctx = ns.composer.MiMCComposer()
    out = s.mimc7([s.field_t.from_witness(s.witness_t(ctx, v)) for v in (77, 88)])
    return ctx, [out.get_value()]


def mimc_cipher(ns):
    """test_stdlib.py::TestMiMC::test_mimc_composer_prove_and_verify_cipher."""
    s = ns.stdlib
    ctx = ns.composer.MiMCComposer()
    m = s.field_t.from_witness(s.witness_t(ctx, 12345))
    k = s.field_t.from_witness(s.witness_t(ctx, 678))
    out = s.mimc_block_cipher(m, k)
    ctx.create_dummy_gates()
    return ctx, [out.get_value()]


COMPOSER_CIRCUITS = {
    "standard": standard,
    "standard_unsatisfied": lambda ns: standard(ns, unsatisfied=True),
    "bool": boolean,
    "bool_tampered": lambda ns: boolean(ns, tamper=True),
    "mimc": mimc,
    "mimc_tampered": lambda ns: mimc(ns, tamper=True),
    "extended_chain": extended_chain,
    "extended_basic_add": extended_basic_add,
    "extended_basic_mul_add": extended_basic_mul_add,
    "extended_anchoring": extended_anchoring,
    "extended_bad_witness": extended_bad_witness,
    "extended_mixed": extended_mixed,
}

STDLIB_CIRCUITS = {
    "field_add_mul_div": field_add_mul_div,
    "bool_truth_tables": bool_truth_tables,
    "uint32_arithmetic": uint32_arithmetic,
    "uint32_bitwise": uint32_bitwise,
    "uint32_lazy_carry": uint32_lazy_carry,
    "uint32_small": uint32_small,
    **{f"sha256_{k}": (lambda ns, m=m: sha256(ns, m)) for k, m in NIST_VECTORS.items()},
    "mimc7_standard": mimc7_standard,
    "mimc7_native": mimc7_native,
    "mimc_cipher": mimc_cipher,
}
