"""Fixture circuits: the reference's benchmark circuits, built with the
composers and stdlib gadgets, and the cross-implementation fixture.

Bench circuits (`bench.py`'s sha256 / mimc / extended / bool circuits,
after the reference's bench_sha256.cpp, bench_mimc.cpp and composer
tests): ``bench_circuit(name)`` returns the composer after
``create_dummy_gates``. Each circuit function takes the composer and stdlib
modules to build with, so the same code builds the circuit with another
package of the same interface.

The cross-implementation fixture is the deterministic splitmix64 circuit
that the reference C++ prover and the JAX package both prove to the same
bytes (`CROSSCHECK.json`: ``arithmetic_n16``, ``bool_n256`` and, at the
reference's own size, ``arithmetic_2e20``).

The circuit fills the first half of n rows with pairs of gates, a
satisfied mul+add gate (w_o = w_l.w_r + w_l + w_r + 1) and a random gate
whose constant cancels its wires, copies the first half onto the second
half through the sigma mappings, and zeroes the last row of each half. With
``with_bool`` a Bool widget takes selectors on every 3rd / 5th / 7th row
(the rows where the circuit's wires are not boolean make the proof fail to
verify, but its bytes are still pinned). Prove it against ``test_srs(256)``
(``test_srs(2^20)`` at 2^20; secret 0xA11CE); the prover takes the SRS's
first n points.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import composer as _composer, stdlib as _stdlib
from .fields.params import FR_MODULUS
from .plonk.prover import Prover
from .plonk.widgets import ProverArithmeticWidget, ProverBoolWidget

P = FR_MODULUS
SEED = 0x5EED5EED5EED5EED

# proof_sha256 of CROSSCHECK.json's cases (the reference C++ prover's bytes)
CROSSCHECK_SHA256 = {
    (16, False): "c5bce03f8484fb8d59c6101ec7965218bddc3457e357c5c4080691abe60904c5",
    (256, True): "6c5c6116078a6bf80e9e4014cb019b1ba735f708bba5c7acbb878271285ff0b0",
}
# arithmetic_2e20: the same fixture at the reference's own size, 2^20 gates,
# proved against test_srs(2^20); a card proves it (chip_smoke.py phase
# "large"), a CPU test cannot in its time
CROSSCHECK_2E20_SHA256 = "113fe0aad8656e04869b3bb89988ae70449ad7d055fbecd05b8de71a5eedab45"


def _sha256_abc(composer, stdlib):
    """SHA-256 of "abc" through the gadget (bench_sha256.cpp:23-120):
    65,167 gates, n = 2^16."""
    ctx = composer.StandardComposer()
    out = stdlib.sha256(stdlib.BitArray.from_string(ctx, b"abc"))
    ctx.create_dummy_gates()
    if out.to_bytes() != hashlib.sha256(b"abc").digest():
        raise AssertionError("the SHA-256 gadget disagrees with hashlib")
    return ctx


def _mimc_blocks(composer, stdlib, blocks: int = 32):
    """`blocks` chained MiMC block ciphers on the MiMC composer's native
    round gates (bench_mimc.cpp:18-93): 2,917 gates at 32, n = 2^12."""
    ctx = composer.MiMCComposer()
    x = stdlib.field_t.from_witness(stdlib.witness_t(ctx, 0x1234))
    k = stdlib.field_t.from_witness(stdlib.witness_t(ctx, 0x5678))
    out = stdlib.mimc_block_cipher(x, k)
    for _ in range(blocks - 1):
        out = stdlib.mimc_block_cipher(out, k)
    ctx.create_dummy_gates()
    return ctx


def _extended_chain(composer, stdlib, length: int = 5000):
    """An addition chain of `length` witnesses on the ExtendedComposer, whose
    gate merging reads w_o(X.omega) through q_oo: 5,004 gates at 5,000,
    2,504 after merging (2,500 gates deleted), n = 2^12."""
    ctx = composer.ExtendedComposer()
    acc = stdlib.field_t.from_witness(stdlib.witness_t(ctx, 1))
    total = 1
    for i in range(length):
        v = i + 2
        acc = acc + stdlib.field_t.from_witness(stdlib.witness_t(ctx, v))
        total += v
    acc.assert_equal(stdlib.field_t(ctx, value=total))
    ctx.create_dummy_gates()
    return ctx


def _bool_pairs(composer, stdlib, pairs: int = 1100):
    """`pairs` x (two bool-marked wires, a mul gate and an add gate) on the
    BoolComposer: 2,203 gates at 1,100, n = 2^12."""
    ctx = composer.BoolComposer()
    for i in range(pairs):
        a, b = (i >> 1) & 1, i & 1
        a_idx = ctx.add_variable(a)
        b_idx = ctx.add_variable(b)
        c_idx = ctx.add_variable(a * b)
        d_idx = ctx.add_variable(a + b)
        ctx.create_bool_gate(a_idx)
        ctx.create_bool_gate(b_idx)
        ctx.create_mul_gate(composer.MulTriple(a_idx, b_idx, c_idx, 1, P - 1, 0))
        ctx.create_add_gate(composer.AddTriple(a_idx, b_idx, d_idx, 1, 1, P - 1, 0))
    ctx.create_dummy_gates()
    return ctx


# sha256(proof.serialize()) of each bench circuit proved against
# test_srs(n) (secret 0xA11CE): the JAX prover's bytes, computed on the CPU
# by tests/test_torch_circuit_digests.py (marked slow). The SHA-256
# circuit's digest at n = 2^16 is not pinned yet.
BENCH_DIGESTS = {
    "bool": "2a253d9c934b77705dd512bf8596f0eff6f517ca98b03ba9826c383474d82f69",
    "mimc": "51685a1f3ae74140323e3b45288de3d974a5d970dce691ee9732d69e350b0492",
    "extended": "c626a9b8786f310bfb8e40374136507439e879dcf2e82ec7a37b9f727597470f",
}

BENCH_CIRCUITS = {
    "sha256": _sha256_abc,
    "mimc": _mimc_blocks,
    "extended": _extended_chain,
    "bool": _bool_pairs,
}


def bench_circuit(name: str, composer=None, stdlib=None, **size):
    """The bench circuit `name` after create_dummy_gates, built with the
    given composer and stdlib modules (default: this package's). `size`
    overrides the circuit function's size argument (blocks, length, pairs)."""
    return BENCH_CIRCUITS[name](composer or _composer, stdlib or _stdlib, **size)


SPLITMIX_GAMMA = 0x9E3779B97F4A7C15


def _splitmix_words(count: int) -> np.ndarray:
    """The first ``count`` outputs of splitmix64 seeded with SEED, as uint64:
    output k mixes the state SEED + (k + 1) * gamma mod 2^64, so the whole
    stream is computed at once (numpy's uint64 products wrap mod 2^64)."""
    z = np.uint64(SEED) + np.arange(1, count + 1, dtype=np.uint64) * np.uint64(SPLITMIX_GAMMA)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _det_values(count: int) -> list:
    """The fixture's first ``count`` field values: each four splitmix64
    words, least significant first, the top word cut to 61 bits (< 2^253)."""
    words = _splitmix_words(4 * count).reshape(count, 4)
    words[:, 3] &= np.uint64(0x1FFFFFFFFFFFFFFF)
    raw = memoryview(words.astype("<u8").tobytes())
    return [int.from_bytes(raw[32 * k : 32 * k + 32], "little") for k in range(count)]


def crosscheck_prover(srs, n: int = 16, with_bool: bool = False) -> Prover:
    """The fixture circuit's prover on the SRS's device. Row pair i < n / 4
    takes the fixture's values 5i .. 5i + 4: w_l and w_r of the mul+add gate
    2i, then w_l, w_r and w_o of the random gate 2i + 1."""
    half = n // 2
    d = _det_values(5 * (n // 4))
    wl_e, wr_e, wl_o, wr_o, wo_o = (d[j::5] for j in range(5))
    w_l, w_r, w_o = [0] * n, [0] * n, [0] * n
    q_m, q_l, q_r, q_o, q_c = [0] * n, [0] * n, [0] * n, [0] * n, [0] * n
    even, odd = slice(0, half, 2), slice(1, half, 2)
    w_l[even], w_r[even] = wl_e, wr_e
    w_o[even] = [(a * b + a + b + 1) % P for a, b in zip(wl_e, wr_e)]
    for q in (q_l, q_r, q_m, q_c):
        q[even] = [1] * len(wl_e)
    q_o[even] = [P - 1] * len(wl_e)
    w_l[odd], w_r[odd], w_o[odd] = wl_o, wr_o, wo_o
    q_c[odd] = [(-(a + b + c)) % P for a, b, c in zip(wl_o, wr_o, wo_o)]
    for q in (q_l, q_r, q_o):
        q[odd] = [1] * len(wl_o)

    shift = half
    for arr in (w_l, w_r, w_o, q_m, q_l, q_r, q_o, q_c):
        arr[shift:] = arr[:shift]

    rows = np.arange(shift, dtype=np.uint32)
    s1 = np.concatenate([rows + shift, rows])
    for j in (shift - 1, n - 1):
        s1[j] = j
        w_l[j] = w_r[j] = w_o[j] = 0
        q_c[j] = 0
    s2 = s1 + np.uint32(1 << 30)
    s3 = s1 + np.uint32(1 << 31)
    q_l[n - 1] = q_r[n - 1] = q_o[n - 1] = q_m[n - 1] = 0

    prover = Prover(n, srs)
    fr = prover.fr
    prover.w_l = fr.encode(w_l)
    prover.w_r = fr.encode(w_r)
    prover.w_o = fr.encode(w_o)
    prover.sigma_1_mapping = s1
    prover.sigma_2_mapping = s2
    prover.sigma_3_mapping = s3
    prover.widgets.append(
        ProverArithmeticWidget(*(fr.encode(q) for q in (q_m, q_l, q_r, q_o, q_c)))
    )
    if with_bool:
        q_bl = [1 if i % 3 == 0 else 0 for i in range(n)]
        q_br = [1 if i % 5 == 0 else 0 for i in range(n)]
        q_bo = [1 if i % 7 == 0 else 0 for i in range(n)]
        prover.widgets.append(ProverBoolWidget(*(fr.encode(q) for q in (q_bl, q_br, q_bo))))
    return prover
