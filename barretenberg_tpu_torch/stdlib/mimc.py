"""In-circuit MiMC7 (reference: waffle/stdlib/mimc.tcc).

MiMC block cipher with the x^7 permutation, 91 rounds, composed into a hash
via Miyaguchi-Preneel. Round constants are the reference's iterated
keccak256 chain seeded with 32 zero bytes (mimc.tcc:34-53 - note the
reference's atoi("m") evaluates to 0, so the seed is all zeros), each digest
interpreted as a little-endian integer mod r.

Two implementations, matching mimc.tcc:56-124:
  * mimc_block_cipher(message, key) on a MiMCComposer -> one native mimc
    gate per round;
  * the same on a StandardComposer -> 4 poly gates per round
    (x^2, x^4, x^6, x^7).
"""

from __future__ import annotations

from ..composer.mimc import MiMCComposer, MiMCQuadruplet
from ..fields.params import FR_MODULUS
from ..transcript.keccak import keccak256
from .types import field_t, witness_t

P = FR_MODULUS
NUM_ROUNDS = 91


def _derive_round_constants() -> list[int]:
    inputs = bytes(32)
    out = []
    for _ in range(NUM_ROUNDS):
        digest = keccak256(inputs)
        out.append(int.from_bytes(digest, "little") % P)
        inputs = digest
    return out


ROUND_CONSTANTS = _derive_round_constants()


def mimc_block_cipher(message: field_t, key: field_t) -> field_t:
    """Dispatch on composer type (mimc.tcc:56-124)."""
    ctx = message.context or key.context
    if isinstance(ctx, MiMCComposer):
        return _mimc_native(message, key, ctx)
    return _mimc_standard(message, key)


def _mimc_native(message: field_t, key: field_t, ctx) -> field_t:
    message = message.normalize()
    key = key.normalize()
    assert message.witness_index >= 0 and key.witness_index >= 0
    x_in = message.get_value()
    k = key.get_value()
    k_idx = key.witness_index
    x_in_idx = message.witness_index
    x_out_idx = x_in_idx
    for c in ROUND_CONSTANTS:
        t = (x_in + k + c) % P
        x_cubed = pow(t, 3, P)
        x_out = x_cubed * x_cubed % P * t % P
        x_cubed_idx = ctx.add_variable(x_cubed)
        x_out_idx = ctx.add_variable(x_out)
        ctx.create_mimc_gate(
            MiMCQuadruplet(
                x_in_idx=x_in_idx,
                k_idx=k_idx,
                x_cubed_idx=x_cubed_idx,
                x_out_idx=x_out_idx,
                mimc_constant=c,
            )
        )
        x_in_idx = x_out_idx
        x_in = x_out
    return field_t(ctx, witness_index=x_out_idx)


def _mimc_standard(message: field_t, key: field_t) -> field_t:
    ctx = message.context or key.context
    x_in = message
    x_out = None
    for c in ROUND_CONSTANTS:
        x_out = x_in + key + field_t(ctx, value=c)
        x_squared = x_out * x_out
        x_pow_four = x_squared * x_squared
        x_out = x_pow_four * x_squared * x_out
        x_in = x_out
    return x_out


def mimc7(inputs: list[field_t]) -> field_t:
    """Miyaguchi-Preneel chaining (mimc.tcc:126-143)."""
    if not inputs:
        return field_t(None, value=0)
    ctx = inputs[0].context
    key = field_t.from_witness(witness_t(ctx, 0))
    for message in inputs:
        x_out = mimc_block_cipher(message, key)
        key = key + x_out + message
    return key


def mimc7_host(values: list[int]) -> int:
    """Host oracle of mimc7 for tests."""
    key = 0
    for m in values:
        x = m % P
        for c in ROUND_CONSTANTS:
            t = (x + key + c) % P
            x = pow(t, 7, P)
        key = (key + x + m) % P
    return key
