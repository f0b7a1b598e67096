"""The bench circuits' pinned proof digests (`fixtures.BENCH_DIGESTS`, which
`chip_smoke.py` holds the card's proofs against) recomputed from the JAX
package on the CPU: each circuit built with the JAX composers and stdlib,
proved by the JAX prover against its test_srs(n), its verifier accepting.

Marked slow: each circuit is a cold XLA compile of the JAX prover at a new
size (n = 2^12) plus its precomputed-table MSMs, several minutes a circuit.
Run with ``python -m pytest tests/test_torch_circuit_digests.py -m slow``."""

import hashlib

import pytest

from barretenberg_tpu.plonk import preprocess as j_preprocess

from barretenberg_tpu_torch.fixtures import BENCH_DIGESTS, bench_circuit

from torch_circuits import JAX


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(BENCH_DIGESTS))
def test_bench_digest_is_the_jax_provers(name):
    ctx = bench_circuit(name, JAX.composer, JAX.stdlib)
    prover = ctx.preprocess()
    verifier = j_preprocess(prover)
    proof = prover.construct_proof()
    digest = hashlib.sha256(proof.serialize()).hexdigest()
    print(f"{name}: n={prover.n} digest={digest}")
    assert verifier.verify_proof(proof)
    assert digest == BENCH_DIGESTS[name]
