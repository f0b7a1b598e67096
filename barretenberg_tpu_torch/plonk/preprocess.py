"""Verifier-key generation (reference: waffle/proof_system/preprocess.hpp).

Builds the sigma permutation commitments and the widgets' preprocessed
selector commitments from a Prover instance.
"""

from __future__ import annotations

from ..polynomials import fft
from .permutation import compute_permutation_lagrange_base
from .verifier import Verifier


def preprocess(prover) -> Verifier:
    small = prover.state.small_domain
    verifier = Verifier(
        prover.n,
        prover.reference_string.g2_x,
        g2_lines=prover.reference_string.g2_miller_lines,
    )
    sigma_polys = [
        fft.ifft(compute_permutation_lagrange_base(mapping, small), small)
        for mapping in (
            prover.sigma_1_mapping,
            prover.sigma_2_mapping,
            prover.sigma_3_mapping,
        )
    ]
    # one 3-way batched MSM (preprocess.hpp:16-57 batches exactly these)
    (
        verifier.sigma_1_commitment,
        verifier.sigma_2_commitment,
        verifier.sigma_3_commitment,
    ) = prover.commit_batch(sigma_polys)
    for w in prover.widgets:
        verifier.verifier_widgets.append(w.compute_preprocessed_commitments(prover))
    return verifier
