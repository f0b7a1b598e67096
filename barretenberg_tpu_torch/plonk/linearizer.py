"""Maller linearization scalars, shared by prover and verifier.

Reference: waffle/proof_system/linearizer.hpp:29-85. Pure host integer math
(a handful of field ops on challenge/eval scalars).
"""

from __future__ import annotations

from typing import NamedTuple

from ..fields.params import FR_MODULUS, FR_PARAMS

P = FR_MODULUS


class LinearTerms(NamedTuple):
    z_1: int
    sigma_3: int


def compute_linear_terms(proof, challenges, l_1: int) -> LinearTerms:
    """challenges: object with .alpha/.beta/.gamma/.z ints; proof evals are
    plain ints. Returns the scalars multiplying [Z] and [SIGMA_3] in the
    linearization polynomial r(X)."""
    alpha, beta, gamma, z = (
        challenges.alpha % P,
        challenges.beta % P,
        challenges.gamma % P,
        challenges.z % P,
    )
    k1 = FR_PARAMS.multiplicative_generator
    k2 = FR_PARAMS.alternate_multiplicative_generator

    zb = z * beta % P
    t0 = (zb + proof.w_l_eval + gamma) % P
    t1 = (zb * k1 + proof.w_r_eval + gamma) % P
    t2 = (zb * k2 + proof.w_o_eval + gamma) % P
    z_1 = t0 * t1 % P * t2 % P * alpha % P

    s0 = (proof.sigma_1_eval * beta + proof.w_l_eval + gamma) % P
    s1 = (proof.sigma_2_eval * beta + proof.w_r_eval + gamma) % P
    sigma_3 = s0 * s1 % P * proof.z_1_shifted_eval % P * alpha % P
    sigma_3 = (-sigma_3) % P * beta % P

    alpha_cubed = pow(alpha, 3, P)
    z_1 = (z_1 + l_1 * alpha_cubed) % P
    return LinearTerms(z_1=z_1, sigma_3=sigma_3)
