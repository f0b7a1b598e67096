"""PLONK Fiat-Shamir challenge derivation (reference:
waffle/proof_system/challenge.hpp).

The reference hashes the *plain-form* (from-Montgomery) limbs of accumulated
proof elements; our Proof object stores plain host integers, so buffers are
built directly from them. The buffer orderings below replicate
challenge.hpp:15-59 exactly; each challenge value is keccak256(digest) mod r
(the reference's copy-then-__to_montgomery_form, challenge.hpp:67-68).
"""

from __future__ import annotations

from ..fields.params import FR_MODULUS
from .keccak import hash_field_elements

R = FR_MODULUS


def _wire_commitments(proof) -> list[int]:
    # challenge.hpp:15-23
    return [
        proof.w_l_commitment[0], proof.w_l_commitment[1],
        proof.w_r_commitment[0], proof.w_r_commitment[1],
        proof.w_o_commitment[0], proof.w_o_commitment[1],
    ]


def _grand_product_commitments(proof) -> list[int]:
    # challenge.hpp:25-29
    return [proof.z_commitment[0], proof.z_commitment[1]]


def _quotient_commitments(proof) -> list[int]:
    # challenge.hpp:31-39
    return [
        proof.t_lo_commitment[0], proof.t_lo_commitment[1],
        proof.t_mid_commitment[0], proof.t_mid_commitment[1],
        proof.t_hi_commitment[0], proof.t_hi_commitment[1],
    ]


def _polynomial_evaluations(proof, t_eval: int) -> list[int]:
    # challenge.hpp:41-51
    return [
        proof.w_l_eval, proof.w_r_eval, proof.w_o_eval,
        proof.sigma_1_eval, proof.sigma_2_eval,
        proof.z_1_shifted_eval, proof.linear_eval, t_eval,
    ]


def _kate_elements(proof) -> list[int]:
    # challenge.hpp:53-59
    return [
        proof.pi_z_commitment[0], proof.pi_z_commitment[1],
        proof.pi_z_omega_commitment[0], proof.pi_z_omega_commitment[1],
    ]


def compute_gamma(proof) -> int:
    """challenge.hpp:61-70."""
    return hash_field_elements(_wire_commitments(proof)) % R


def compute_beta(proof, gamma: int) -> int:
    """challenge.hpp:72-82 (the prover passes gamma as the extra element,
    prover.cpp:85)."""
    return hash_field_elements(_wire_commitments(proof) + [gamma % R]) % R


def compute_alpha(proof) -> int:
    """challenge.hpp:84-94."""
    return hash_field_elements(
        _wire_commitments(proof) + _grand_product_commitments(proof)
    ) % R


def compute_evaluation_challenge(proof) -> int:
    """challenge.hpp:96-107 (the z point)."""
    return hash_field_elements(
        _wire_commitments(proof)
        + _grand_product_commitments(proof)
        + _quotient_commitments(proof)
    ) % R


def compute_linearisation_challenge(proof, t_eval: int) -> int:
    """challenge.hpp:109-121 (nu)."""
    return hash_field_elements(
        _wire_commitments(proof)
        + _grand_product_commitments(proof)
        + _quotient_commitments(proof)
        + _polynomial_evaluations(proof, t_eval)
    ) % R


def compute_kate_separation_challenge(proof, t_eval: int) -> int:
    """challenge.hpp:123-136 (u)."""
    return hash_field_elements(
        _wire_commitments(proof)
        + _grand_product_commitments(proof)
        + _quotient_commitments(proof)
        + _polynomial_evaluations(proof, t_eval)
        + _kate_elements(proof)
    ) % R
