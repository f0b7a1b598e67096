"""PLONK proof container (reference: waffle/waffle_types.hpp:18-45).

All values are plain host integers (field *values*, affine coordinates) -
the canonical serialization domain. Device arrays never leak into the proof:
commitments are decoded after batch-normalize, evaluations after fr.decode.
"""

from __future__ import annotations

import dataclasses


Point = tuple  # (x, y) ints; the points in a proof are never infinity


@dataclasses.dataclass
class Proof:
    # Kate commitments (round order of prover.cpp)
    w_l_commitment: Point = (0, 0)
    w_r_commitment: Point = (0, 0)
    w_o_commitment: Point = (0, 0)
    z_commitment: Point = (0, 0)
    t_lo_commitment: Point = (0, 0)
    t_mid_commitment: Point = (0, 0)
    t_hi_commitment: Point = (0, 0)
    pi_z_commitment: Point = (0, 0)
    pi_z_omega_commitment: Point = (0, 0)

    # Evaluations at the challenge point z
    w_l_eval: int = 0
    w_r_eval: int = 0
    w_o_eval: int = 0
    sigma_1_eval: int = 0
    sigma_2_eval: int = 0
    z_1_shifted_eval: int = 0
    linear_eval: int = 0

    # Shifted-wire evaluations (only present when a widget needs them,
    # waffle_types.hpp:39-43)
    w_l_shifted_eval: int = 0
    w_r_shifted_eval: int = 0
    w_o_shifted_eval: int = 0
    q_c_eval: int = 0
    q_mimc_coefficient_eval: int = 0
    custom_gate_evaluations: list = dataclasses.field(default_factory=list)

    def serialize(self) -> bytes:
        """Canonical byte serialization: every element as 32 bytes
        (4 x u64, LSW first, each word big-endian - the transcript layout
        of keccak.c:112-135)."""
        vals: list[int] = []
        for pt in (
            self.w_l_commitment, self.w_r_commitment, self.w_o_commitment,
            self.z_commitment, self.t_lo_commitment, self.t_mid_commitment,
            self.t_hi_commitment, self.pi_z_commitment,
            self.pi_z_omega_commitment,
        ):
            vals.extend(pt)
        vals.extend([
            self.w_l_eval, self.w_r_eval, self.w_o_eval,
            self.sigma_1_eval, self.sigma_2_eval,
            self.z_1_shifted_eval, self.linear_eval,
        ])
        out = bytearray()
        for v in vals:
            for j in range(4):
                out += ((v >> (64 * j)) & ((1 << 64) - 1)).to_bytes(8, "big")
        return bytes(out)


class Challenges:
    """Fiat-Shamir challenges of one proof, as host ints."""

    beta = 0
    gamma = 0
    alpha = 0
    z = 0
    nu = 0
