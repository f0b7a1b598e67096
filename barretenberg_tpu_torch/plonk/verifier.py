"""PLONK verifier (reference: waffle/proof_system/verifier/verifier.cpp).

Verification is scalar-dominated (one ~15-point MSM and 2 pairings), so it
runs on host integers and touches no device; this also gives an
implementation-independent check of the device prover. The challenge reconstruction, batch evaluation, and
pairing equation replicate verifier.cpp:55-380 term for term.
"""

from __future__ import annotations

from ..fields.params import FR_MODULUS
from ..pairing import pairing_check
from ..polynomials import arithmetic
from ..polynomials.domain import get_domain
from ..transcript import challenges as fs
from ..utils import host_curve
from .linearizer import compute_linear_terms
from .proof import Challenges

P = FR_MODULUS


class Verifier:
    def __init__(self, n: int, g2_x, g2_lines=None):
        self.n = n
        self.g2_x = g2_x  # [x]_2 host point
        self.g2_lines = g2_lines  # precomputed Miller lines ([1]_2, [x]_2)
        self.sigma_1_commitment = None
        self.sigma_2_commitment = None
        self.sigma_3_commitment = None
        self.verifier_widgets = []

    def verify_proof(self, proof) -> bool:
        n = self.n
        domain = get_domain(n, "cpu")  # host scalars only; no table is built

        # --- input validity (verifier.cpp:59-102) -------------------------
        for pt in (proof.t_lo_commitment, proof.z_commitment, proof.pi_z_commitment):
            if not host_curve.g1_is_on_curve(pt):
                return False
        for pt in (
            self.sigma_1_commitment,
            self.sigma_2_commitment,
            self.sigma_3_commitment,
        ):
            if not host_curve.g1_is_on_curve(pt):
                return False
        for w in self.verifier_widgets:
            if not w.verify_instance_commitments():
                return False
        if (
            proof.sigma_1_eval % P == 0
            or proof.sigma_2_eval % P == 0
            or proof.linear_eval % P == 0
        ):
            return False

        # --- challenge reconstruction (verifier.cpp:105-111) --------------
        ch = Challenges()
        ch.alpha = fs.compute_alpha(proof)
        ch.gamma = fs.compute_gamma(proof)
        ch.beta = fs.compute_beta(proof, ch.gamma)
        ch.z = fs.compute_evaluation_challenge(proof)

        lag = arithmetic.get_lagrange_evaluations(ch.z, domain)
        linear = compute_linear_terms(proof, ch, lag.l_1)

        # --- reconstruct t_eval (verifier.cpp:120-158) ---------------------
        alpha = ch.alpha
        a2, a3 = pow(alpha, 2, P), pow(alpha, 3, P)
        t0 = (proof.sigma_1_eval * ch.beta + proof.w_l_eval + ch.gamma) % P
        t2 = (proof.sigma_2_eval * ch.beta + proof.w_r_eval + ch.gamma) % P
        t3 = (proof.w_o_eval + ch.gamma) % P
        t0 = t0 * t2 % P * t3 % P * proof.z_1_shifted_eval % P * alpha % P
        t1 = (proof.z_1_shifted_eval - 1) % P * lag.l_n_minus_1 % P * a2 % P
        t2 = lag.l_1 * a3 % P
        t_eval = (t1 - t2 - t0 + proof.linear_eval) % P
        t_eval = t_eval * pow(lag.vanishing_poly, -1, P) % P

        z_pow_n = pow(ch.z, n, P)
        z_pow_2n = pow(ch.z, 2 * n, P)

        ch.nu = fs.compute_linearisation_challenge(proof, t_eval)
        u = fs.compute_kate_separation_challenge(proof, t_eval)
        nu_pow = [pow(ch.nu, k, P) for k in range(1, 11)]

        # --- linear-term scalars x nu (verifier.cpp:175-184) ---------------
        lin_z_1 = linear.z_1 * nu_pow[0] % P
        lin_sigma_3 = linear.sigma_3 * nu_pow[0] % P
        lin_z_1 = (lin_z_1 + nu_pow[6] * u) % P

        # --- batch evaluation (verifier.cpp:186-250) -----------------------
        batch_eval = t_eval
        batch_eval = (batch_eval + nu_pow[0] * proof.linear_eval) % P
        batch_eval = (batch_eval + nu_pow[1] * proof.w_l_eval) % P
        batch_eval = (batch_eval + nu_pow[2] * proof.w_r_eval) % P
        batch_eval = (batch_eval + nu_pow[3] * proof.w_o_eval) % P
        batch_eval = (batch_eval + nu_pow[4] * proof.sigma_1_eval) % P
        batch_eval = (batch_eval + nu_pow[5] * proof.sigma_2_eval) % P
        batch_eval = (batch_eval + nu_pow[6] * u % P * proof.z_1_shifted_eval) % P

        deps = set()
        for w in self.verifier_widgets:
            deps |= w.dependencies
        from .widgets import (
            REQUIRES_W_L_SHIFTED,
            REQUIRES_W_O_SHIFTED,
            REQUIRES_W_R_SHIFTED,
        )

        nu_base = nu_pow[7]
        for flag, ev in (
            (REQUIRES_W_L_SHIFTED, proof.w_l_shifted_eval),
            (REQUIRES_W_R_SHIFTED, proof.w_r_shifted_eval),
            (REQUIRES_W_O_SHIFTED, proof.w_o_shifted_eval),
        ):
            if flag in deps:
                batch_eval = (batch_eval + ev * nu_base % P * u) % P
                nu_base = nu_base * nu_pow[0] % P
        for w in self.verifier_widgets:
            batch_eval, nu_base = w.compute_batch_evaluation_contribution(
                batch_eval, nu_base, nu_pow[0], proof
            )
        batch_eval = (-batch_eval) % P

        z_omega_scalar = ch.z * domain.root % P * u % P

        # --- scalar-multiplication inputs (verifier.cpp:258-355) -----------
        points = [proof.z_commitment]
        scalars = [lin_z_1]

        nu_base = nu_pow[7]
        for pt, base_scalar, flag in (
            (proof.w_l_commitment, nu_pow[1], REQUIRES_W_L_SHIFTED),
            (proof.w_r_commitment, nu_pow[2], REQUIRES_W_R_SHIFTED),
            (proof.w_o_commitment, nu_pow[3], REQUIRES_W_O_SHIFTED),
        ):
            if host_curve.g1_is_on_curve(pt) and pt != (0, 0):
                if flag in deps:
                    points.append(pt)
                    scalars.append((nu_base * u + base_scalar) % P)
                    nu_base = nu_base * nu_pow[0] % P
                else:
                    points.append(pt)
                    scalars.append(base_scalar)

        points.append(self.sigma_1_commitment)
        scalars.append(nu_pow[4])
        points.append(self.sigma_2_commitment)
        scalars.append(nu_pow[5])
        points.append(self.sigma_3_commitment)
        scalars.append(lin_sigma_3)
        points.append(host_curve.G1_GENERATOR)
        scalars.append(batch_eval)
        if host_curve.g1_is_on_curve(proof.pi_z_omega_commitment):
            points.append(proof.pi_z_omega_commitment)
            scalars.append(z_omega_scalar)
        points.append(proof.pi_z_commitment)
        scalars.append(ch.z)
        if host_curve.g1_is_on_curve(proof.t_mid_commitment):
            points.append(proof.t_mid_commitment)
            scalars.append(z_pow_n)
        if host_curve.g1_is_on_curve(proof.t_hi_commitment):
            points.append(proof.t_hi_commitment)
            scalars.append(z_pow_2n)

        coeffs = {
            "alpha_base": pow(ch.alpha, 4, P),
            "alpha_step": ch.alpha,
            "nu_base": nu_base,
            "nu_step": ch.nu,
            "linear_nu": ch.nu,
        }
        for w in self.verifier_widgets:
            coeffs = w.append_scalar_multiplication_inputs(
                coeffs, proof, points, scalars
            )

        # --- final MSM + pairing (verifier.cpp:357-379) ---------------------
        rhs = host_curve.g1_msm(points, scalars)
        rhs = host_curve.g1_add(rhs, proof.t_lo_commitment)

        lhs = host_curve.g1_mul(proof.pi_z_omega_commitment, u)
        lhs = host_curve.g1_add(lhs, proof.pi_z_commitment)
        lhs = host_curve.g1_neg(lhs)

        if self.g2_lines is not None and rhs is not None and lhs is not None:
            # reference pairing.cpp:349-362: reuse the SRS's line tables
            from ..pairing import tower

            res = tower.reduced_ate_pairing_batch_precomputed(
                [rhs, lhs], list(self.g2_lines)
            )
            return tower.fq12_eq_one(res)
        return pairing_check(
            [(rhs, host_curve.G2_GENERATOR), (lhs, self.g2_x)]
        )
