"""PLONK selector widgets: the arithmetic gate.

Reference: waffle/proof_system/widgets/. A prover widget contributes its gate
constraint to the quotient polynomial (in coset-evaluation form), its
linearization terms to r(X), and its preprocessed selector commitments; the
matching verifier widget reconstructs the same contributions from scalars.
Only the arithmetic widget is ported so far.

Device layout: selector polynomials are (18, n) limb tensors; evaluation form
on construction, converted to coefficient form during quotient computation.
"""

from __future__ import annotations

from ..fields.params import FR_MODULUS
from ..polynomials import fft
from ..utils import host_curve

P = FR_MODULUS

# Shifted-wire dependency flags (base_widget.hpp:20-34)
REQUIRES_W_L_SHIFTED = "w_l_shifted"
REQUIRES_W_R_SHIFTED = "w_r_shifted"
REQUIRES_W_O_SHIFTED = "w_o_shifted"


def linear_combo(fr, terms):
    """sum_i poly_i * scalar_i for host-int scalars, device polys of one
    length: one K1 ``lincomb`` launch on the card."""
    polys, scalars = zip(*terms)
    return fr.linear_combination(polys, [s % P for s in scalars])


class ProverArithmeticWidget:
    """Standard PLONK gate: q_m.w_l.w_r + q_l.w_l + q_r.w_r + q_o.w_o + q_c
    (reference: widgets/arithmetic_widget.cpp)."""

    dependencies = frozenset()

    def __init__(self, q_m, q_l, q_r, q_o, q_c):
        # evaluation form (18, n)
        self.q_m, self.q_l, self.q_r, self.q_o, self.q_c = q_m, q_l, q_r, q_o, q_c
        self._coeff = None  # coefficient forms, set during quotient phase

    def _selectors(self):
        return (self.q_m, self.q_l, self.q_r, self.q_o, self.q_c)

    def compute_quotient_contribution(self, alpha_base: int, alpha: int, state) -> int:
        """Adds the gate constraint over the mid (2n) coset domain into
        state.quotient_mid (arithmetic_widget.cpp:66-100)."""
        small, mid = state.small_domain, state.mid_domain
        fr = small.fr
        coeffs = [fft.ifft(q, small) for q in self._selectors()]
        self._coeff = coeffs
        q_m_fft, q_l_fft, q_r_fft, q_o_fft, q_c_fft = (
            fft.coset_fft_with_constant(state.pad(c, mid.size), mid, alpha_base)
            for c in coeffs
        )
        w_l2 = state.w_l_fft[:, ::2]
        w_r2 = state.w_r_fft[:, ::2]
        w_o2 = state.w_o_fft[:, ::2]
        t = fr.mont_mul(fr.mont_mul(w_l2, q_m_fft), w_r2)
        t = fr.add(t, fr.mont_mul(w_l2, q_l_fft))
        t = fr.add(t, fr.mont_mul(w_r2, q_r_fft))
        t = fr.add(t, fr.mont_mul(w_o2, q_o_fft))
        t = fr.add(t, q_c_fft)
        state.quotient_mid = fr.add(state.quotient_mid, t)
        return alpha_base * alpha % P

    def compute_linear_contribution(self, alpha_base: int, alpha: int, proof, r, fr):
        """r += (q_m.wl_eval.wr_eval + q_l.wl + q_r.wr + q_o.wo + q_c).alpha_base
        in coefficient form (arithmetic_widget.cpp:102-122); r is the
        combination's first term."""
        q_m, q_l, q_r, q_o, q_c = self._coeff
        w_lr = proof.w_l_eval * proof.w_r_eval % P
        r = linear_combo(
            fr,
            [
                (r, 1),
                (q_m, w_lr * alpha_base % P),
                (q_l, proof.w_l_eval * alpha_base % P),
                (q_r, proof.w_r_eval * alpha_base % P),
                (q_o, proof.w_o_eval * alpha_base % P),
                (q_c, alpha_base),
            ],
        )
        return alpha_base * alpha % P, r

    def compute_opening_poly_contribution(self, opening_poly, nu_base: int, nu: int):
        return opening_poly, nu_base  # arithmetic widget adds nothing

    def compute_proof_elements(self, proof, z: int) -> None:
        return None

    def compute_preprocessed_commitments(self, prover) -> "VerifierArithmeticWidget":
        """5 selector commitments (arithmetic_widget.cpp:124-157), as one
        batched MSM."""
        small = prover.state.small_domain
        commitments = prover.commit_batch(
            [fft.ifft(q, small) for q in self._selectors()]
        )
        return VerifierArithmeticWidget(commitments)


class VerifierArithmeticWidget:
    dependencies = frozenset()

    def __init__(self, commitments):
        # [Q_M, Q_L, Q_R, Q_O, Q_C] host (x, y) points
        self.commitments = commitments

    def verify_instance_commitments(self) -> bool:
        return all(host_curve.g1_is_on_curve(c) for c in self.commitments)

    def compute_batch_evaluation_contribution(
        self, batch_eval: int, nu_base: int, nu: int, proof
    ):
        return batch_eval, nu_base  # no extra evaluations in the proof

    def append_scalar_multiplication_inputs(
        self, coeffs, proof, points: list, scalars: list
    ):
        """(arithmetic_widget.cpp:186-246). coeffs: dict with alpha_base,
        alpha_step, nu_base, nu_step, linear_nu."""
        ab, ln = coeffs["alpha_base"], coeffs["linear_nu"]
        q_m_term = proof.w_l_eval * proof.w_r_eval % P * ab % P * ln % P
        q_l_term = proof.w_l_eval * ab % P * ln % P
        q_r_term = proof.w_r_eval * ab % P * ln % P
        q_o_term = proof.w_o_eval * ab % P * ln % P
        q_c_term = ab * ln % P
        for pt, sc in zip(
            self.commitments, (q_m_term, q_l_term, q_r_term, q_o_term, q_c_term)
        ):
            if pt is not None and host_curve.g1_is_on_curve(pt):
                points.append(pt)
                scalars.append(sc)
        out = dict(coeffs)
        out["alpha_base"] = ab * coeffs["alpha_step"] % P
        return out
