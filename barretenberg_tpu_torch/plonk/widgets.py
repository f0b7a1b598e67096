"""PLONK selector widgets: the arithmetic, bool, sequential and MiMC gates.

Reference: waffle/proof_system/widgets/. A prover widget contributes its gate
constraint to the quotient polynomial (in coset-evaluation form), its
linearization terms to r(X), and its preprocessed selector commitments; the
matching verifier widget reconstructs the same contributions from scalars.

Each prover widget folds r(X) into its linear terms as one K1 ``lincomb``
launch, commits its selectors as one batched commitment call, and hands the
prover the polynomials it must evaluate at z (``proof_evaluations``, one row
each of the prover's batch of evaluations) and its terms of the opening
polynomial (``opening_terms``, terms of the opening's one combination).

Device layout: selector polynomials are (18, n) limb tensors; evaluation form
on construction, converted to coefficient form during quotient computation.
"""

from __future__ import annotations

import torch

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


def _preprocessed(prover, selectors) -> list:
    """Commitments to evaluation-form selectors: one iFFT each, one batched
    commitment call for all of them."""
    small = prover.state.small_domain
    return prover.commit_batch([fft.ifft(q, small) for q in selectors])


def _on_curve_or_zero(pt) -> bool:
    return pt == (0, 0) or host_curve.g1_is_on_curve(pt)


def _append_term(points: list, scalars: list, pt, scalar: int) -> None:
    """A verifier MSM term, skipped for a (0, 0) commitment (a selector that
    is identically zero) or one off the curve."""
    if pt != (0, 0) and host_curve.g1_is_on_curve(pt):
        points.append(pt)
        scalars.append(scalar)


class _ProverWidget:
    """Defaults: no shifted wire read, no evaluation of its own in the
    proof, no term of the opening polynomial."""

    dependencies = frozenset()

    def proof_evaluations(self) -> list:
        return []

    def opening_terms(self, nu_base: int, nu: int):
        return [], nu_base


class ProverArithmeticWidget(_ProverWidget):
    """Standard PLONK gate: q_m.w_l.w_r + q_l.w_l + q_r.w_r + q_o.w_o + q_c
    (reference: widgets/arithmetic_widget.cpp)."""

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

    def compute_preprocessed_commitments(self, prover) -> "VerifierArithmeticWidget":
        """5 selector commitments (arithmetic_widget.cpp:124-157), as one
        batched MSM."""
        return VerifierArithmeticWidget(_preprocessed(prover, self._selectors()))


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


class ProverBoolWidget(_ProverWidget):
    """Booleanity constraint (w^2 - w).q_b per wire column
    (reference: widgets/bool_widget.cpp:62-100)."""

    def __init__(self, q_bl, q_br, q_bo):
        self.q_bl, self.q_br, self.q_bo = q_bl, q_br, q_bo  # evaluation form
        self._coeff = None

    def compute_quotient_contribution(self, alpha_base: int, alpha: int, state) -> int:
        """Adds sum_j alpha_base.alpha^j.(w_j^2 - w_j).q_bj over the mid (2n)
        coset into state.quotient_mid; the scales ride the coset FFTs."""
        small, mid = state.small_domain, state.mid_domain
        fr = small.fr
        coeffs = [fft.ifft(q, small) for q in (self.q_bl, self.q_br, self.q_bo)]
        self._coeff = coeffs
        scales = [alpha_base, alpha_base * alpha % P, alpha_base * alpha * alpha % P]
        ffts = [
            fft.coset_fft_with_constant(state.pad(c, mid.size), mid, s)
            for c, s in zip(coeffs, scales)
        ]
        t = None
        for wire_fft, q_fft in zip((state.w_l_fft, state.w_r_fft, state.w_o_fft), ffts):
            w2 = wire_fft[:, ::2]
            term = fr.mont_mul(fr.sub(fr.mont_mul(w2, w2), w2), q_fft)
            t = term if t is None else fr.add(t, term)
        state.quotient_mid = fr.add(state.quotient_mid, t)
        return alpha_base * pow(alpha, 3, P) % P

    def compute_linear_contribution(self, alpha_base: int, alpha: int, proof, r, fr):
        """r + sum_j (e_j^2 - e_j).alpha_base.alpha^j.q_bj as one combination
        (bool_widget.cpp:105-124)."""
        terms = [(r, 1)]
        for q, ev, k in zip(
            self._coeff,
            (proof.w_l_eval, proof.w_r_eval, proof.w_o_eval),
            (alpha_base, alpha_base * alpha % P, alpha_base * alpha * alpha % P),
        ):
            terms.append((q, (ev * ev - ev) % P * k % P))
        return alpha_base * pow(alpha, 3, P) % P, linear_combo(fr, terms)

    def compute_preprocessed_commitments(self, prover) -> "VerifierBoolWidget":
        return VerifierBoolWidget(_preprocessed(prover, (self.q_bl, self.q_br, self.q_bo)))


class VerifierBoolWidget:
    dependencies = frozenset()

    def __init__(self, commitments):
        self.commitments = commitments  # [Q_BL, Q_BR, Q_BO]

    def verify_instance_commitments(self) -> bool:
        return all(_on_curve_or_zero(c) for c in self.commitments)

    def compute_batch_evaluation_contribution(self, batch_eval, nu_base, nu, proof):
        return batch_eval, nu_base

    def append_scalar_multiplication_inputs(self, coeffs, proof, points, scalars):
        """(bool_widget.cpp:194-230)."""
        ab, a_step, ln = coeffs["alpha_base"], coeffs["alpha_step"], coeffs["linear_nu"]
        muls = [
            (ev * ev - ev) % P * ab % P * pow(a_step, j, P) % P * ln % P
            for j, ev in enumerate((proof.w_l_eval, proof.w_r_eval, proof.w_o_eval))
        ]
        for pt, sc in zip(self.commitments, muls):
            _append_term(points, scalars, pt, sc)
        out = dict(coeffs)
        out["alpha_base"] = ab * pow(a_step, 3, P) % P
        return out


class ProverSequentialWidget(_ProverWidget):
    """q_oo selector multiplying the next gate's output w_o(X.omega)
    (reference: widgets/sequential_widget.cpp:47-74). Shares the arithmetic
    widget's alpha power (old_alpha = alpha_base / alpha), so it comes
    directly after it and leaves alpha_base as it is."""

    dependencies = frozenset((REQUIRES_W_O_SHIFTED,))

    def __init__(self, q_o_next):
        self.q_o_next = q_o_next  # evaluation form
        self._coeff = None

    def compute_quotient_contribution(self, alpha_base: int, alpha: int, state) -> int:
        small, mid = state.small_domain, state.mid_domain
        fr = small.fr
        old_alpha = alpha_base * pow(alpha, -1, P) % P
        self._coeff = fft.ifft(self.q_o_next, small)
        q_fft = fft.coset_fft_with_constant(state.pad(self._coeff, mid.size), mid, old_alpha)
        # w_o(X.omega) on the 2n coset: a shift LEFT by 4 on the 4n coset
        w_o_shifted = torch.roll(state.w_o_fft, -4, dims=1)[:, ::2]
        state.quotient_mid = fr.add(state.quotient_mid, fr.mont_mul(w_o_shifted, q_fft))
        return alpha_base

    def compute_linear_contribution(self, alpha_base: int, alpha: int, proof, r, fr):
        old_alpha = alpha_base * pow(alpha, -1, P) % P
        r = linear_combo(fr, [(r, 1), (self._coeff, proof.w_o_shifted_eval * old_alpha % P)])
        return alpha_base, r

    def compute_preprocessed_commitments(self, prover) -> "VerifierSequentialWidget":
        return VerifierSequentialWidget(_preprocessed(prover, (self.q_o_next,)))


class VerifierSequentialWidget:
    dependencies = frozenset((REQUIRES_W_O_SHIFTED,))

    def __init__(self, commitments):
        self.commitments = commitments  # [Q_O_NEXT]

    def verify_instance_commitments(self) -> bool:
        return _on_curve_or_zero(self.commitments[0])

    def compute_batch_evaluation_contribution(self, batch_eval, nu_base, nu, proof):
        return batch_eval, nu_base

    def append_scalar_multiplication_inputs(self, coeffs, proof, points, scalars):
        """(sequential_widget.cpp:122-147)."""
        old_alpha = coeffs["alpha_base"] * pow(coeffs["alpha_step"], -1, P) % P
        sc = proof.w_o_shifted_eval * old_alpha % P * coeffs["linear_nu"] % P
        _append_term(points, scalars, self.commitments[0], sc)
        return dict(coeffs)


def _mimc_term(proof, alpha: int) -> int:
    """((t0^3 - w_r) + alpha.(t0.w_r^2 - w_o(z.omega))) at z, with
    t0 = w_o + w_l + q_mimc_c (mimc_widget.cpp:96-113)."""
    t0 = (proof.w_o_eval + proof.w_l_eval + proof.q_mimc_coefficient_eval) % P
    a = (t0 * t0 % P * t0 - proof.w_r_eval) % P
    term = (proof.w_r_eval * proof.w_r_eval % P * t0 - proof.w_o_shifted_eval) % P * alpha % P
    return (term + a) % P


class ProverMiMCWidget(_ProverWidget):
    """MiMC round gate over the 4n domain with shifted w_o
    (reference: widgets/mimc_widget.cpp:58-93):
    q_mimc.(((w_o+w_l+q_mimc_c)^3 - w_r) + alpha.((w_o+w_l+q_mimc_c).w_r^2 - w_o_next))
    """

    dependencies = frozenset((REQUIRES_W_O_SHIFTED,))

    def __init__(self, q_mimc_selector, q_mimc_coefficient):
        self.q_mimc_selector = q_mimc_selector  # evaluation form
        self.q_mimc_coefficient = q_mimc_coefficient
        self._sel_coeff = None
        self._coef_coeff = None

    def compute_quotient_contribution(self, alpha_base: int, alpha: int, state) -> int:
        """Adds the round constraint over the large (4n) coset into
        state.quotient_large (degree 4 in the wires)."""
        small, large = state.small_domain, state.large_domain
        fr = small.fr
        mul, add, sub = fr.mont_mul, fr.add, fr.sub
        self._sel_coeff = fft.ifft(self.q_mimc_selector, small)
        self._coef_coeff = fft.ifft(self.q_mimc_coefficient, small)
        sel_fft = fft.coset_fft_with_constant(state.pad(self._sel_coeff, large.size), large, alpha_base)
        coef_fft = fft.coset_fft(state.pad(self._coef_coeff, large.size), large)
        w_o_next = torch.roll(state.w_o_fft, -4, dims=1)
        t0 = add(add(state.w_o_fft, state.w_l_fft), coef_fft)
        t1 = sub(mul(mul(t0, t0), t0), state.w_r_fft)
        t2 = sub(mul(mul(state.w_r_fft, state.w_r_fft), t0), w_o_next)
        t1 = add(t1, fr.mul_by_constant(t2, alpha))
        state.quotient_large = add(state.quotient_large, mul(t1, sel_fft))
        return alpha_base * alpha % P * alpha % P

    def proof_evaluations(self) -> list:
        """q_mimc_coefficient(z) goes into the proof (mimc_widget.cpp:87-93)."""
        return [("q_mimc_coefficient_eval", self._coef_coeff)]

    def compute_linear_contribution(self, alpha_base: int, alpha: int, proof, r, fr):
        r = linear_combo(fr, [(r, 1), (self._sel_coeff, _mimc_term(proof, alpha) * alpha_base % P)])
        return alpha_base * alpha % P * alpha % P, r

    def opening_terms(self, nu_base: int, nu: int):
        """q_mimc_coefficient . nu_base in the opening polynomial
        (mimc_widget.cpp:115-124)."""
        return [(self._coef_coeff, nu_base)], nu_base * nu % P

    def compute_preprocessed_commitments(self, prover) -> "VerifierMiMCWidget":
        return VerifierMiMCWidget(
            _preprocessed(prover, (self.q_mimc_coefficient, self.q_mimc_selector))
        )


class VerifierMiMCWidget:
    dependencies = frozenset((REQUIRES_W_O_SHIFTED,))

    def __init__(self, commitments):
        self.commitments = commitments  # [Q_MIMC_COEFFICIENT, Q_MIMC_SELECTOR]

    def verify_instance_commitments(self) -> bool:
        return all(_on_curve_or_zero(c) for c in self.commitments)

    def compute_batch_evaluation_contribution(self, batch_eval, nu_base, nu, proof):
        """(mimc_widget.cpp:173-179)."""
        batch_eval = (batch_eval + proof.q_mimc_coefficient_eval * nu_base) % P
        return batch_eval, nu_base * nu % P

    def append_scalar_multiplication_inputs(self, coeffs, proof, points, scalars):
        """(mimc_widget.cpp:181-216)."""
        ab, a_step, ln = coeffs["alpha_base"], coeffs["alpha_step"], coeffs["linear_nu"]
        _append_term(points, scalars, self.commitments[0], coeffs["nu_base"])
        _append_term(points, scalars, self.commitments[1], _mimc_term(proof, a_step) * ab % P * ln % P)
        out = dict(coeffs)
        out["alpha_base"] = ab * a_step % P * a_step % P
        out["nu_base"] = coeffs["nu_base"] * coeffs["nu_step"] % P
        return out
