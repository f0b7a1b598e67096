"""PLONK polynomial operations over Fr (reference:
polynomials/polynomial_arithmetic.{hpp,cpp}).

Everything operates on (18, n) limb tensors (coefficient or evaluation form)
on the domain's device; small scalar results come back as host ints via
fr.decode.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields import fr as _fr
from ..fields.montgomery import Field
from .domain import EvaluationDomain


def powers_table(fr: Field, z_arr: torch.Tensor, n: int) -> torch.Tensor:
    """(18, n) table of z^k from a (18, 1) z tensor (one prefix-product scan)."""
    if n == 1:
        return fr.encode([1])
    zs = torch.cat([fr.encode([1]), z_arr.expand(18, n - 1)], dim=1)
    return fr.prefix_product(zs, dim=1)


def evaluate_with_powers(fr: Field, coeffs: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """P(z) given a z-power table of at least P's length (its first columns
    are read); stays on the device, (18, 1). One K1 ``dot`` launch."""
    return fr.dot([coeffs], zp[:, : coeffs.shape[1]])


def evaluate(coeffs: torch.Tensor, z: int) -> int:
    """P(z) for a host-known z; returns the value as a host int (a
    power-table inner product instead of the reference's Horner loop)."""
    fr = _fr(coeffs.device)
    zp = powers_table(fr, fr.encode([z % fr.p]), coeffs.shape[1])
    return fr.decode(evaluate_with_powers(fr, coeffs, zp))[0]


def _coset_period_values(src_domain: EvaluationDomain, target_domain: EvaluationDomain):
    """x^n - 1 over the target coset takes only target/src distinct values,
    repeating with that period: returns them as host ints."""
    p = src_domain.fr.p
    period = target_domain.size // src_domain.size
    g = src_domain.fr.params.multiplicative_generator
    wt = target_domain.root
    return [
        (pow(g * pow(wt, i, p) % p, src_domain.size, p) - 1) % p for i in range(period)
    ]


def compute_lagrange_polynomial_fft(
    src_domain: EvaluationDomain, target_domain: EvaluationDomain
) -> torch.Tensor:
    """Evaluations of L_1(X) = (X^n - 1)/(n (X - 1)) over the *coset* of the
    target domain (reference: polynomial_arithmetic.cpp:381-476)."""
    fr = target_domain.fr
    n_t = target_domain.size
    coset = target_domain.coset_root_vector()  # g * w'^i
    denom_inv = fr.batch_invert(fr.sub(coset, fr.one.reshape(18, 1)))
    vals = _coset_period_values(src_domain, target_domain)
    num_vals = [v * src_domain.domain_inverse % fr.p for v in vals]
    num = fr.encode(num_vals).repeat(1, n_t // len(vals))
    return fr.mont_mul(denom_inv, num)


def divide_by_pseudo_vanishing_polynomial(
    evals: torch.Tensor,
    src_domain: EvaluationDomain,
    target_domain: EvaluationDomain,
) -> torch.Tensor:
    """In coset-evaluation form, divide by
    Z_H*(X) = (X^n - 1)/(X - w^{n-1})  (reference:
    polynomial_arithmetic.cpp:478-560): multiply by (X - w^{n-1}) and by
    1/(X^n - 1), all evaluated on the target coset."""
    fr = target_domain.fr
    n_t = target_domain.size
    vals = _coset_period_values(src_domain, target_domain)
    inv_vals = [pow(v, -1, fr.p) for v in vals]
    inv_tiled = fr.encode(inv_vals).repeat(1, n_t // len(vals))
    coset = target_domain.coset_root_vector()
    numerator = fr.sub(coset, fr.const(src_domain.root_inverse).reshape(18, 1))
    return fr.mont_mul(fr.mont_mul(evals, inv_tiled), numerator)


def compute_kate_opening_coefficients(coeffs: torch.Tensor, z: int) -> tuple[torch.Tensor, int]:
    """W(X) = (F(X) - F(z)) / (X - z) by the reference's forward recurrence
    d_i = (c_i - d_{i-1}) * (-1/z) (polynomial_arithmetic.cpp:562-591): the
    affine recurrence d_i = m d_{i-1} + b_i with m = 1/z, b_0 = (c_0 - F(z))
    (-1/z), b_i = c_i (-1/z), one K1 ``scan`` launch on the card. Returns
    (W, F(z))."""
    fr = _fr(coeffs.device)
    f = evaluate(coeffs, z)
    w = (-pow(z, -1, fr.p)) % fr.p  # -1/z
    b0 = (fr.decode(coeffs[:, :1])[0] - f) * w % fr.p
    b = torch.cat([fr.encode([b0]), fr.mul_by_constant(coeffs, w)[:, 1:]], dim=1)
    return fr.affine_scan(fr.encode([(-w) % fr.p]), b, dim=1), f


def compress_fft(evals: torch.Tensor, factor_log2: int) -> torch.Tensor:
    """Evaluations on a 2^k domain -> evaluations on the 2^(k-j) subdomain
    (every 2^j-th point; reference polynomial_arithmetic.cpp:629-639)."""
    return evals[:, :: 1 << factor_log2]


def shrink_evaluation_domain(coeffs: torch.Tensor, new_size: int) -> torch.Tensor:
    """Truncate a coefficient array to a smaller power-of-two domain
    (reference polynomial.cpp:330-346; valid when the high coefficients are
    zero, the caller's responsibility, as in the reference)."""
    return coeffs[:, :new_size]


class LagrangeEvaluations(NamedTuple):
    vanishing_poly: int  # Z_H*(z)
    l_1: int
    l_n_minus_1: int


def get_lagrange_evaluations(z: int, domain: EvaluationDomain) -> LagrangeEvaluations:
    """Z_H*(z), L_1(z), L_{n-1}(z) on host ints (reference:
    polynomial_arithmetic.cpp:594-626)."""
    p = domain.fr.p
    z %= p
    z_pow = pow(z, domain.size, p)
    numerator = (z_pow - 1) % p
    d0 = (z - domain.root_inverse) % p
    d1 = (z - 1) % p
    d2 = (z * domain.root % p * domain.root - 1) % p
    vanishing = numerator * pow(d0, -1, p) % p
    scaled = numerator * domain.domain_inverse % p
    return LagrangeEvaluations(
        vanishing_poly=vanishing,
        l_1=scaled * pow(d1, -1, p) % p,
        l_n_minus_1=scaled * pow(d2, -1, p) % p,
    )
