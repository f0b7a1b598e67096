"""Radix-2 FFT over Fr.

Bit-reverse gather once, then log2(n) flat butterfly stages; stage s views
the (18, n) array as (18, n / 2^(s+1), 2, 2^s, 1) and is one call of
kernels/butterfly.butterfly_stage - on the card one launch of the butterfly
kernel per stage, on the CPU its plain version. The twiddles of stage s are
a strided slice of the domain's single power table.

Conventions match the reference exactly: fft evaluates coefficients at
successive powers of the domain root (DIT, natural-order output); ifft uses
the inverse root and folds in 1/n; coset transforms pre/post-scale by the
multiplicative generator.
"""

from __future__ import annotations

import torch

from ..kernels.butterfly import butterfly_stage
from .domain import EvaluationDomain


def _fft_core(coeffs: torch.Tensor, domain: EvaluationDomain, inverse: bool):
    n = domain.size
    assert coeffs.shape == (18, n)
    x = coeffs.index_select(1, domain.bit_reverse_indices)
    table = domain.inverse_twiddles if inverse else domain.twiddles
    params = domain.fr.params
    for s in range(domain.log2_size):
        h = 1 << s
        tw = table[:, :: n // (2 * h)][:, :h]
        x5 = butterfly_stage(params, x.reshape(18, n // (2 * h), 2, h, 1), tw)
        x = x5.reshape(18, n)
    return x


def _dispatch(coeffs, domain, inverse: bool, coset: bool, value: int | None):
    fr = domain.fr
    if inverse:
        scale_val = domain.domain_inverse * (value if value is not None else 1) % fr.p
    else:
        scale_val = (value if value is not None else 1) % fr.p
    if not inverse:
        if coset:
            coeffs = fr.mont_mul(coeffs, domain.coset_scale)
        if scale_val != 1:
            coeffs = fr.mul_by_constant(coeffs, scale_val)
        return _fft_core(coeffs, domain, inverse=False)
    out = _fft_core(coeffs, domain, inverse=True)
    if scale_val != 1:
        out = fr.mul_by_constant(out, scale_val)
    if coset:
        out = fr.mont_mul(out, domain.coset_scale_inverse)
    return out


def fft(coeffs, domain: EvaluationDomain):
    return _dispatch(coeffs, domain, False, False, None)


def ifft(evals, domain: EvaluationDomain):
    return _dispatch(evals, domain, True, False, None)


def ifft_with_constant(evals, domain: EvaluationDomain, value: int):
    return _dispatch(evals, domain, True, False, value)


def fft_with_constant(coeffs, domain: EvaluationDomain, value: int):
    return _dispatch(coeffs, domain, False, False, value)


def coset_fft(coeffs, domain: EvaluationDomain):
    """Evaluate at the coset g*<omega>."""
    return _dispatch(coeffs, domain, False, True, None)


def coset_fft_with_constant(coeffs, domain: EvaluationDomain, value: int):
    return _dispatch(coeffs, domain, False, True, value)


def coset_ifft(evals, domain: EvaluationDomain):
    return _dispatch(evals, domain, True, True, None)
