"""Radix-2 FFT over Fr.

A transform of n = 2^k elements is a pass plan (``fft_plan``): its k DIT
stages split into one to three ranges, each one call of
kernels/butterfly.fft_pass - on the card one launch of K2b, which runs the
range on tiles in shared memory, on the CPU its plain version. The first
pass reads the input through the bit reversal; the forward scale (coset
powers, a constant) rides on the first pass, the inverse one (1/n times a
constant, inverse coset powers) on the last. The twiddles of stage s are
strided reads of the domain's single power table.

Conventions match the reference exactly: fft evaluates coefficients at
successive powers of the domain root (DIT, natural-order output); ifft uses
the inverse root and folds in 1/n; coset transforms pre/post-scale by the
multiplicative generator.
"""

from __future__ import annotations

from ..kernels.butterfly import MAX_TILE_LOG, fft_pass
from .domain import EvaluationDomain

# The default tile: 2^TILE_LOG elements per CTA, of which at least 2^COL_LOG
# neighbouring groups side by side; a pass runs TILE_LOG - COL_LOG stages.
TILE_LOG = 9
COL_LOG = 3


def fft_plan(log2n: int, tile_log: int = TILE_LOG, col_log: int = COL_LOG) -> list:
    """The passes of a 2^log2n transform as (first stage, stages, log2 of
    the columns per tile): one pass when the array fits one tile, else the
    fewest passes of at most tile_log - col_log stages, split as evenly as
    they go; each pass fills its tile with columns."""
    if not 0 <= col_log < tile_log <= MAX_TILE_LOG:
        raise ValueError(f"no pass plan for a 2^{tile_log} tile with 2^{col_log} columns")
    if log2n <= tile_log:
        return [(0, log2n, 0)]
    npass = -(-log2n // (tile_log - col_log))
    base, extra = divmod(log2n, npass)
    plan, s0 = [], 0
    for i in range(npass):
        b = base + (i < extra)
        cols = log2n - b if s0 == 0 else s0
        plan.append((s0, b, min(tile_log - b, cols)))
        s0 += b
    return plan


def transform(coeffs, domain: EvaluationDomain, inverse: bool, coset: bool, value: int | None,
              plan=None, pass_fn=fft_pass):
    """One FFT over the domain as the passes of `plan` (default
    ``fft_plan(log2 n)``), each a call of `pass_fn`."""
    fr = domain.fr
    k = domain.log2_size
    passes = fft_plan(k) if plan is None else plan
    scale_val = (value if value is not None else 1) % fr.p
    if inverse:
        scale_val = domain.domain_inverse * scale_val % fr.p
    const = scale_val if scale_val != 1 else None
    table = domain.inverse_twiddles if inverse else domain.twiddles
    tab = None
    if coset:
        tab = domain.coset_scale_inverse if inverse else domain.coset_scale
    owner = len(passes) - 1 if inverse else 0
    x = coeffs
    for i, (s0, stages, col_log) in enumerate(passes):
        mine = i == owner
        x = pass_fn(fr.params, x, table, k, s0, stages, col_log,
                    tab if mine else None, const if mine else None, inverse)
    return x


def fft(coeffs, domain: EvaluationDomain):
    return transform(coeffs, domain, False, False, None)


def ifft(evals, domain: EvaluationDomain):
    return transform(evals, domain, True, False, None)


def ifft_with_constant(evals, domain: EvaluationDomain, value: int):
    return transform(evals, domain, True, False, value)


def fft_with_constant(coeffs, domain: EvaluationDomain, value: int):
    return transform(coeffs, domain, False, False, value)


def coset_fft(coeffs, domain: EvaluationDomain):
    """Evaluate at the coset g*<omega>."""
    return transform(coeffs, domain, False, True, None)


def coset_fft_with_constant(coeffs, domain: EvaluationDomain, value: int):
    return transform(coeffs, domain, False, True, value)


def coset_ifft(evals, domain: EvaluationDomain):
    return transform(evals, domain, True, True, None)
