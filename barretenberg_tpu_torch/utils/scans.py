"""Log-depth inclusive scans as Python loops over the levels: the plain
version of K1's ``scan`` (``kernels/field_kernels.py``), which the field's
``prefix_product`` and ``affine_scan`` run on a CPU tensor.

Hillis-Steele formulation: level i combines every element with the one 2^i
places before it (after it, for a suffix scan), n*log(n) work instead of
2n; each level is one call of the combiner over the whole array.
"""

from __future__ import annotations

import torch


def _valid_mask(n: int, d: int, dim: int, ndim: int, reverse: bool, device):
    j = torch.arange(n, device=device)
    valid = (j < n - d) if reverse else (j >= d)
    shape = [1] * ndim
    shape[dim] = n
    return valid.reshape(shape)


def hillis_scan(mul_fn, a: torch.Tensor, dim: int, reverse: bool = False):
    """Inclusive prefix (suffix if reverse) product along `dim`."""
    n = a.shape[dim]
    x = a
    for i in range((n - 1).bit_length() if n > 1 else 0):
        d = 1 << i
        shifted = torch.roll(x, -d if reverse else d, dims=dim)
        valid = _valid_mask(n, d, dim, a.ndim, reverse, a.device)
        x = torch.where(valid, mul_fn(x, shifted), x)
    return x


def affine_scan(mul_fn, add_fn, m: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of the affine recurrence d_i = m_i * d_{i-1} + b_i
    (d_0 = b_0): returns the d array. Combine rule (earlier f, later s):
    (m, b) = (m_s * m_f, m_s * b_f + b_s) - the Kate synthetic-division
    linear recurrence."""
    n = m.shape[dim]
    mm, bb = m, b
    for i in range((n - 1).bit_length() if n > 1 else 0):
        d = 1 << i
        pm = torch.roll(mm, d, dims=dim)
        pb = torch.roll(bb, d, dims=dim)
        valid = _valid_mask(n, d, dim, m.ndim, False, m.device)
        nm = mul_fn(mm, pm)
        nb = add_fn(mul_fn(mm, pb), bb)
        mm, bb = torch.where(valid, nm, mm), torch.where(valid, nb, bb)
    return bb
