"""Sigma permutation polynomials in Lagrange base, on the device.

Reference: waffle/proof_system/permutation.hpp:13-89. The whole polynomial
is one gather from the domain's root-of-unity table followed by a multiply
with the per-lane coset shift {1, k1, k2}.

Mapping encoding (composer_base.hpp:72-77): low 28 bits = gate index,
bits 30/31 = wire column (0 left, 1 right, 2 output).
"""

from __future__ import annotations

import numpy as np
import torch

from ..polynomials.domain import EvaluationDomain

WIRE_MASK = (1 << 29) - 1


def compute_permutation_lagrange_base(
    mapping: np.ndarray, domain: EvaluationDomain
) -> torch.Tensor:
    """mapping: uint32 (n,) host array -> (18, n) sigma evaluations."""
    fr = domain.fr
    mapping = np.asarray(mapping, dtype=np.uint64)
    idx = (mapping & WIRE_MASK).astype(np.int64)
    col = (mapping >> 30).astype(np.int64)
    if not (col <= 2).all():
        raise ValueError("malformed sigma mapping: wire column > 2")
    if not (idx < domain.size).all():
        raise ValueError("malformed sigma mapping: gate index out of range")

    roots = domain.root_vector()  # (18, n) table of w^k
    sigma = roots.index_select(1, torch.from_numpy(idx).to(domain.device))
    k1 = fr.params.multiplicative_generator
    k2 = fr.params.alternate_multiplicative_generator
    shift_table = fr.encode([1, k1, k2])  # (18, 3)
    shifts = shift_table.index_select(1, torch.from_numpy(col).to(domain.device))
    return fr.mont_mul(sigma, shifts)
