"""Small-batch MSM: per-lane double-and-add + tree reduction.

The oracle-grade path. For small N the bucketed Pippenger's sort/scan
machinery costs more than it saves, so `msm` dispatches here below
MSM_PIPPENGER_THRESHOLD points.
"""

from __future__ import annotations

import torch

from ..groups import AffinePoints, JacobianPoints
from ..groups.g1 import g1 as _g1
from ..groups.group import cat_jacobian
from .pippenger import pippenger, scalar_digits

MSM_PIPPENGER_THRESHOLD = 4096


def _bits_msb(scalars_mont: torch.Tensor) -> torch.Tensor:
    return scalar_digits(scalars_mont, 1).flip(0)  # (254, N) MSB-first


def naive_msm(scalars_mont: torch.Tensor, points: AffinePoints) -> JacobianPoints:
    """sum_i scalars[i] * points[i] as one vectorized double-and-add over all
    lanes (254 steps), then a log-depth tree sum across lanes. Returns a
    JacobianPoints batch of shape (1,)."""
    g1 = _g1(scalars_mont.device)
    per_point = g1.scalar_mul_bits(points, _bits_msb(scalars_mont))
    return g1.tree_sum(per_point)


def msm(scalars_mont: torch.Tensor, points: AffinePoints) -> JacobianPoints:
    """Size-dispatching MSM."""
    if scalars_mont.shape[1] < MSM_PIPPENGER_THRESHOLD:
        return naive_msm(scalars_mont, points)
    return pippenger(scalars_mont, points)


def batched_msm(scalars_list, points: AffinePoints) -> JacobianPoints:
    """B MSMs over the same point set (the prover commits wire/quotient
    groups together). Small sizes run as ONE concatenated double-and-add
    sweep over (18, B*n) lanes and a per-group tree reduction; large sizes
    run Pippenger per group. Returns a (B,) JacobianPoints batch."""
    b = len(scalars_list)
    n = scalars_list[0].shape[1]
    if n >= MSM_PIPPENGER_THRESHOLD:
        return cat_jacobian([pippenger(s, points) for s in scalars_list])
    g1 = _g1(points.x.device)
    tiled = AffinePoints(points.x.repeat(1, b), points.y.repeat(1, b), points.inf.repeat(b))
    per_point = g1.scalar_mul_bits(tiled, _bits_msb(torch.cat(list(scalars_list), dim=1)))
    return g1.tree_sum(per_point, groups=b)
