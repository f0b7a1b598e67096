"""Small-batch MSM: per-lane double-and-add + tree reduction.

The oracle-grade path. For small N the bucketed Pippenger's sort/scan
machinery costs more than it saves, so `msm` dispatches here below
MSM_PIPPENGER_THRESHOLD points. The double-and-add is one K3d launch
(`Curve.scalar_mul_bits`) over every lane of every MSM of a call.
"""

from __future__ import annotations

import torch

from ..fields import fr as _fr
from ..fields.params import LIMB_BITS
from ..groups import AffinePoints, JacobianPoints
from ..groups.g1 import g1 as _g1
from .pippenger import MSM_PIPPENGER_THRESHOLD, SCALAR_BITS, pippenger, pippenger_batch


def scalar_bits(scalars_mont: torch.Tensor) -> torch.Tensor:
    """Internal-Montgomery Fr scalars (18, N) -> (254, N) uint8 bits of the
    canonical values, most significant first: one gather of each bit's limb
    and one shift-and-mask (equal to `scalar_digits(scalars, 1).flip(0)`)."""
    value = _fr(scalars_mont.device).to_plain(scalars_mont)
    k = torch.arange(SCALAR_BITS - 1, -1, -1, device=value.device)
    shift = (k % LIMB_BITS).to(value.dtype).unsqueeze(1)
    return ((value[k // LIMB_BITS] >> shift) & 1).to(torch.uint8)


def naive_msm(scalars_mont: torch.Tensor, points: AffinePoints) -> JacobianPoints:
    """sum_i scalars[i] * points[i] as one vectorized double-and-add over all
    lanes (254 steps), then a log-depth tree sum across lanes. Returns a
    JacobianPoints batch of shape (1,)."""
    g1 = _g1(scalars_mont.device)
    per_point = g1.scalar_mul_bits(points, scalar_bits(scalars_mont))
    return g1.tree_sum(per_point)


def msm(scalars_mont: torch.Tensor, points: AffinePoints) -> JacobianPoints:
    """Size-dispatching MSM, as the JAX package's: the naive MSM below
    MSM_PIPPENGER_THRESHOLD points, the fused Pippenger schedule up to
    ``pippenger.FUSED_MAX_N``, the rounds-batched one above."""
    if scalars_mont.shape[1] < MSM_PIPPENGER_THRESHOLD:
        return naive_msm(scalars_mont, points)
    return pippenger(scalars_mont, points)


def batched_msm(scalars_list, points: AffinePoints) -> JacobianPoints:
    """B MSMs over the same point set (the prover commits wire/quotient
    groups together). Small sizes run as ONE double-and-add over B*n lanes
    (lane l takes point l % n) and a per-group tree reduction; large sizes
    as ONE Pippenger launch set over all B (``pippenger_batch``): up to
    ``pippenger.FUSED_MAX_N`` points the fused schedule, above it the
    rounds-batched one, each group's result the JAX package's per-group
    ``pippenger``. Returns a (B,) JacobianPoints batch."""
    b = len(scalars_list)
    n = scalars_list[0].shape[1]
    if n >= MSM_PIPPENGER_THRESHOLD:
        return pippenger_batch(list(scalars_list), points)
    g1 = _g1(points.x.device)
    per_point = g1.scalar_mul_bits(points, scalar_bits(torch.cat(list(scalars_list), dim=1)))
    return g1.tree_sum(per_point, groups=b)
