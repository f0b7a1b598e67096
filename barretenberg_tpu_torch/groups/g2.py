"""BN254 G2 on torch tensors (reference: curves/bn254/g2.hpp).

Port of the JAX package's ``groups/g2.py``. Twist curve y^2 = x^3 + b' over
Fq2, b' = 3/(9+i) (the twist_coeff_b of curves/bn254/fq2.hpp:10-15,
derived here rather than transcribed). The generic mask-merged group law
(groups/group.py) runs over the lane-wise Fq2 (fields/quadratic.py): on
the card one K1 launch per base-field product. USE_ENDOMORPHISM is false
for G2 (g2.hpp:12), as in the reference. ``g2(device)`` returns the one
cached ``Curve`` per device (default: the CUDA card).
"""

from __future__ import annotations

import functools

import torch

from ..config import resolve_device
from ..fields import fq as _fq
from ..fields.params import FQ_MODULUS
from ..fields.quadratic import QuadraticField
from ..utils import host_curve
from .group import AffinePoints, Curve, JacobianPoints

P = FQ_MODULUS


def _fq2_inv(a):
    t = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * t % P, -a[1] * t % P)


def _fq2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


TWIST_B = _fq2_mul((3, 0), _fq2_inv((9, 1)))


@functools.lru_cache(maxsize=None)
def _fq2(device: torch.device) -> QuadraticField:
    return QuadraticField(_fq(device))


def fq2(device=None) -> QuadraticField:
    """The lane-wise Fq2 on `device`."""
    return _fq2(resolve_device(device))


@functools.lru_cache(maxsize=None)
def _g2(device: torch.device) -> Curve:
    return Curve(_fq2(device), b_value=TWIST_B, generator_xy=host_curve.G2_GENERATOR)


def g2(device=None) -> Curve:
    return _g2(resolve_device(device))


def g2_points_to_host(p: AffinePoints) -> list:
    f2 = fq2(p.x.device)
    xs = f2.decode(p.x)
    ys = f2.decode(p.y)
    infs = p.inf.cpu().numpy()
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


def g2_jacobian_to_host(p: JacobianPoints) -> list:
    return g2_points_to_host(g2(p.x.device).batch_normalize(p))


def g2_host_to_affine(pts: list, device=None) -> AffinePoints:
    f2 = fq2(device)
    xs = [(0, 0) if pt is None else pt[0] for pt in pts]
    ys = [(0, 0) if pt is None else pt[1] for pt in pts]
    inf = torch.tensor([pt is None for pt in pts], dtype=torch.bool, device=f2.device)
    return AffinePoints(f2.encode(xs), f2.encode(ys), inf)
