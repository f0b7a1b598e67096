"""BN254 G1 instantiation (reference: curves/bn254/g1.hpp).

Curve: y^2 = x^3 + 3 over Fq, generator (1, 2). ``g1(device)`` returns the
one cached ``Curve`` per device (default: the CUDA card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import resolve_device
from ..fields import fq as _fq
from ..fields.params import FR_MODULUS
from ..utils import host_curve
from .group import AffinePoints, Curve, JacobianPoints


@functools.lru_cache(maxsize=None)
def _g1(device: torch.device) -> Curve:
    return Curve(_fq(device), b_value=3, generator_xy=(1, 2))


def g1(device=None) -> Curve:
    return _g1(resolve_device(device))


def points_to_host(p: AffinePoints) -> list:
    """Affine device batch -> list of host (x, y) tuples / None."""
    fq = _fq(p.x.device)
    xs = fq.decode(p.x)
    ys = fq.decode(p.y)
    infs = p.inf.cpu().numpy()
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


def jacobian_to_host(p: JacobianPoints) -> list:
    return points_to_host(g1(p.x.device).batch_normalize(p))


def host_to_affine_points(pts: list, device=None) -> AffinePoints:
    fq = _fq(device)
    xs = [0 if pt is None else pt[0] for pt in pts]
    ys = [0 if pt is None else pt[1] for pt in pts]
    inf = torch.tensor([pt is None for pt in pts], dtype=torch.bool, device=fq.device)
    return AffinePoints(fq.encode(xs), fq.encode(ys), inf)


@functools.lru_cache(maxsize=None)
def _fixed_base_table_host() -> tuple:
    """32 * 256 host points: entry [w*256 + k] = [k * 2^(8w)]G (~8k host
    group adds, built once). For a FIXED base the whole window table
    precomputes, so a 254-bit multiply needs 32 gathers + 32 mixed adds and
    zero doublings."""
    pts: list = []
    base = host_curve.G1_GENERATOR
    for _w in range(32):
        cur = None
        row = [None]
        for _k in range(255):
            cur = host_curve.g1_add(cur, base)
            row.append(cur)
        pts.extend(row)
        base = host_curve.g1_add(cur, base)  # 256*2^(8w)*G = 2^(8(w+1))*G
    return tuple(pts)


@functools.lru_cache(maxsize=None)
def fixed_base_table(device: torch.device) -> torch.Tensor:
    """The 32 * 256 window table on one device, built once, as the
    (8192, 20) point rows K3e reads (``point_kernels.point_table``)."""
    from ..kernels import point_kernels

    return point_kernels.point_table(*host_to_affine_points(list(_fixed_base_table_host()), device))


def fixed_base_digits(scalars: list, device=None) -> torch.Tensor:
    """Host-int scalars -> (32, n) uint8 window digits (the little-endian
    bytes of each scalar mod r) on the device."""
    n = len(scalars)
    buf = np.frombuffer(
        b"".join((int(s) % FR_MODULUS).to_bytes(32, "little") for s in scalars),
        dtype=np.uint8,
    ).reshape(n, 32)
    return torch.from_numpy(np.ascontiguousarray(buf.T)).to(resolve_device(device))


def fixed_base_mul(scalars: list, device=None) -> JacobianPoints:
    """[k_i]G for a list of host-int scalars, via the window table: 32
    gather + mixed-add steps for any batch size, one K3e launch on the card
    (the fast path for SRS generation and any generator exponentiation)."""
    from ..kernels import point_kernels

    dev = resolve_device(device)
    return point_kernels.fixed_base(fixed_base_digits(scalars, dev), fixed_base_table(dev))
