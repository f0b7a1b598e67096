"""Vectorized short-Weierstrass group law (y^2 = x^3 + b, a = 0).

Points are struct-of-(limb-)arrays with an explicit infinity mask vector;
the group law is branch-free per lane (kernels/point_kernels.py: the CUDA
kernel on the card, its plain PyTorch version on the CPU). The reference
encodes infinity by setting the MSB of y; that encoding only exists at
serialization boundaries here.

Batches are flat: coordinates (18, n), masks (n,).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..fields.montgomery import Field


class JacobianPoints(NamedTuple):
    """Batch of Jacobian points. x,y,z: (18, n) int32; inf: (n,) bool."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    inf: torch.Tensor


class AffinePoints(NamedTuple):
    """Batch of affine points with explicit infinity mask."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor


def cat_jacobian(parts) -> JacobianPoints:
    """Concatenate Jacobian batches along the lane axis."""
    return JacobianPoints(
        torch.cat([p.x for p in parts], dim=1),
        torch.cat([p.y for p in parts], dim=1),
        torch.cat([p.z for p in parts], dim=1),
        torch.cat([p.inf for p in parts], dim=0),
    )


def take_jacobian(p: JacobianPoints, idx: torch.Tensor) -> JacobianPoints:
    return JacobianPoints(
        p.x.index_select(1, idx),
        p.y.index_select(1, idx),
        p.z.index_select(1, idx),
        p.inf.index_select(0, idx),
    )


class Curve:
    """Group law over a `Field` (whose device the curve shares). b is the
    curve constant (value). Only G1 over Fq is instantiated: the point
    kernels are built for that field."""

    def __init__(self, field: Field, b_value: int, generator_xy: tuple[int, int]):
        assert field.params.name == "fq", "the point kernels are G1-over-Fq only"
        self.f = field
        self.device = field.device
        self.b_value = b_value
        self.b = field.const(b_value)
        self.generator_affine = generator_xy

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    def _mask(self, n: int, value: bool) -> torch.Tensor:
        return torch.full((n,), value, dtype=torch.bool, device=self.device)

    def infinity(self, n: int = 1) -> JacobianPoints:
        z = self.f.zeros((n,))
        return JacobianPoints(z, z, z, self._mask(n, True))

    def affine_infinity(self, n: int = 1) -> AffinePoints:
        z = self.f.zeros((n,))
        return AffinePoints(z, z, self._mask(n, True))

    def to_jacobian(self, p: AffinePoints) -> JacobianPoints:
        one = self.f.full(p.x.shape[1:], self.f.one)
        return JacobianPoints(p.x, p.y, one, p.inf)

    def generator(self, n: int = 1) -> AffinePoints:
        gx, gy = self.generator_affine
        f = self.f
        return AffinePoints(
            f.full((n,), f.const(gx)), f.full((n,), f.const(gy)), self._mask(n, False)
        )

    # ------------------------------------------------------------------
    # Group law
    # ------------------------------------------------------------------
    def dbl(self, p: JacobianPoints) -> JacobianPoints:
        from ..kernels import point_kernels

        return point_kernels.dbl(p)

    def add(self, p: JacobianPoints, q: JacobianPoints) -> JacobianPoints:
        from ..kernels import point_kernels

        return point_kernels.add(p, q)

    def mixed_add(self, p: JacobianPoints, q: AffinePoints) -> JacobianPoints:
        from ..kernels import point_kernels

        return point_kernels.mixed_add(p, q)

    def neg(self, p: JacobianPoints) -> JacobianPoints:
        return JacobianPoints(p.x, self.f.neg(p.y), p.z, p.inf)

    def neg_affine(self, p: AffinePoints) -> AffinePoints:
        return AffinePoints(p.x, self.f.neg(p.y), p.inf)

    def conditional_negate_affine(self, p: AffinePoints, predicate: torch.Tensor) -> AffinePoints:
        """-p on the lanes where ``predicate`` ((n,) bool) holds, as a lane
        select (the reference's cmov)."""
        return AffinePoints(p.x, self.f.select(predicate, self.f.neg(p.y), p.y), p.inf)

    # ------------------------------------------------------------------
    # Normalization / predicates
    # ------------------------------------------------------------------
    def batch_normalize(self, p: JacobianPoints) -> AffinePoints:
        """Jacobian -> affine via Montgomery batch inversion of z."""
        f = self.f
        z = f.select(p.inf, f.one.reshape(18, 1), p.z)
        zinv = f.batch_invert(z)
        zinv2 = f.sqr(zinv)
        x = f.mul(p.x, zinv2)
        y = f.mul(p.y, f.mul(zinv, zinv2))
        return AffinePoints(x, y, p.inf)

    def normalize(self, p: JacobianPoints) -> AffinePoints:
        return self.batch_normalize(p)

    def batch_normalize_chunked(self, p: JacobianPoints, chunk: int = 1 << 16) -> AffinePoints:
        """batch_normalize in fixed-size chunks (bounds the scans' scratch)."""
        n = p.x.shape[1]
        if n <= chunk:
            return self.batch_normalize(p)
        outs = [
            self.batch_normalize(
                JacobianPoints(
                    p.x[:, lo : lo + chunk], p.y[:, lo : lo + chunk],
                    p.z[:, lo : lo + chunk], p.inf[lo : lo + chunk],
                )
            )
            for lo in range(0, n, chunk)
        ]
        return AffinePoints(
            torch.cat([o.x for o in outs], dim=1),
            torch.cat([o.y for o in outs], dim=1),
            torch.cat([o.inf for o in outs], dim=0),
        )

    def on_curve_affine(self, p: AffinePoints) -> torch.Tensor:
        f = self.f
        lhs = f.sqr(p.y)
        rhs = f.add(f.mul(f.sqr(p.x), p.x), self.b.reshape(18, 1))
        return p.inf | f.eq(lhs, rhs)

    def eq(self, p: JacobianPoints, q: JacobianPoints) -> torch.Tensor:
        """Projective equality by cross-multiplication: x1 z2^2 = x2 z1^2 and
        y1 z2^3 = y2 z1^3, or both at infinity."""
        f = self.f
        z1z1 = f.sqr(p.z)
        z2z2 = f.sqr(q.z)
        x_eq = f.eq(f.mul(p.x, z2z2), f.mul(q.x, z1z1))
        y_eq = f.eq(f.mul(p.y, f.mul(q.z, z2z2)), f.mul(q.y, f.mul(p.z, z1z1)))
        return (p.inf & q.inf) | (~p.inf & ~q.inf & x_eq & y_eq)

    # ------------------------------------------------------------------
    # Scalar multiplication (oracle-grade; MSM lives in msm/)
    # ------------------------------------------------------------------
    def scalar_mul_bits(self, p: AffinePoints, bits: torch.Tensor) -> JacobianPoints:
        """Double-and-add over an MSB-first bit array, bits: (nbits, lanes)
        in {0, 1}, lanes a multiple of p's n points; lane l multiplies point
        l % n. One K3d launch on the card (its plain loop on the CPU)."""
        from ..kernels import point_kernels

        return point_kernels.scalar_mul_bits(p, bits)

    def scalar_mul_windowed(self, p: AffinePoints, scalars_mont: torch.Tensor, c: int = 5) -> JacobianPoints:
        """[k_l] p_l for an arbitrary base per lane and its internal-Montgomery
        Fr scalar ((18, n)), by signed c-bit windows over the full 254-bit
        scalar (no endomorphism): per lane a table of 2^(c-1) + 1 multiples,
        then c doublings and one table add per window. One K3g launch on the
        card (its plain walk on the CPU)."""
        from ..kernels import point_kernels

        return point_kernels.windowed_walk(p, scalars_mont, c)

    def tree_sum(self, p: JacobianPoints, groups: int = 1) -> JacobianPoints:
        """Log-depth sum over the lane axis, viewed as `groups` contiguous
        groups of equal length: returns one point per group. Level i folds
        the upper half of every group onto its lower half."""
        n = p.x.shape[1] // groups
        size = 1 << (n - 1).bit_length() if n > 1 else 1

        def grouped(t, lead):
            return t.reshape(lead + (groups, n))

        x, y, z, inf = grouped(p.x, (18,)), grouped(p.y, (18,)), grouped(p.z, (18,)), grouped(p.inf, ())
        if size != n:
            pad = (0, size - n)
            x, y, z = F.pad(x, pad), F.pad(y, pad), F.pad(z, pad)
            inf = F.pad(inf, pad, value=True)
        while size > 1:
            half = size // 2

            def halves(t, lead):
                lo = t[..., :half].reshape(lead + (groups * half,))
                hi = t[..., half:size].reshape(lead + (groups * half,))
                return lo, hi

            (xl, xh), (yl, yh), (zl, zh), (il, ih) = (
                halves(x, (18,)), halves(y, (18,)), halves(z, (18,)), halves(inf, ())
            )
            s = self.add(JacobianPoints(xl, yl, zl, il), JacobianPoints(xh, yh, zh, ih))
            size = half
            x, y, z = (t.reshape(18, groups, size) for t in (s.x, s.y, s.z))
            inf = s.inf.reshape(groups, size)
        return JacobianPoints(x[..., 0], y[..., 0], z[..., 0], inf[..., 0])

    # ------------------------------------------------------------------
    # Gather / select helpers for MSM
    # ------------------------------------------------------------------
    @staticmethod
    def take_affine(p: AffinePoints, idx: torch.Tensor) -> AffinePoints:
        return AffinePoints(
            p.x.index_select(1, idx), p.y.index_select(1, idx), p.inf.index_select(0, idx)
        )

    def select_points(self, mask, p: JacobianPoints, q: JacobianPoints) -> JacobianPoints:
        f = self.f
        return JacobianPoints(
            f.select(mask, p.x, q.x),
            f.select(mask, p.y, q.y),
            f.select(mask, p.z, q.z),
            torch.where(mask, p.inf, q.inf),
        )
