"""Vectorized short-Weierstrass group law (y^2 = x^3 + b, a = 0).

Points are struct-of-(limb-)arrays with an explicit infinity mask vector;
the group law is branch-free per lane. Over Fq (G1) it runs in the point
kernels (kernels/point_kernels.py: the CUDA kernel on the card, its plain
PyTorch version on the CPU). Over an extension field (G2 over Fq2,
groups/g2.py) it runs the JAX package's generic mask-merged formulas
through the field's ops - on the card one K1 launch per base-field
product. The reference encodes infinity by setting the MSB of y; that
encoding only exists at serialization boundaries here.

Batches are flat: coordinates (18, n) over Fq, (2, 18, n) over Fq2; masks
(n,).
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
    """Group law over a `Field` or a `QuadraticField` (whose device the
    curve shares). b is the curve constant (value). Over Fq the point
    kernels and the chain kernels carry it; over any other field the
    generic formulas below."""

    def __init__(self, field: Field, b_value, generator_xy: tuple):
        self.f = field
        self.device = field.device
        self.b_value = b_value
        self.b = field.const(b_value)
        self.generator_affine = generator_xy
        # the point and chain kernels are built for G1 over Fq
        self.kernels = isinstance(field, Field) and field.params.name == "fq"
        self._one_col = field.one.reshape(field.one.shape + (1,))
        self._b_col = self.b.reshape(self.b.shape + (1,))

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
        one = self.f.full(p.inf.shape, self.f.one)
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
        """Point doubling, dbl-2009-l for a = 0 (reference group.hpp:153-217)."""
        if self.kernels:
            from ..kernels import point_kernels

            return point_kernels.dbl(p)
        f = self.f
        a = f.sqr(p.x)
        b = f.sqr(p.y)
        c = f.sqr(b)
        d = f.double(f.sub(f.sqr(f.add(p.x, b)), f.add(a, c)))
        e = f.add(f.double(a), a)
        ff = f.sqr(e)
        x3 = f.sub(ff, f.double(d))
        y3 = f.sub(f.mul(e, f.sub(d, x3)), f.double(f.double(f.double(c))))
        z3 = f.double(f.mul(p.y, p.z))
        return JacobianPoints(x3, y3, z3, p.inf)

    def _merge(self, p: JacobianPoints, q_inf, q_x, q_y, q_z, h, r, x3, y3, z3) -> JacobianPoints:
        """The mask merge of the generic add and mixed add: doubling where P
        = Q, infinity where P = -Q, the other operand where one is at
        infinity (reference group.hpp:324-448's branch ladder, as selects)."""
        f = self.f
        h_zero, r_zero = f.is_zero(h), f.is_zero(r)
        dbl_res = self.dbl(p)
        both_live = ~p.inf & ~q_inf
        use_dbl = both_live & h_zero & r_zero
        cancel = both_live & h_zero & ~r_zero
        x = f.select(use_dbl, dbl_res.x, x3)
        y = f.select(use_dbl, dbl_res.y, y3)
        z = f.select(use_dbl, dbl_res.z, z3)
        x = f.select(q_inf, p.x, f.select(p.inf, q_x, x))
        y = f.select(q_inf, p.y, f.select(p.inf, q_y, y))
        z = f.select(q_inf, p.z, f.select(p.inf, q_z, z))
        inf = torch.where(q_inf, p.inf, torch.where(p.inf, q_inf, cancel))
        return JacobianPoints(x, y, z, inf)

    def add(self, p: JacobianPoints, q: JacobianPoints) -> JacobianPoints:
        """Complete Jacobian addition (add-2007-bl, mask-merged)."""
        if self.kernels:
            from ..kernels import point_kernels

            return point_kernels.add(p, q)
        f = self.f
        z1z1 = f.sqr(p.z)
        z2z2 = f.sqr(q.z)
        u1 = f.mul(p.x, z2z2)
        u2 = f.mul(q.x, z1z1)
        s1 = f.mul(p.y, f.mul(q.z, z2z2))
        s2 = f.mul(q.y, f.mul(p.z, z1z1))
        h = f.sub(u2, u1)
        r = f.double(f.sub(s2, s1))
        i = f.sqr(f.double(h))
        j = f.mul(h, i)
        v = f.mul(u1, i)
        x3 = f.sub(f.sqr(r), f.add(j, f.double(v)))
        y3 = f.sub(f.mul(r, f.sub(v, x3)), f.double(f.mul(s1, j)))
        z3 = f.mul(f.sub(f.sqr(f.add(p.z, q.z)), f.add(z1z1, z2z2)), h)
        return self._merge(p, q.inf, q.x, q.y, q.z, h, r, x3, y3, z3)

    def mixed_add(self, p: JacobianPoints, q: AffinePoints) -> JacobianPoints:
        """Jacobian + affine (reference mixed_add_inner, group.hpp:219-303)."""
        if self.kernels:
            from ..kernels import point_kernels

            return point_kernels.mixed_add(p, q)
        f = self.f
        z1z1 = f.sqr(p.z)
        u2 = f.mul(q.x, z1z1)
        s2 = f.mul(q.y, f.mul(p.z, z1z1))
        h = f.sub(u2, p.x)
        r = f.double(f.sub(s2, p.y))
        hh = f.sqr(h)
        i = f.double(f.double(hh))
        j = f.mul(h, i)
        v = f.mul(p.x, i)
        x3 = f.sub(f.sqr(r), f.add(j, f.double(v)))
        y3 = f.sub(f.mul(r, f.sub(v, x3)), f.double(f.mul(p.y, j)))
        z3 = f.sub(f.sqr(f.add(p.z, h)), f.add(z1z1, hh))
        one = f.full(p.inf.shape, f.one)
        return self._merge(p, q.inf, q.x, q.y, one, h, r, x3, y3, z3)

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
        z = f.select(p.inf, self._one_col, p.z)
        zinv = f.batch_invert(z)
        zinv2 = f.sqr(zinv)
        x = f.mul(p.x, zinv2)
        y = f.mul(p.y, f.mul(zinv, zinv2))
        return AffinePoints(x, y, p.inf)

    def normalize(self, p: JacobianPoints) -> AffinePoints:
        return self.batch_normalize(p)

    def batch_normalize_chunked(self, p: JacobianPoints, chunk: int = 1 << 16) -> AffinePoints:
        """batch_normalize in fixed-size chunks (bounds the scans' scratch)."""
        n = p.x.shape[-1]
        if n <= chunk:
            return self.batch_normalize(p)
        outs = [
            self.batch_normalize(
                JacobianPoints(
                    p.x[..., lo : lo + chunk], p.y[..., lo : lo + chunk],
                    p.z[..., lo : lo + chunk], p.inf[lo : lo + chunk],
                )
            )
            for lo in range(0, n, chunk)
        ]
        return AffinePoints(
            torch.cat([o.x for o in outs], dim=-1),
            torch.cat([o.y for o in outs], dim=-1),
            torch.cat([o.inf for o in outs], dim=0),
        )

    def on_curve_affine(self, p: AffinePoints) -> torch.Tensor:
        f = self.f
        lhs = f.sqr(p.y)
        rhs = f.add(f.mul(f.sqr(p.x), p.x), self._b_col)
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
        l % n. Over Fq one K3d launch on the card (its plain loop on the
        CPU); over another field (G2) the JAX package's loop, per bit a
        doubling and a mixed add kept where the bit is set, lanes equal to
        p's points."""
        if self.kernels:
            from ..kernels import point_kernels

            return point_kernels.scalar_mul_bits(p, bits)
        f = self.f
        acc = self.infinity(p.inf.shape[0])
        for bit in bits.ne(0):
            acc = self.dbl(acc)
            added = self.mixed_add(acc, p)
            acc = JacobianPoints(f.select(bit, added.x, acc.x), f.select(bit, added.y, acc.y),
                                 f.select(bit, added.z, acc.z), torch.where(bit, added.inf, acc.inf))
        return acc

    def scalar_mul_windowed(self, p: AffinePoints, scalars_mont: torch.Tensor, c: int = 5) -> JacobianPoints:
        """[k_l] p_l for an arbitrary base per lane and its internal-Montgomery
        Fr scalar ((18, n)), by signed c-bit windows over the full 254-bit
        scalar (no endomorphism): per lane a table of 2^(c-1) + 1 multiples,
        then c doublings and one table add per window. One K3g launch on the
        card (its plain walk on the CPU). G1 only: K3g is built for Fq."""
        if not self.kernels:
            raise NotImplementedError("scalar_mul_windowed runs on G1 only (K3g is built for Fq)")
        from ..kernels import point_kernels

        return point_kernels.windowed_walk(p, scalars_mont, c)

    def tree_sum(self, p: JacobianPoints, groups: int = 1) -> JacobianPoints:
        """Log-depth sum over the lane axis, viewed as `groups` contiguous
        groups of equal length: returns one point per group. Level i folds
        the upper half of every group onto its lower half."""
        n = p.x.shape[-1] // groups
        size = 1 << (n - 1).bit_length() if n > 1 else 1
        lead = tuple(p.x.shape[:-1])

        def grouped(t, lead):
            return t.reshape(lead + (groups, n))

        x, y, z, inf = grouped(p.x, lead), grouped(p.y, lead), grouped(p.z, lead), grouped(p.inf, ())
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
                halves(x, lead), halves(y, lead), halves(z, lead), halves(inf, ())
            )
            s = self.add(JacobianPoints(xl, yl, zl, il), JacobianPoints(xh, yh, zh, ih))
            size = half
            x, y, z = (t.reshape(lead + (groups, size)) for t in (s.x, s.y, s.z))
            inf = s.inf.reshape(groups, size)
        return JacobianPoints(x[..., 0], y[..., 0], z[..., 0], inf[..., 0])

    # ------------------------------------------------------------------
    # Gather / select helpers for MSM
    # ------------------------------------------------------------------
    @staticmethod
    def take_affine(p: AffinePoints, idx: torch.Tensor) -> AffinePoints:
        return AffinePoints(
            p.x.index_select(-1, idx), p.y.index_select(-1, idx), p.inf.index_select(0, idx)
        )

    def select_points(self, mask, p: JacobianPoints, q: JacobianPoints) -> JacobianPoints:
        f = self.f
        return JacobianPoints(
            f.select(mask, p.x, q.x),
            f.select(mask, p.y, q.y),
            f.select(mask, p.z, q.z),
            torch.where(mask, p.inf, q.inf),
        )
