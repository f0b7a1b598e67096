"""Lane-wise quadratic extension field Fq2 = Fq[i]/(i^2 + 1) on torch tensors.

Port of the JAX package's ``fields/quadratic.py`` (reference:
fields/field2.hpp - Karatsuba mul :23-49, norm-based invert :146-165,
conjugation :167). An element tensor carries a leading coordinate axis:
shape ``(2, 18, *batch)``, int32 limbs in the base field's internal
Montgomery form. The API mirrors ``Field`` so that the generic group law
(groups/group.py) runs over it: that is the device G2 (groups/g2.py).

Every base-field product, sum and difference goes through the base field's
ops, so on a CUDA tensor each one is one launch of K1 (as each reaches
``_mul_fn`` in the JAX package), on a CPU tensor its plain version. A
``(2, 18, 1)`` constant broadcasts against a batch without a copy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .montgomery import Field

L = 18


class _Params(NamedTuple):
    name: str


class QuadraticField:
    """Field-compatible API over pairs of base-field elements; shares the
    base field's device."""

    def __init__(self, base: Field, name: str = "fq2"):
        self.base = base
        self.p = base.p
        self.device = base.device
        self.params = _Params(name=name)
        self.one = self.const((1, 0))
        self.zero = self.const((0, 0))

    # -- encoding -------------------------------------------------------------
    def const(self, value) -> torch.Tensor:
        """(c0, c1) int pair (or an int for (c, 0)) -> (2, 18) tensor."""
        c0, c1 = value if isinstance(value, tuple) else (value, 0)
        return torch.stack([self.base.const(c0), self.base.const(c1)])

    def encode(self, values) -> torch.Tensor:
        """List of (c0, c1) -> (2, 18, N)."""
        return torch.stack(
            [self.base.encode([v[0] for v in values]), self.base.encode([v[1] for v in values])]
        )

    def decode(self, a) -> list:
        return list(zip(self.base.decode(a[0]), self.base.decode(a[1])))

    # -- shape helpers --------------------------------------------------------
    @staticmethod
    def batch_shape(a) -> tuple:
        return tuple(a.shape[2:])

    def zeros(self, batch_shape) -> torch.Tensor:
        return torch.zeros((2, L, *batch_shape), dtype=torch.int32, device=self.device)

    def full(self, batch_shape, scalar) -> torch.Tensor:
        """A materialised (2, 18, *batch) tensor filled with one element."""
        col = scalar.reshape((2, L) + (1,) * len(batch_shape))
        return col.expand((2, L, *batch_shape)).contiguous()

    def column(self, scalar) -> torch.Tensor:
        """A (2, 18) element as a (2, 18, 1) column that broadcasts over a
        flat batch (no copy)."""
        return scalar.reshape(2, L, 1)

    # -- arithmetic (field2.hpp) ----------------------------------------------
    def add(self, a, b):
        f = self.base
        return torch.stack([f.add(a[0], b[0]), f.add(a[1], b[1])])

    def sub(self, a, b):
        f = self.base
        return torch.stack([f.sub(a[0], b[0]), f.sub(a[1], b[1])])

    def neg(self, a):
        f = self.base
        return torch.stack([f.neg(a[0]), f.neg(a[1])])

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Karatsuba over i^2 = -1 (field2.hpp:23-49): three base products."""
        f = self.base
        t0 = f.mont_mul(a[0], b[0])
        t1 = f.mont_mul(a[1], b[1])
        c0 = f.sub(t0, t1)
        c1 = f.sub(f.mont_mul(f.add(a[0], a[1]), f.add(b[0], b[1])), f.add(t0, t1))
        return torch.stack([c0, c1])

    mont_mul = mul

    def sqr(self, a):
        """(a0 + a1)(a0 - a1) + 2 a0 a1 i (field2.hpp:51-63)."""
        f = self.base
        t = f.mont_mul(a[0], a[1])
        c0 = f.mont_mul(f.add(a[0], a[1]), f.sub(a[0], a[1]))
        return torch.stack([c0, f.add(t, t)])

    def mul_by_base(self, a, b_base):
        """Multiply by a base-field element tensor."""
        f = self.base
        return torch.stack([f.mont_mul(a[0], b_base), f.mont_mul(a[1], b_base)])

    def conjugate(self, a):
        """Frobenius (field2.hpp:167)."""
        return torch.stack([a[0], self.base.neg(a[1])])

    def invert(self, a):
        """conj(a) / norm(a) (field2.hpp:146-165): one base inversion (one K1
        pow on the card). Maps 0 -> 0."""
        f = self.base
        norm = f.add(f.sqr(a[0]), f.sqr(a[1]))
        inv = f.invert(norm)
        return torch.stack([f.mont_mul(a[0], inv), f.neg(f.mont_mul(a[1], inv))])

    def batch_invert(self, a, axis: int = 2):
        """Inverses along a batch axis of the (2, 18, *batch) tensor: each
        conj(a) / norm(a), the norms inverted together by the base field's
        Montgomery trick (two K1 scans and one pow on the card). The JAX
        package runs the trick on fq2 products; the inverse of each nonzero
        element is the same value, and a zero anywhere in the batch makes
        every output zero in both (the total's inverse is 0)."""
        f = self.base
        norm = f.add(f.sqr(a[0]), f.sqr(a[1]))
        inv = f.batch_invert(norm, dim=axis - 1)
        return torch.stack([f.mont_mul(a[0], inv), f.neg(f.mont_mul(a[1], inv))])

    def batch_invert_any(self, a):
        flat = a.reshape(2, L, -1)
        return self.batch_invert(flat, axis=2).reshape(a.shape)

    # -- predicates -----------------------------------------------------------
    @staticmethod
    def eq(a, b):
        return (a == b).all(dim=1).all(dim=0)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=1).all(dim=0)

    @staticmethod
    def select(mask, a, b):
        """mask (*batch,) bool: where(mask, a, b)."""
        return torch.where(mask.reshape((1, 1) + mask.shape), a, b)
