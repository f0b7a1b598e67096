"""Lane-wise Fq6 / Fq12 tower on torch tensors (reference: fields/field6.hpp,
field12.hpp).

Port of the JAX package's ``fields/tower.py``. Element layouts extend the
quadratic field's leading coordinate axis:
  Fq6  = Fq2[v]/(v^3 - xi): shape (3, 2, 18, *batch)
  Fq12 = Fq6[w]/(w^2 - v):  shape (2, 3, 2, 18, *batch)

Each op is the JAX package's formula over the lane-wise Fq2, so on the card
every base-field product is one K1 launch. The pairing does not run these
chains: its Miller loop and final exponentiation are one launch each of
the chain kernels K5a / K5b (kernels/pairing_kernels.py), built on the
same formulas in ``csrc/tower.cuh``. The host tower (pairing/tower.py)
stays the oracle; the Frobenius and xi-power constants come from it, put
into the internal Montgomery form (R' = 2^270) once per field.
"""

from __future__ import annotations

import torch

from ..pairing import tower as host_tower
from .quadratic import QuadraticField


class SexticField:
    """Fq6 over a lane-wise Fq2 (reference field6.hpp)."""

    def __init__(self, fq2: QuadraticField):
        self.fq2 = fq2
        self.p = fq2.p
        self.device = fq2.device
        # (2, 18, 1) columns of the Frobenius coefficients of c1 and c2
        self._frob = {
            k: (fq2.column(fq2.const(host_tower._FROB_C1[k])), fq2.column(fq2.const(host_tower._FROB_C2[k])))
            for k in (1, 2, 3)
        }

    # -- encoding -------------------------------------------------------------
    def encode(self, values) -> torch.Tensor:
        """List of (fq2, fq2, fq2) triples -> (3, 2, 18, N)."""
        return torch.stack([self.fq2.encode([v[i] for v in values]) for i in range(3)])

    def decode(self, a) -> list:
        return list(zip(*(self.fq2.decode(a[i]) for i in range(3))))

    def zeros(self, batch_shape):
        return torch.zeros((3, 2, 18, *batch_shape), dtype=torch.int32, device=self.device)

    # -- arithmetic (field6.hpp:44-195) ---------------------------------------
    def add(self, a, b):
        f = self.fq2
        return torch.stack([f.add(a[i], b[i]) for i in range(3)])

    def sub(self, a, b):
        f = self.fq2
        return torch.stack([f.sub(a[i], b[i]) for i in range(3)])

    def neg(self, a):
        f = self.fq2
        return torch.stack([f.neg(a[i]) for i in range(3)])

    def mul_xi(self, a2):
        """fq2 element * xi = (9 + i): (9 a0 - a1) + (9 a1 + a0) i, with
        9a = 8a + a (fq6.hpp __mul_by_non_residue)."""
        f = self.fq2.base
        c0 = f.sub(f.add(f.double(f.double(f.double(a2[0]))), a2[0]), a2[1])
        c1 = f.add(f.add(f.double(f.double(f.double(a2[1]))), a2[1]), a2[0])
        return torch.stack([c0, c1])

    def mul(self, a, b):
        """Toom/Karatsuba cubic mul (field6.hpp:44-124): six fq2 products."""
        f = self.fq2
        t0 = f.mul(a[0], b[0])
        t1 = f.mul(a[1], b[1])
        t2 = f.mul(a[2], b[2])
        c0 = f.add(t0, self.mul_xi(f.sub(f.mul(f.add(a[1], a[2]), f.add(b[1], b[2])), f.add(t1, t2))))
        c1 = f.add(f.sub(f.mul(f.add(a[0], a[1]), f.add(b[0], b[1])), f.add(t0, t1)), self.mul_xi(t2))
        c2 = f.add(f.sub(f.mul(f.add(a[0], a[2]), f.add(b[0], b[2])), f.add(t0, t2)), t1)
        return torch.stack([c0, c1, c2])

    def sqr(self, a):
        return self.mul(a, a)

    def mul_by_nonresidue(self, a):
        """a * v (field12.hpp mul_by_non_residue)."""
        return torch.stack([self.mul_xi(a[2]), a[0], a[1]])

    def invert(self, a):
        """(field6.hpp:184-228)."""
        f = self.fq2
        c0 = f.sub(f.sqr(a[0]), self.mul_xi(f.mul(a[1], a[2])))
        c1 = f.sub(self.mul_xi(f.sqr(a[2])), f.mul(a[0], a[1]))
        c2 = f.sub(f.sqr(a[1]), f.mul(a[0], a[2]))
        t = f.invert(f.add(f.mul(a[0], c0), self.mul_xi(f.add(f.mul(a[2], c1), f.mul(a[1], c2)))))
        return torch.stack([f.mul(c0, t), f.mul(c1, t), f.mul(c2, t)])

    def frobenius(self, a, k: int):
        """(field6.hpp:267-293): conjugate each fq2 coordinate (odd k) and
        scale c1 / c2 by the derived xi-power coefficients."""
        f = self.fq2
        conj = f.conjugate if k % 2 else (lambda x: x)
        c1_coeff, c2_coeff = self._frob[k]
        return torch.stack([conj(a[0]), f.mul(conj(a[1]), c1_coeff), f.mul(conj(a[2]), c2_coeff)])


class TwelfthField:
    """Fq12 over the lane-wise Fq6 (reference field12.hpp)."""

    def __init__(self, fq6: SexticField):
        self.fq6 = fq6
        self.fq2 = fq6.fq2
        self.p = fq6.p
        self.device = fq6.device
        self._frob_w = {k: self.fq2.column(self.fq2.const(host_tower._FROB_W[k])) for k in (1, 2, 3)}

    def encode(self, values) -> torch.Tensor:
        """List of tower fq12 values ((fq6), (fq6)) -> (2, 3, 2, 18, N)."""
        return torch.stack([self.fq6.encode([v[i] for v in values]) for i in range(2)])

    def decode(self, a) -> list:
        return list(zip(self.fq6.decode(a[0]), self.fq6.decode(a[1])))

    def one(self, batch_shape):
        f2 = self.fq2
        one2 = f2.full(batch_shape, f2.one)
        z2 = f2.zeros(batch_shape)
        return torch.stack([torch.stack([one2, z2, z2]), torch.stack([z2, z2, z2])])

    def mul(self, a, b):
        f = self.fq6
        t0 = f.mul(a[0], b[0])
        t1 = f.mul(a[1], b[1])
        c0 = f.add(t0, f.mul_by_nonresidue(t1))
        c1 = f.sub(f.mul(f.add(a[0], a[1]), f.add(b[0], b[1])), f.add(t0, t1))
        return torch.stack([c0, c1])

    def sqr(self, a):
        f = self.fq6
        t = f.mul(a[0], a[1])
        c0 = f.sub(
            f.mul(f.add(a[0], a[1]), f.add(a[0], f.mul_by_nonresidue(a[1]))),
            f.add(t, f.mul_by_nonresidue(t)),
        )
        return torch.stack([c0, f.add(t, t)])

    def conjugate(self, a):
        """Unitary inverse (field12.hpp:230)."""
        return torch.stack([a[0], self.fq6.neg(a[1])])

    def invert(self, a):
        f = self.fq6
        t = f.invert(f.sub(f.sqr(a[0]), f.mul_by_nonresidue(f.sqr(a[1]))))
        return torch.stack([f.mul(a[0], t), f.neg(f.mul(a[1], t))])

    def frobenius(self, a, k: int):
        """(field12.hpp:200-222)."""
        f6, f2 = self.fq6, self.fq2
        w_coeff = self._frob_w[k]
        c1 = f6.frobenius(a[1], k)
        c1 = torch.stack([f2.mul(c1[i], w_coeff) for i in range(3)])
        return torch.stack([f6.frobenius(a[0], k), c1])

    def cyclotomic_sqr(self, a):
        """Granger-Scott (field12.hpp:224), the host tower's coordinate
        mapping."""
        f2 = self.fq2
        x0, x1, x2 = a[0]
        x3, x4, x5 = a[1]
        mul_xi = self.fq6.mul_xi

        def two(x):
            return f2.add(x, x)

        t0 = f2.sqr(x4)
        t1 = f2.sqr(x0)
        t6 = f2.sub(f2.sqr(f2.add(x4, x0)), f2.add(t0, t1))
        t2 = f2.sqr(x2)
        t3 = f2.sqr(x3)
        t7 = f2.sub(f2.sqr(f2.add(x2, x3)), f2.add(t2, t3))
        t4 = f2.sqr(x5)
        t5 = f2.sqr(x1)
        t8 = mul_xi(f2.sub(f2.sqr(f2.add(x5, x1)), f2.add(t4, t5)))
        t0 = f2.add(mul_xi(t0), t1)
        t2 = f2.add(mul_xi(t2), t3)
        t4 = f2.add(mul_xi(t4), t5)
        z0 = f2.add(two(f2.sub(t0, x0)), t0)
        z1 = f2.add(two(f2.sub(t2, x1)), t2)
        z2 = f2.add(two(f2.sub(t4, x2)), t4)
        z3 = f2.add(two(f2.add(t8, x3)), t8)
        z4 = f2.add(two(f2.add(t6, x4)), t6)
        z5 = f2.add(two(f2.add(t7, x5)), t7)
        return torch.stack([torch.stack([z0, z1, z2]), torch.stack([z3, z4, z5])])

    def sparse_mul(self, a, o, vw, vv):
        """a * line, the line being the sparse element with fq6 coordinates
        c0 = (o, 0, vv), c1 = (0, vw, 0) (field12.hpp sparse_mul)."""
        f6, f2 = self.fq6, self.fq2
        z2 = f2.zeros(f2.batch_shape(o))
        b0 = torch.stack([o, z2, vv])
        b1 = torch.stack([z2, vw, z2])
        t0 = f6.mul(a[0], b0)
        t1 = f6.mul(a[1], b1)
        c0 = f6.add(t0, f6.mul_by_nonresidue(t1))
        c1 = f6.sub(f6.mul(f6.add(a[0], a[1]), f6.add(b0, b1)), f6.add(t0, t1))
        return torch.stack([c0, c1])
