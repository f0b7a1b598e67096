"""Vectorized Montgomery prime-field arithmetic on torch tensors.

A field element is 18 limbs of 15 bits stored as ``int32`` (canonical limbs
are < 2^15, the same bits as the JAX package's uint32), planar: element
tensors have shape ``(18, *batch)``, ``(18, 1)`` tensors broadcast against
batches. All ops keep elements canonical (< p, normalized limbs). The
external (serialized) representation is the reference library's Montgomery
form with R = 2^256; internally R' = 2^270, and ``u -> u * 2^14 mod p``
converts between them homomorphically (params.py).

A ``Field`` holds its constant tensors on one explicit device. Arithmetic
goes through the ops of kernels/field_kernels.py - ``mul``, ``sqr``,
``add``, ``sub``, ``pow``, ``scan``, ``dot`` and ``lincomb`` - which launch
the CUDA kernel for a CUDA tensor and run the plain PyTorch version for a
CPU tensor; ``sqrt`` is one ``pow``; ``neg``,
``double``, ``mul_by_constant``, every broadcast product and the scans
(``prefix_product``, ``affine_scan``) are expressed through those, so no
field arithmetic on the card runs as a chain of eager limb ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..kernels import field_kernels
from .limbs import int_to_limbs, ints_to_limbs, limbs_to_ints
from .params import NUM_LIMBS, R_EXTERNAL, R_INTERNAL, FieldParams

L = NUM_LIMBS


class Field:
    """A prime field instance whose constants live on `device`."""

    def __init__(self, params: FieldParams, device=None):
        self.params = params
        self.p = params.modulus
        self.device = resolve_device(device)
        self.one = self.const(1)
        self.zero = self.const(0)
        self._one_col = self.one.reshape(L, 1)
        self._zero_col = self.zero.reshape(L, 1)
        self.modulus_limbs = self._tensor(int_to_limbs(self.p))
        # raw-integer multipliers (see to_montgomery_form / to_plain)
        self._to_internal_raw = self._tensor(
            int_to_limbs((R_INTERNAL * R_EXTERNAL) % self.p)
        ).reshape(L, 1)
        self._one_raw = self._tensor(int_to_limbs(1 << 14)).reshape(L, 1)
        self._one_plain = self._tensor(int_to_limbs(1)).reshape(L, 1)

    def _tensor(self, limbs: np.ndarray) -> torch.Tensor:
        """uint32 numpy limbs -> int32 tensor on this field's device."""
        return torch.from_numpy(np.ascontiguousarray(limbs).astype(np.int32)).to(self.device)

    # ------------------------------------------------------------------
    # Encoding
    # ------------------------------------------------------------------
    def const(self, value: int) -> torch.Tensor:
        """Python int (a field *value*) -> internal-Montgomery (18,) tensor."""
        return self._tensor(int_to_limbs((value % self.p) * R_INTERNAL % self.p))

    def encode(self, values) -> torch.Tensor:
        """List of field values (any ints, reduced mod p) -> internal-Montgomery
        (18, N) tensor: one Python product per value, the limbs cut out by
        numpy (``ints_to_limbs``)."""
        p, r = self.p, R_INTERNAL % self.p
        return self._tensor(ints_to_limbs([v % p * r % p for v in map(int, values)]))

    def decode(self, limbs: torch.Tensor) -> list[int]:
        """Internal-Montgomery (18, *batch) -> list of field values (copies
        to the host)."""
        r_inv = self.params.r_int_inv
        return [v * r_inv % self.p for v in limbs_to_ints(limbs.cpu().numpy())]

    def encode_montgomery(self, raw_values) -> torch.Tensor:
        """256-bit ints already in the reference's R=2^256 Montgomery form
        -> internal representation (multiplies by 2^14 mod p)."""
        vals = [(int(v) << 14) % self.p for v in raw_values]
        return self._tensor(ints_to_limbs(vals))

    def decode_montgomery(self, limbs: torch.Tensor) -> list[int]:
        """Internal representation -> reference R=2^256 Montgomery integers."""
        inv = pow(1 << 14, -1, self.p)
        return [v * inv % self.p for v in limbs_to_ints(limbs.cpu().numpy())]

    # ------------------------------------------------------------------
    # Shape helpers
    # ------------------------------------------------------------------
    def zeros(self, batch_shape) -> torch.Tensor:
        return torch.zeros((L, *batch_shape), dtype=torch.int32, device=self.device)

    def full(self, batch_shape, scalar_limbs: torch.Tensor) -> torch.Tensor:
        """A materialised (18, *batch) tensor filled with one element."""
        col = scalar_limbs.reshape((L,) + (1,) * len(batch_shape))
        return col.expand((L, *batch_shape)).contiguous()

    # ------------------------------------------------------------------
    # Arithmetic: the four kernel ops and what is built from them
    # ------------------------------------------------------------------
    def mont_mul(self, a, b):
        """Montgomery product a * b * 2^-270 mod p, canonical output."""
        return field_kernels.mont_mul(self.params, a, b)

    mul = mont_mul

    def sqr(self, a):
        return field_kernels.sqr(self.params, a)

    def add(self, a, b):
        return field_kernels.add(self.params, a, b)

    def sub(self, a, b):
        return field_kernels.sub(self.params, a, b)

    def _col_for(self, col: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        return col.reshape((L,) + (1,) * (a.ndim - 1))

    def neg(self, a):
        return self.sub(self._col_for(self._zero_col, a), a)  # 0 - 0 = 0

    def double(self, a):
        return self.add(a, a)

    def mul_by_constant(self, a, value: int):
        """Multiply by a field *value* (host int) via one broadcast mont_mul."""
        return self.mont_mul(a, self._col_for(self.const(value), a))

    def dot(self, rows, table):
        """(18, B): each of B (18, n) rows times the (18, n) `table` lane by
        lane, summed - a batch of evaluations against one power table, one
        launch of K1's ``dot`` per ``DOT_MAX_ROWS`` rows on the card."""
        return field_kernels.dot(self.params, rows, table)

    def linear_combination(self, polys, scalars):
        """(18, n): sum_j scalars[j] polys[j] for host-int field values - one
        launch of K1's ``lincomb`` per ``LINCOMB_MAX_TERMS`` terms on the
        card."""
        return field_kernels.linear_combination(self.params, polys, scalars)

    # ------------------------------------------------------------------
    # Montgomery form conversion (external R = 2^256 semantics)
    # ------------------------------------------------------------------
    def to_montgomery_form(self, a):
        """Matches the reference's __to_montgomery_form: treats the input as
        a raw integer and multiplies in R = 2^256."""
        return self.mont_mul(a, self._col_for(self._to_internal_raw, a))

    def from_montgomery_form(self, a):
        return self.mont_mul(a, self._col_for(self._one_raw, a))

    def to_plain(self, a):
        """Internal-Montgomery -> plain canonical limbs of the *value* (for
        bit extraction: scalar digits, signed windows, serialization)."""
        return self.mont_mul(a, self._col_for(self._one_plain, a))

    # ------------------------------------------------------------------
    # Predicates
    # ------------------------------------------------------------------
    @staticmethod
    def eq(a, b):
        return (a == b).all(dim=0)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=0)

    @staticmethod
    def select(mask, a, b):
        """mask (*batch,) bool: where(mask, a, b)."""
        return torch.where(mask.unsqueeze(0), a, b)

    # ------------------------------------------------------------------
    # Exponentiation and inversion
    # ------------------------------------------------------------------
    def pow_static(self, a, exponent: int):
        """a^exponent for a host-known integer exponent: square & multiply
        over the exponent bits, MSB first - one launch of K1's ``pow`` on the
        card, its plain version on the CPU. a^0 = one; 0^e = 0 for e > 0."""
        return field_kernels.pow_static(self.params, a, exponent)

    def invert(self, a):
        """Fermat inversion a^(p-2); maps 0 -> 0 (reference pow semantics)."""
        return self.pow_static(a, self.p - 2)

    def sqrt(self, a):
        """a^((p+1)/4), one launch of K1's ``pow`` on the card: a square root
        of every quadratic residue, valid for p = 3 mod 4 (BN254 Fq, the only
        field the reference takes roots in, for hash_to_curve). Use
        ``sqrt_host`` for p = 1 mod 4."""
        if self.p % 4 != 3:
            raise NotImplementedError(
                f"device sqrt requires p = 3 mod 4; use sqrt_host for {self.params.name}"
            )
        return self.pow_static(a, (self.p + 1) // 4)

    def sqrt_host(self, value: int) -> int | None:
        """Tonelli-Shanks on host ints; returns None for non-residues."""
        p = self.p
        value %= p
        if value == 0:
            return 0
        if pow(value, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(value, (p + 1) // 4, p)
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(value, q, p), pow(value, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r

    def batch_invert(self, a, dim: int = 1):
        """Montgomery batch inversion along a batch dim: two prefix-product
        scans and one Fermat inversion of the total. Zero entries map to
        garbage (as in the reference); callers mask them out."""
        mul = self.mont_mul
        n = a.shape[dim]
        prefix = self.prefix_product(a, dim)
        total_inv = self.invert(prefix.narrow(dim, n - 1, 1))
        suffix = self.prefix_product(a, dim, reverse=True)
        # inv_i = prefix_{i-1} * suffix_{i+1} * total_inv
        ones_shape = list(a.shape)
        ones_shape[dim] = 1
        ones = self._col_for(self._one_col, a).expand(ones_shape)
        pre = torch.cat([ones, prefix.narrow(dim, 0, n - 1)], dim=dim)
        suf = torch.cat([suffix.narrow(dim, 1, n - 1), ones], dim=dim)
        return mul(mul(pre, suf), total_inv)

    # ------------------------------------------------------------------
    # Scans: one launch of K1's scan on the card, the Hillis-Steele loops of
    # utils/scans.py on the CPU
    # ------------------------------------------------------------------
    def prefix_product(self, a, dim: int = 1, reverse: bool = False):
        """Inclusive prefix (suffix if reverse) product along batch dim `dim`."""
        return field_kernels.prefix_product(self.params, a, dim, reverse)

    def affine_scan(self, m, b, dim: int = 1):
        """The affine recurrence d_i = m_i d_{i-1} + b_i (d_0 = b_0) along
        batch dim `dim`; m broadcasts against b (m_0 is never read)."""
        return field_kernels.affine_scan(self.params, m, b, dim)

    # ------------------------------------------------------------------
    # Misc
    # ------------------------------------------------------------------
    def random_elements(self, n: int, rng: np.random.Generator) -> torch.Tensor:
        """Seeded host-side sampling of canonical elements, internal form:
        each element 32 little-endian bytes of `rng` mod p, the JAX
        package's values. One draw of 32 n bytes is the stream (and leaves
        the generator's state) of n draws of 32 - each a whole number of
        the generator's 64-bit outputs - at a fraction of the calls."""
        raw = rng.bytes(32 * n)
        vals = [int.from_bytes(raw[i : i + 32], "little") % self.p for i in range(0, 32 * n, 32)]
        return self.encode(vals)

    def get_root_of_unity(self, degree: int) -> int:
        """Value of the 2^degree-th root of unity. Host int."""
        r = self.params.primitive_root
        for _ in range(self.params.primitive_root_log_size - degree):
            r = r * r % self.p
        return r
