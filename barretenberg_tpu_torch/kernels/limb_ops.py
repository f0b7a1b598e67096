"""Plain PyTorch limb arithmetic: the reference the CUDA kernels are held to.

Same values as the JAX package's ``kernels/limb_ops.py`` ``LimbField``
(canonical 18 x 15-bit planar limbs in, canonical limbs out; products are
``a * b * 2^-270 mod p``), but none of its schedule: that file's Karatsuba
split, biased columns and three-products-per-word grouping exist because
its target has 32-bit lanes only. Here limbs are stored as ``int32`` (a
canonical limb is < 2^15, so the bits equal the JAX package's uint32) and
all arithmetic runs in ``int64``, where a 15-bit product is 30 bits and an
18-term column sum 35 bits: no wrap-around trick is needed.

Carries are resolved exactly by packing three limbs into one 45-bit word
(270 bits = 6 words) and rippling over words, with the conditional
subtraction (or addition) of p carried along as a second candidate in the
same ripple; that keeps the number of tensor ops per field op small enough
for eager CPU tests.

These functions run on any device; the package calls them for CPU tensors
only (kernels/field_kernels.py, butterfly.py and point_kernels.py launch
the CUDA kernels for CUDA tensors).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..fields.limbs import int_to_limbs
from ..fields.params import LIMB_BITS, LIMB_MASK, NUM_LIMBS, R_INTERNAL, FieldParams

L = NUM_LIMBS
WORD_LIMBS = 3
WORD_BITS = WORD_LIMBS * LIMB_BITS  # 45
WORD_MASK = (1 << WORD_BITS) - 1
NWORDS = L // WORD_LIMBS  # 6


def _toeplitz(limbs, rows: int) -> torch.Tensor:
    """Host limb list c -> (rows, 18) int64 matrix T with T[k, i] = c[k - i],
    so that (T[:, :, None] * a[None]).sum(1) are the first `rows` product
    columns of a * c."""
    t = torch.zeros((rows, L), dtype=torch.int64)
    for k in range(rows):
        for i in range(L):
            if 0 <= k - i < len(limbs):
                t[k, i] = int(limbs[k - i])
    return t


# gather pattern of the per-lane product: column k takes b[k - i] (or the
# zero row appended at index 18) against a[i]
_PROD_IDX = torch.tensor(
    [[k - i if 0 <= k - i < L else L for i in range(L)] for k in range(2 * L - 1)]
)


def _relax(x: torch.Tensor) -> torch.Tensor:
    """One carry-save pass along axis 0; the carry out of the top is
    dropped (callers guarantee it is zero or want the value mod 2^(15k))."""
    hi = x >> LIMB_BITS
    x = x & LIMB_MASK
    x[1:] += hi[:-1]
    return x


_WEIGHTS = torch.tensor([1, 1 << LIMB_BITS, 1 << (2 * LIMB_BITS)], dtype=torch.int64)
_SHIFTS = torch.tensor([0, LIMB_BITS, 2 * LIMB_BITS], dtype=torch.int64)


class LimbField:
    """Field ops on (18, *batch) limb tensors (canonical form in/out)."""

    def __init__(self, params: FieldParams):
        self.params = params
        self.p = params.modulus
        self.p_limbs = [int(v) for v in int_to_limbs(self.p)]
        self.np_limbs = [int(v) for v in int_to_limbs(params.nprime_int)]
        self._p_words = torch.tensor(
            [(self.p >> (WORD_BITS * i)) & WORD_MASK for i in range(NWORDS)],
            dtype=torch.int64,
        )
        self._t_np = _toeplitz(self.np_limbs, L)  # low 18 columns only
        self._t_p = _toeplitz(self.p_limbs, 2 * L - 1)
        self._dev_cache: dict = {}

    # -- helpers --------------------------------------------------------
    def _consts(self, device, nd: int):
        """Per-device constant tensors, shaped to broadcast over nd dims."""
        key = (device, nd)
        c = self._dev_cache.get(key)
        if c is None:
            tail = (1,) * (nd - 1)
            c = {
                "t_np": self._t_np.to(device).reshape((L, L) + tail),
                "t_p": self._t_p.to(device).reshape((2 * L - 1, L) + tail),
                "idx": _PROD_IDX.to(device),
                "weights": _WEIGHTS.to(device).reshape((1, WORD_LIMBS) + tail),
                "shifts": _SHIFTS.to(device).reshape((1, WORD_LIMBS) + tail),
                # candidate offsets: [0, -p] in words, for the fused
                # conditional subtraction
                "minus_p": torch.stack(
                    [torch.zeros_like(self._p_words), -self._p_words], dim=1
                ).to(device).reshape((NWORDS, 2) + tail),
                "plus_p": torch.stack(
                    [torch.zeros_like(self._p_words), self._p_words], dim=1
                ).to(device).reshape((NWORDS, 2) + tail),
            }
            self._dev_cache[key] = c
        return c

    def const_rows(self, value: int, like: torch.Tensor) -> torch.Tensor:
        """Internal-Montgomery limbs of a field value, broadcast to the
        batch shape of `like` ((18, *batch))."""
        limbs = int_to_limbs((value % self.p) * R_INTERNAL % self.p)
        col = torch.tensor([int(v) for v in limbs], dtype=torch.int32, device=like.device)
        col = col.reshape((L,) + (1,) * (like.ndim - 1))
        return col.expand((L,) + like.shape[1:]).contiguous()

    @staticmethod
    def _pack(x: torch.Tensor, c) -> torch.Tensor:
        """(18, *batch) relaxed limbs -> (6, *batch) relaxed 45-bit words."""
        return (x.reshape((NWORDS, WORD_LIMBS) + x.shape[1:]) * c["weights"]).sum(dim=1)

    @staticmethod
    def _resolve(w: torch.Tensor, c, pick_negative: bool) -> torch.Tensor:
        """w: (6, 2, *batch) relaxed signed words of two candidates for the
        result (candidate 1 = candidate 0 -/+ p). Ripples both at once and
        returns the canonical int32 limbs of the one in [0, p): candidate 1
        unless it went negative (pick_negative=False: conditional subtract),
        or candidate 1 only if candidate 0 went negative (pick_negative=True:
        conditional add)."""
        digits = []
        carry = 0
        for i in range(NWORDS):
            v = w[i] + carry
            digits.append(v & WORD_MASK)
            carry = v >> WORD_BITS  # arithmetic: -1 when the value is negative
        d = torch.stack(digits)  # (6, 2, *batch)
        if pick_negative:
            use1 = carry[0] < 0
        else:
            use1 = carry[1] >= 0
        r = torch.where(use1.unsqueeze(0), d[:, 1], d[:, 0])
        limbs = (r.unsqueeze(1) >> c["shifts"]) & LIMB_MASK
        return limbs.reshape((L,) + r.shape[1:]).to(torch.int32)

    # -- multiplication -------------------------------------------------
    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
        nd = a.ndim
        c = self._consts(a.device, nd)
        # t = a*b in 35 carry-save columns, each < 18 * 2^30
        b0 = F.pad(b, [0, 0] * (nd - 1) + [0, 1])  # zero row at index 18
        t = (b0[c["idx"]] * a.unsqueeze(0)).sum(dim=1)
        # m = t * (-p^-1) mod 2^270: low 18 columns (each < 2^55), relaxed to
        # limbs <= 2^15 + 2^10 (three passes; the dropped top carry is the
        # reduction mod 2^270), so m < 2^270 * (1 + 2^-5)
        m = (c["t_np"] * t[:L].unsqueeze(0)).sum(dim=1)
        for _ in range(3):
            m = _relax(m)
        # s = t + m*p is divisible by 2^270 and s / 2^270 < 2p
        s = t + (c["t_p"] * m.unsqueeze(0)).sum(dim=1)
        s = _relax(F.pad(s, [0, 0] * (nd - 1) + [0, 1]))  # 36 limbs < 2^22
        # the low 18 limbs sum to a multiple of 2^270 whose quotient is the
        # carry into limb 18; everything below limb 17 contributes < 2^15 to
        # it, so the quotient is ceil(s[17] / 2^15)
        hi = s[L:].clone()
        hi[0] += (s[L - 1] + LIMB_MASK) >> LIMB_BITS
        w = self._pack(hi, c).unsqueeze(1) + c["minus_p"]
        return self._resolve(w, c, pick_negative=False)

    def sqr(self, a):
        return self.mont_mul(a, a)

    # -- additive ops ---------------------------------------------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
        c = self._consts(a.device, a.ndim)
        w = self._pack(a + b, c).unsqueeze(1) + c["minus_p"]
        return self._resolve(w, c, pick_negative=False)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
        c = self._consts(a.device, a.ndim)
        w = self._pack(a - b, c).unsqueeze(1) + c["plus_p"]
        return self._resolve(w, c, pick_negative=True)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    # -- predicates / select -------------------------------------------
    @staticmethod
    def is_zero(a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=0)

    @staticmethod
    def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=0)

    @staticmethod
    def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(mask.unsqueeze(0), a, b)
