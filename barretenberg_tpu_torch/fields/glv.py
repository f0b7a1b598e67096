"""GLV endomorphism scalar decomposition for the BN254 scalar field.

Host-side (numpy/int) implementation of the reference's
split_into_endomorphism_scalars (reference: fields/field.hpp:413-485):
decomposes k < r into (k1, k2) with k = k1 - k2*lambda (mod r) and
k1, k2 < 2^128. Used by MSM scalar preprocessing; it's O(n) integer
bit-twiddling, so it stays on host (the device consumes the resulting
digit arrays).
"""

from __future__ import annotations

import numpy as np

from .params import FR_MODULUS, FR_CUBE_ROOT, GLV_B2, GLV_G1, GLV_G2, GLV_MINUS_B1

_MASK128 = (1 << 128) - 1
_MASK256 = (1 << 256) - 1


def split_into_endomorphism_scalars(k: int) -> tuple[int, int]:
    """k (< r) -> (k1, k2), each < 2^128, with k1 - k2*lambda = k mod r."""
    r = FR_MODULUS
    c1 = (GLV_G2 * k) >> 256
    c2 = (GLV_G1 * k) >> 256
    q1 = (c1 * GLV_MINUS_B1) & _MASK256
    q2 = (c2 * GLV_B2) & _MASK256
    # Reference does these in mod-r field arithmetic (fr::__sub / __mul /
    # __add on the low 256-bit halves).
    t1 = (q2 - q1) % r
    t2 = (t1 * FR_CUBE_ROOT + k) % r
    return t2 & _MASK128, t1 & _MASK128


def split_batch(scalars) -> tuple[np.ndarray, np.ndarray]:
    """Vector of ints -> (k1, k2) object arrays (python ints)."""
    k1 = []
    k2 = []
    for k in scalars:
        a, b = split_into_endomorphism_scalars(int(k))
        k1.append(a)
        k2.append(b)
    return k1, k2
