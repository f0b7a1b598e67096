"""Prime-field arithmetic on torch tensors: parameters, limb conversions and
the ``Field`` class. ``fr(device)`` / ``fq(device)`` return the one cached
instance per device (default: the CUDA card)."""

from __future__ import annotations

import functools

from ..config import resolve_device
from .montgomery import Field
from .params import FQ_PARAMS, FR_PARAMS, FieldParams


@functools.lru_cache(maxsize=None)
def _field(params: FieldParams, device) -> Field:
    return Field(params, device)


def fr(device=None) -> Field:
    """The BN254 scalar field on `device`."""
    return _field(FR_PARAMS, resolve_device(device))


def fq(device=None) -> Field:
    """The BN254 base field on `device`."""
    return _field(FQ_PARAMS, resolve_device(device))


__all__ = ["Field", "FieldParams", "FQ_PARAMS", "FR_PARAMS", "fq", "fr"]
