"""State carried across from the JAX package.

The JAX package holds field elements as ``(18, n)`` uint32 limb arrays,
points as ``(x, y, inf)`` tuples of such arrays, and a prover fixture as a
handful of them. These functions take that state as numpy arrays and return
this package's objects on a chosen device, so that both packages compute on
the same data. Nothing here imports the JAX package: callers pass
``numpy.asarray(...)`` of what it holds.

A canonical limb is < 2^15, so the uint32 -> int32 change of dtype keeps
every bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .fields.params import LIMB_BITS, NUM_LIMBS
from .groups import AffinePoints, JacobianPoints
from .plonk.prover import Prover
from .plonk.widgets import (
    ProverArithmeticWidget,
    ProverBoolWidget,
    ProverMiMCWidget,
    ProverSequentialWidget,
)
from .srs import ReferenceString


def _limb_tensor(limbs, lead: tuple, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(limbs))
    want = (*lead, NUM_LIMBS)
    if arr.shape[: len(want)] != want:
        raise ValueError(f"expected leading axes {want} (coordinates, then limbs), got {arr.shape}")
    if arr.size and int(arr.max()) >> LIMB_BITS:
        raise ValueError("limbs are not canonical (a limb is >= 2^15)")
    return torch.from_numpy(arr.astype(np.int32)).to(resolve_device(device))


def field_tensor(limbs, device=None) -> torch.Tensor:
    """(18, *batch) uint32 limb array -> int32 field tensor on `device`."""
    return _limb_tensor(limbs, (), device)


def fq2_tensor(limbs, device=None) -> torch.Tensor:
    """(2, 18, *batch) uint32 Fq2 array (the JAX package's
    fields/quadratic.py layout) -> int32 tensor on `device`."""
    return _limb_tensor(limbs, (2,), device)


def fq6_tensor(limbs, device=None) -> torch.Tensor:
    """(3, 2, 18, *batch) Fq6 array -> int32 tensor on `device`."""
    return _limb_tensor(limbs, (3, 2), device)


def fq12_tensor(limbs, device=None) -> torch.Tensor:
    """(2, 3, 2, 18, *batch) Fq12 array -> int32 tensor on `device`."""
    return _limb_tensor(limbs, (2, 3, 2), device)


def field_array(t: torch.Tensor) -> np.ndarray:
    """Field tensor -> (18, *batch) uint32 numpy array (the JAX layout)."""
    return t.cpu().numpy().astype(np.uint32)


def _mask(inf, device) -> torch.Tensor:
    return torch.from_numpy(np.array(inf, dtype=bool)).to(resolve_device(device))


def affine_points(x, y, inf, device=None) -> AffinePoints:
    return AffinePoints(field_tensor(x, device), field_tensor(y, device), _mask(inf, device))


def jacobian_points(x, y, z, inf, device=None) -> JacobianPoints:
    return JacobianPoints(
        field_tensor(x, device), field_tensor(y, device), field_tensor(z, device),
        _mask(inf, device),
    )


def g2_affine_points(x, y, inf, device=None) -> AffinePoints:
    """G2 affine points from the JAX package's (2, 18, n) coordinate arrays."""
    return AffinePoints(fq2_tensor(x, device), fq2_tensor(y, device), _mask(inf, device))


def g2_jacobian_points(x, y, z, inf, device=None) -> JacobianPoints:
    return JacobianPoints(fq2_tensor(x, device), fq2_tensor(y, device), fq2_tensor(z, device), _mask(inf, device))


def reference_string(mono_x, mono_y, mono_inf, g2_x, device=None) -> ReferenceString:
    """A ReferenceString from the monomials' limb arrays and the host G2
    point [tau]G2 = ((x0, x1), (y0, y1))."""
    monomials = affine_points(mono_x, mono_y, mono_inf, device)
    return ReferenceString(monomials, g2_x, monomials.x.shape[1])


def prover_from_arrays(
    n: int,
    srs: ReferenceString,
    wires,
    selectors,
    sigma_mappings,
    *,
    q_oo=None,
    bool_selectors=None,
    mimc_selectors=None,
) -> Prover:
    """A whole prover fixture on the SRS's device.

    wires: (w_l, w_r, w_o) evaluation-form limb arrays; selectors: (q_m, q_l,
    q_r, q_o, q_c) limb arrays; sigma_mappings: three uint32 (n,) arrays in
    the composer encoding. The optional selectors add widgets in the order
    the composers give them (arithmetic, sequential, bool, MiMC), which fixes
    each widget's alpha powers: q_oo the sequential widget's q_o_next;
    bool_selectors (q_bl, q_br, q_bo); mimc_selectors (q_mimc_selector,
    q_mimc_coefficient)."""
    device = srs.monomials.x.device
    prover = Prover(n, srs)
    prover.w_l, prover.w_r, prover.w_o = (field_tensor(w, device) for w in wires)
    (
        prover.sigma_1_mapping,
        prover.sigma_2_mapping,
        prover.sigma_3_mapping,
    ) = (np.asarray(m, dtype=np.uint32) for m in sigma_mappings)
    prover.widgets.append(
        ProverArithmeticWidget(*(field_tensor(q, device) for q in selectors))
    )
    if q_oo is not None:
        prover.widgets.append(ProverSequentialWidget(field_tensor(q_oo, device)))
    if bool_selectors is not None:
        prover.widgets.append(ProverBoolWidget(*(field_tensor(q, device) for q in bool_selectors)))
    if mimc_selectors is not None:
        prover.widgets.append(ProverMiMCWidget(*(field_tensor(q, device) for q in mimc_selectors)))
    return prover
