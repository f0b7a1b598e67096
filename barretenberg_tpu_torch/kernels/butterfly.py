"""K2: one fused radix-2 butterfly stage of the FFT over Fr.

Replaces the JAX package's Pallas kernel ``kernels/butterfly.py``
``_stage_fn`` (public ``butterfly_stage``). Source: ``csrc/butterfly.cu``
(+ ``csrc/field.cuh``).

Layout contract (unchanged): the caller views the level array as
``x5 = (18, G, 2, h, nb)`` with h = 2^s the butterfly half-width and G the
block count; element (g, 0, t, lane) pairs with (g, 1, t, lane), and the
outputs land at the same positions. Any G, h, nb >= 1 is taken, including
nb = 1 (a flat stage over an (18, n) array).

What bounds it on the card: bytes. A stage reads and writes the array once
(144 bytes per element) and does one Montgomery multiply (342 32-bit
multiply-adds) per pair of elements - a quarter of the time the bytes take.
What the design does about it: one thread per butterfly does multiply, add
and subtract in registers, so a stage is exactly one pass over the array;
the stage twiddles are read through strides straight from the domain's
power table (no per-stage copies). A whole transform is still log2(n)
passes: fusing several stages in shared memory is later work.
"""

from __future__ import annotations

import torch

from ..fields.params import NUM_LIMBS, FieldParams
from . import build
from .field_kernels import limb_field

L = NUM_LIMBS

# Kernel launches since the counters were last reset (reset_counts), and how
# many of them ran one butterfly.
launch_counts = {"stage": 0}
single_lane_counts = {"stage": 0}


def reset_counts() -> None:
    launch_counts["stage"] = 0
    single_lane_counts["stage"] = 0


def plain(params: FieldParams, x5: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the stage (any device)."""
    lf = limb_field(params)
    _, _, _, h, _ = x5.shape
    e, o = x5[:, :, 0], x5[:, :, 1]  # (18, G, h, nb)
    t = lf.mont_mul(o, tw.reshape(L, 1, h, 1))
    return torch.stack([lf.add(e, t), lf.sub(e, t)], dim=2)


def _launch(params: FieldParams, x5: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    _, g, two, h, nb = x5.shape
    if x5.dtype != torch.int32 or tw.dtype != torch.int32 or not tw.is_cuda:
        raise ValueError("butterfly kernel takes int32 CUDA tensors")
    if x5.shape[0] != L or two != 2 or tw.shape != (L, h) or tw.device != x5.device:
        raise ValueError(
            f"butterfly kernel takes x5 (18, G, 2, h, nb) and tw (18, h), got {tuple(x5.shape)} and {tuple(tw.shape)}"
        )
    x5 = x5.contiguous()
    out = torch.empty_like(x5)
    lib = build.get_lib("butterfly")
    with torch.cuda.device(x5.device):
        err = lib.bb_butterfly_stage(
            x5.data_ptr(), tw.data_ptr(), tw.stride(0), tw.stride(1),
            out.data_ptr(), g, h, nb, build.field_consts(params), build.current_stream(),
        )
    build.check(err, "butterfly_stage")
    launch_counts["stage"] += 1
    if g * h * nb == 1:
        single_lane_counts["stage"] += 1
    return out


def butterfly_stage(params: FieldParams, x5: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """x5: (18, G, 2, h, nb) stage view; tw: (18, h) stage twiddles (any
    strides). Returns the butterfly outputs in the same view."""
    if x5.is_cuda:
        return _launch(params, x5, tw)
    return plain(params, x5, tw)
