"""K2: one fused radix-2 butterfly stage of the FFT over Fr, and K2b: a
range of stages in shared memory.

Both replace the JAX package's Pallas kernel ``kernels/butterfly.py``
``_stage_fn`` (public ``butterfly_stage``; K2b also the bit-reverse gather
and the scale multiplies around its stage loop in ``polynomials/fft.py``).
Source: ``csrc/butterfly.cu`` (+ ``csrc/field.cuh``).

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
power table (no per-stage copies). The FFT no longer calls it on the card:
K2b below runs its stages.

K2b ``fft_pass`` (same source): a range of stages [s0, s0 + b) of a whole
transform over a flat (18, n) array, on tiles held in shared memory - the
pass plan of ``polynomials/fft.py`` runs every FFT over Fr as one to three
of these launches instead of a gather, log2(n) K2 launches and up to two K1
scale multiplies. The pass that starts at stage 0 reads its input through
the bit reversal; a pass given a scale multiplies by it before its stages
(at the input index) or after them (at the output index).

What bounds it on the card: operations. A transform does log2(n) * n / 2
Montgomery multiplies; the array crosses device memory once per pass (144
bytes per element), which at 2^18 takes about a quarter of the time the
multiplies take. What the design does about it: a CTA holds 2^(b + cl)
elements (b stages' groups of 2^b, 2^cl neighbouring groups side by side so
that each limb row it reads or writes is 4 * 2^cl contiguous bytes) in the
9 x 30-bit register form, limb-major, and runs its b stages there between
``__syncthreads()``, so only the twiddle multiplies stay per stage.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import NUM_LIMBS, R_INTERNAL, FieldParams
from . import build
from .field_kernels import limb_field

L = NUM_LIMBS

# Kernel launches since the counters were last reset (reset_counts), and how
# many stage launches ran one butterfly.
launch_counts = {"stage": 0, "pass": 0}
single_lane_counts = {"stage": 0}

# The largest K2b tile, 2^12 elements (36 bytes each in shared memory: 144 KB
# of the 227 KB a CTA can have); csrc/butterfly.cu gets it with every launch.
MAX_TILE_LOG = 12


def reset_counts() -> None:
    for counts in (launch_counts, single_lane_counts):
        for op in counts:
            counts[op] = 0


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


@functools.cache
def bit_reverse_indices(log2n: int, device: torch.device) -> torch.Tensor:
    """(2^log2n,) int64 on `device`: i -> i with its log2n bits reversed."""
    idx = torch.arange(1 << log2n, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(log2n):
        rev |= ((idx >> b) & 1) << (log2n - 1 - b)
    return rev.to(device)


def plain_fft_pass(params: FieldParams, x, table, log2n: int, s0: int, stages: int, col_log: int,
                   scale=None, scale_const: int | None = None, scale_at_output: bool = False):
    """The plain PyTorch version of K2b (any device): the same stage range,
    bit-reversed read and scales, through K2's plain stage and the plain
    field ops. `col_log` only shapes the kernel's tiles; the values do not
    depend on it."""
    lf = limb_field(params)
    n = 1 << log2n

    def scaled(y):
        if scale is not None:
            y = lf.mont_mul(y, scale)
        if scale_const is not None:
            y = lf.mont_mul(y, lf.const_rows(scale_const, y[:, :1]))
        return y

    if not scale_at_output:
        x = scaled(x)
    if s0 == 0:
        x = x[:, bit_reverse_indices(log2n, x.device)]
    for s in range(s0, s0 + stages):
        h = 1 << s
        tw = table[:, :: n // (2 * h)][:, :h]
        x = plain(params, x.reshape(L, n // (2 * h), 2, h, 1), tw).reshape(L, n)
    if scale_at_output:
        x = scaled(x)
    return x


def _const_words(params: FieldParams, value: int) -> np.ndarray:
    """A field value as the kernel's 9 x 30-bit limbs, internal Montgomery form."""
    v = value % params.modulus * R_INTERNAL % params.modulus
    return np.array([(v >> (30 * k)) & ((1 << 30) - 1) for k in range(9)], dtype=np.uint32)


def _launch_pass(params, x, table, log2n, s0, stages, col_log, scale, scale_const, scale_at_output):
    n = 1 << log2n
    for name, t in (("x", x), ("table", table), ("scale", scale)):
        if t is not None and (t.dtype != torch.int32 or t.device != x.device or t.shape[0] != L):
            raise ValueError(f"fft_pass takes (18, .) int32 tensors on one CUDA device; {name} is "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if x.shape != (L, n) or table.shape[1] < max(1, n // 2) or (scale is not None and scale.shape != (L, n)):
        raise ValueError(f"fft_pass at n = 2^{log2n} takes x (18, n), table (18, >= n/2), scale (18, n); "
                         f"got {tuple(x.shape)}, {tuple(table.shape)}")
    cols = log2n - stages if s0 == 0 else s0
    if min(s0, stages, col_log) < 0 or s0 + stages > log2n or col_log > cols or stages + col_log > MAX_TILE_LOG:
        raise ValueError(f"fft_pass cannot run stages [{s0}, {s0 + stages}) with 2^{col_log} columns at n = 2^{log2n}")
    x = x.contiguous()
    out = torch.empty_like(x)
    words = None if scale_const is None else _const_words(params, scale_const)
    lib = build.get_lib("butterfly")
    with torch.cuda.device(x.device):
        err = lib.bb_fft_pass(
            x.data_ptr(), out.data_ptr(), n, log2n, table.data_ptr(), table.stride(0), table.stride(1),
            s0, stages, col_log, MAX_TILE_LOG,
            None if scale is None else scale.data_ptr(),
            0 if scale is None else scale.stride(0), 0 if scale is None else scale.stride(1),
            None if words is None else words.ctypes.data, int(scale_at_output),
            build.field_consts(params), build.current_stream(),
        )
    build.check(err, "fft_pass")
    launch_counts["pass"] += 1
    return out


def fft_pass(params: FieldParams, x, table, log2n: int, s0: int, stages: int, col_log: int,
             scale=None, scale_const: int | None = None, scale_at_output: bool = False):
    """Stages [s0, s0 + stages) of the radix-2 DIT FFT of x (18, 2^log2n),
    the pass that starts at stage 0 reading x through the bit reversal.
    table: (18, >= n/2) twiddle powers (any strides); 2^col_log groups per
    tile on the card. scale (18, n) and/or scale_const (a field value)
    multiply the elements before the stages (at the input index) or, with
    scale_at_output, after them (at the output index)."""
    if x.is_cuda:
        return _launch_pass(params, x, table, log2n, s0, stages, col_log, scale, scale_const, scale_at_output)
    return plain_fft_pass(params, x, table, log2n, s0, stages, col_log, scale, scale_const, scale_at_output)
