"""K1: lane-wise field multiplication, squaring, addition and subtraction.

Replaces the JAX package's Pallas kernel ``kernels/field_kernels.py``
``_mul_fn`` (public ``mont_mul``, ``sqr``, ``add``, ``sub``). Source:
``csrc/field_kernels.cu`` (+ ``csrc/field.cuh``).

What bounds it on the card: bytes. ``mul``/``add``/``sub`` move 216 bytes
per element (two 18 x 4-byte operands in, one out; ``sqr`` 144); ``mul``
does 171 32x32->64-bit multiplies (342 32-bit multiply-adds) per element,
which at the card's integer issue rate takes about a third of the time the
bytes take at its memory rate (chip_smoke.py reckons both). What the design
does about it: one thread per lane keeps the whole multiply in registers -
9 x 30-bit limbs, 64-bit accumulators - so every operand is read once and
the result written once, with neighbouring threads on neighbouring
addresses of each limb row; operands are addressed by strides, so a
broadcast ``(18, 1)`` constant or a strided slice costs no materialised
copy (and a broadcast operand no device-memory traffic at all).

A CUDA tensor always launches the kernel (or raises); a CPU tensor always
takes the plain version (``limb_ops.LimbField``).
"""

from __future__ import annotations

import functools

import torch

from ..fields.params import NUM_LIMBS, FieldParams
from . import build
from .limb_ops import LimbField

L = NUM_LIMBS
_OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3}

# Kernel launches per op since the counters were last reset (reset_counts).
launch_counts = {op: 0 for op in _OPS}


def reset_counts() -> None:
    for op in launch_counts:
        launch_counts[op] = 0


@functools.cache
def limb_field(params: FieldParams) -> LimbField:
    return LimbField(params)


def plain(params: FieldParams, op: str, a, b=None):
    """The plain PyTorch version of the kernel (any device)."""
    lf = limb_field(params)
    if op == "sqr":
        return lf.sqr(a)
    return {"mul": lf.mont_mul, "add": lf.add, "sub": lf.sub}[op](a, b)


def _launch(params: FieldParams, op: str, a, b):
    if b is None:
        b = a
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    if a.ndim != 2:
        a, b = a.reshape(L, -1), b.reshape(L, -1)
    for t in (a, b):
        if t.dtype != torch.int32 or not t.is_cuda or t.shape[0] != L:
            raise ValueError(
                f"field kernel takes (18, n) int32 CUDA tensors, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if b.device != a.device:
        raise ValueError("field kernel operands lie on different devices")
    n = a.shape[1]
    out = torch.empty((L, n), dtype=torch.int32, device=a.device)
    lib = build.get_lib("field_kernels")
    with torch.cuda.device(a.device):
        err = lib.bb_field_op(
            _OPS[op],
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1),
            out.data_ptr(), n, build.field_consts(params), build.current_stream(),
        )
    build.check(err, f"field_op[{op}]")
    launch_counts[op] += 1
    return out.reshape(shape)


def _dispatch(params, op, a, b=None):
    if a.is_cuda:
        return _launch(params, op, a, b)
    return plain(params, op, a, b)


def mont_mul(params: FieldParams, a, b):
    return _dispatch(params, "mul", a, b)


def sqr(params: FieldParams, a):
    return _dispatch(params, "sqr", a)


def add(params: FieldParams, a, b):
    return _dispatch(params, "add", a, b)


def sub(params: FieldParams, a, b):
    return _dispatch(params, "sub", a, b)
