"""K1: lane-wise field multiplication, squaring, addition and subtraction,
and ``pow``: a whole square-and-multiply chain in one launch.

Replaces the JAX package's Pallas kernel ``kernels/field_kernels.py``
``_mul_fn`` (public ``mont_mul``, ``sqr``, ``add``, ``sub``) and, for
``pow``, the ``lax.scan`` of ``sqr``/``mont_mul`` steps of its
``Field.pow_static`` (``fields/montgomery.py:535-566``), which ``invert``
and ``batch_invert`` run once per Fermat inversion. Source:
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

``pow`` is bound by neither: on the main path it inverts one lane (253
squarings and 109 (Fq) or 126 (Fr) multiplications for a Fermat inversion),
so what sets its time is the dependent chain of Montgomery products on one
thread, each waiting for the last. What the design does about it: the chain
runs in one launch instead of one launch per step (362-379 host round trips
per inversion before), with the accumulator in registers; the exponent
arrives by value (no device copy) and every lane reads the same bit, so
lanes never diverge.

A CUDA tensor always launches the kernel (or raises); a CPU tensor always
takes the plain version (``limb_ops.LimbField``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import NUM_LIMBS, FieldParams
from . import build
from .limb_ops import LimbField

L = NUM_LIMBS
_OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3}
EXP_WORDS = 8  # csrc/field_kernels.cu: pow takes exponents of up to 256 bits

# Kernel launches per op since the counters were last reset (reset_counts),
# and how many of them ran one lane.
launch_counts = {op: 0 for op in (*_OPS, "pow")}
single_lane_counts = dict.fromkeys(launch_counts, 0)


def reset_counts() -> None:
    for counts in (launch_counts, single_lane_counts):
        for op in counts:
            counts[op] = 0


def _count(op: str, lanes: int) -> None:
    launch_counts[op] += 1
    if lanes == 1:
        single_lane_counts[op] += 1


@functools.cache
def limb_field(params: FieldParams) -> LimbField:
    return LimbField(params)


def plain(params: FieldParams, op: str, a, b=None):
    """The plain PyTorch version of the kernel (any device)."""
    lf = limb_field(params)
    if op == "sqr":
        return lf.sqr(a)
    return {"mul": lf.mont_mul, "add": lf.add, "sub": lf.sub}[op](a, b)


def plain_pow(params: FieldParams, a, exponent: int):
    """The plain PyTorch version of ``pow`` (any device): square-and-multiply
    over the exponent's bits, MSB first, starting from `a` at the first
    (set) bit. a^0 = one; 0^e = 0 for e > 0."""
    if exponent < 0:
        raise ValueError("pow takes a non-negative exponent")
    lf = limb_field(params)
    if exponent == 0:
        return lf.const_rows(1, a)
    nbits = exponent.bit_length()
    acc = a
    for i in range(1, nbits):
        acc = lf.sqr(acc)
        if (exponent >> (nbits - 1 - i)) & 1:
            acc = lf.mont_mul(acc, a)
    return acc


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
    _count(op, n)
    return out.reshape(shape)


def _launch_pow(params: FieldParams, a, exponent: int):
    if exponent < 0 or exponent.bit_length() > 32 * EXP_WORDS:
        raise ValueError(f"pow kernel takes exponents in [0, 2^{32 * EXP_WORDS}), got {exponent}")
    shape = a.shape
    if a.ndim != 2:
        a = a.reshape(L, -1)
    if a.dtype != torch.int32 or not a.is_cuda or a.shape[0] != L:
        raise ValueError(f"pow kernel takes an (18, n) int32 CUDA tensor, got {tuple(a.shape)} {a.dtype} on {a.device}")
    n = a.shape[1]
    words = np.array([(exponent >> (32 * k)) & 0xFFFFFFFF for k in range(EXP_WORDS)], dtype=np.uint32)
    out = torch.empty((L, n), dtype=torch.int32, device=a.device)
    lib = build.get_lib("field_kernels")
    with torch.cuda.device(a.device):
        err = lib.bb_field_pow(
            a.data_ptr(), a.stride(0), a.stride(1), out.data_ptr(), n,
            words.ctypes.data, exponent.bit_length(), build.field_consts(params), build.current_stream(),
        )
    build.check(err, "field_pow")
    _count("pow", n)
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


def pow_static(params: FieldParams, a, exponent: int):
    """a^exponent per lane for a host-known exponent (< 2^256 on the card)."""
    if a.is_cuda:
        return _launch_pow(params, a, exponent)
    return plain_pow(params, a, exponent)
