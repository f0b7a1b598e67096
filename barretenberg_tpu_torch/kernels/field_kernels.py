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

``scan`` replaces the ``fori_loop`` of ``_mul_fn`` (and of ``add``) in
``utils/scans.py:19-62`` (``hillis_scan``, ``affine_scan``): an inclusive
prefix or suffix product, or the affine recurrence d_i = m_i d_{i-1} + b_i,
along each row of an ``(18, rows, n)`` array. The port ran those loops
eagerly, each of their log2(n) levels a ``roll``, a mask, a ``where`` and
one or three K1 launches: 16-18 levels of host launch path per scan at the
prove's sizes, n log2 n products. What bounds the kernel on the card:
bytes and operations about equally - 72 bytes in and out per element and
about 2n products (3n for the recurrence), ~3 us each at 2^16. What the
design does about it: one launch runs the whole scan with about 2n
products (``csrc/field_kernels.cu``): each CTA loads a tile of 1,024
elements into shared memory, each thread scans 8 consecutive ones in
registers, the thread totals are scanned across the warp by shuffles and
across the CTA by one thread, and the tiles chain by decoupled look-back
(each tile publishes its total at once and its inclusive prefix when it
has it; warp 0 folds up to 32 earlier tiles per step). Field products and
sums are exact and canonical, so any grouping gives the plain version's
limbs bit for bit, ``batch_invert``'s values at zero entries included.

A CUDA tensor always launches the kernel (or raises); a CPU tensor always
takes the plain version (``limb_ops.LimbField``; for ``scan``, the
Hillis-Steele loops of ``utils/scans.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import NUM_LIMBS, FieldParams
from ..utils import scans
from . import build
from .limb_ops import LimbField

L = NUM_LIMBS
_OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3}
EXP_WORDS = 8  # csrc/field_kernels.cu: pow takes exponents of up to 256 bits
SCAN_TILE = 1024  # csrc/field_kernels.cu SCAN_TILE: elements per CTA of scan
SCAN_WORDS_PER_TILE = 1 + 4 * 9  # a tile's flag, total and inclusive prefix
_SCAN_MODES = {"prod": 0, "affine": 1}

# Kernel launches per op since the counters were last reset (reset_counts),
# and how many of them ran one lane.
launch_counts = {op: 0 for op in (*_OPS, "pow", "scan")}
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


def plain_prefix_product(params: FieldParams, a, dim: int, reverse: bool = False):
    """The plain PyTorch version of ``scan``'s product (any device): the
    Hillis-Steele levels of ``utils/scans.py``."""
    return scans.hillis_scan(limb_field(params).mont_mul, a, dim, reverse)


def plain_affine_scan(params: FieldParams, m, b, dim: int):
    """The plain PyTorch version of ``scan``'s affine recurrence (any
    device); m and b have one shape."""
    lf = limb_field(params)
    return scans.affine_scan(lf.mont_mul, lf.add, m, b, dim)


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


def _scan_rows(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` with `dim` moved last, as an (18, rows, n) view (a copy only if
    its batch dims do not flatten)."""
    if t.dtype != torch.int32 or not t.is_cuda or t.shape[0] != L or dim % t.ndim == 0:
        raise ValueError(
            f"scan kernel takes (18, ..., n) int32 CUDA tensors scanned along a batch dim, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}, dim {dim}"
        )
    t = t.movedim(dim, -1)
    return t.unsqueeze(1) if t.ndim == 2 else t if t.ndim == 3 else t.reshape(L, -1, t.shape[-1])


def _launch_scan(params: FieldParams, mode: str, a, b, dim: int, reverse: bool):
    moved = a.movedim(dim, -1).shape
    a3 = _scan_rows(a, dim)
    b3 = a3 if b is None else _scan_rows(b, dim)
    if b3.device != a3.device or b3.shape != a3.shape:
        raise ValueError("scan kernel operands differ in device or shape")
    _, rows, n = a3.shape
    out = torch.empty((L, rows, n), dtype=torch.int32, device=a.device)
    words = 1 + rows * -(-n // SCAN_TILE) * SCAN_WORDS_PER_TILE
    state = torch.empty(words, dtype=torch.int32, device=a.device)
    lib = build.get_lib("field_kernels")
    with torch.cuda.device(a.device):
        err = lib.bb_field_scan(
            _SCAN_MODES[mode], int(reverse),
            a3.data_ptr(), a3.stride(0), a3.stride(1), a3.stride(2),
            b3.data_ptr(), b3.stride(0), b3.stride(1), b3.stride(2),
            out.data_ptr(), rows, n, state.data_ptr(), words, build.field_consts(params), build.current_stream(),
        )
    build.check(err, f"field_scan[{mode}]")
    _count("scan", n)
    return out.reshape(moved).movedim(-1, dim)


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


def prefix_product(params: FieldParams, a, dim: int, reverse: bool = False):
    """Inclusive prefix (suffix if reverse) product along batch dim `dim`."""
    if a.is_cuda:
        return _launch_scan(params, "prod", a, None, dim, reverse)
    return plain_prefix_product(params, a, dim, reverse)


def affine_scan(params: FieldParams, m, b, dim: int):
    """d along batch dim `dim`, d_i = m_i d_{i-1} + b_i, d_0 = b_0 (m_0 is
    never read, so m may be a broadcast constant); m and b broadcast."""
    m, b = torch.broadcast_tensors(m, b)
    if b.is_cuda:
        return _launch_scan(params, "affine", m, b, dim, False)
    return plain_affine_scan(params, m, b, dim)
