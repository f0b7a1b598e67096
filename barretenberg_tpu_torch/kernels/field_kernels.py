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
prove's sizes, n log2 n products. What bounds the kernel on the card: the
dependent chain of combines in one tile (a combine is one or two products,
~1,000 cycles of one warp's issue each), not the bytes (72 per element in
and out) or the ~2n products, which at 2^16 are ~8 products per warp
scheduler. What the design does about it (``csrc/field_kernels.cu``): one
launch runs the whole scan, with a tile picked from the row by
``scan_plan`` - a row of up to 32 elements is one warp, one of up to 1,024
one CTA (both with no look-back and no flags), a longer row tiles of 128
threads of 4 items while all its tiles fit on the card's SMs at once (2^16:
128 tiles), else of 8 - so that a 2^16 row runs on the whole card with a
short chain: each thread scans its items in registers, warps by shuffles,
warp 0 the warp totals by shuffles, and tiles chain by a decoupled
look-back whose lanes each fold up to 4 earlier tiles (a window of 128).
The look-back's counters and flags live in a scratch buffer cached per
(card, stream) that each launch leaves zeroed for the next (its tiles'
totals and prefixes in another), so a scan is one device operation and
allocates nothing but its output. Field products
and sums are exact and canonical, so any grouping gives the plain
version's limbs bit for bit, ``batch_invert``'s values at zero entries
included.

``dot`` replaces the ``mont_mul`` and the ``add`` levels of ``_mul_fn`` in
the JAX package's evaluations (``plonk/prover.py:259-271``
``_multi_eval_jit``; ``polynomials/arithmetic.py:19-28``, ``:55-58``,
``:69-71`` ``_tree_sum``, ``_evaluate_jit``, ``evaluate_device``): B rows
of n lanes multiplied lane by lane with one power table and summed, an
(18, B) result. The port ran each as one K1 ``mul`` and a tree of K1
``add`` launches, one per halving level (16-18 at the prove's sizes).
What bounds it on the card: bytes (72 per element of each row and of the
table, read once). What the design does about it: one launch per batch
of up to ``DOT_MAX_ROWS`` rows, a grid of CTAs per row x rows; each
thread keeps one sum in registers (the rows' CTAs re-read the table
through L2: B sums a thread took 130-168 registers and a third of the
card's warps), warps fold by shuffles, CTAs through shared memory, and
each row's CTA that finishes last folds the row's partials (global
scratch, a fence and an atomic ticket per row) in the same launch; all
rows' CTAs together fill the card once (the occupancy query).

``lincomb`` replaces ``_linear_combo_jit`` (``plonk/prover.py:274-282``):
sum_j s_j a_j for host-known scalars, which the port ran as one scalar
copy, one K1 ``mul`` and one K1 ``add`` per term. Bound by bytes (each
operand read once, the result written once); one thread per lane keeps
the sum in registers, and the scalars and operand addresses arrive by
value, up to ``LINCOMB_MAX_TERMS`` terms a launch.

A CUDA tensor always launches the kernel (or raises); a CPU tensor always
takes the plain version (``limb_ops.LimbField``; for ``scan``, the
Hillis-Steele loops of ``utils/scans.py``; for ``dot``, a product and a
tree of sums; for ``lincomb``, a product and a sum per term).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields.params import NUM_LIMBS, R_INTERNAL, FieldParams
from ..utils import scans
from . import build
from .limb_ops import LimbField

L = NUM_LIMBS
_OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3}
EXP_WORDS = 8  # csrc/field_kernels.cu: pow takes exponents of up to 256 bits
SCAN_THREADS = 128  # csrc/field_kernels.cu: threads of a tiled scan CTA
SCAN_MAX_ITEMS = 8  # csrc/field_kernels.cu: elements per scan thread, at most
SCAN_DATA_WORDS_PER_TILE = 4 * 9  # a tile's total and inclusive prefix
_SCAN_MODES = {"prod": 0, "affine": 1}
DOT_THREADS = 128  # csrc/field_kernels.cu: threads per CTA of dot
DOT_MAX_ROWS = 8  # csrc/field_kernels.cu: rows per launch of dot
LINCOMB_MAX_TERMS = 12  # csrc/field_kernels.cu: terms per launch of lincomb

# Kernel launches per op since the counters were last reset (reset_counts),
# and how many of them ran one lane.
launch_counts = {op: 0 for op in (*_OPS, "pow", "scan", "dot", "lincomb")}
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


def plain_dot(params: FieldParams, rows, table):
    """The plain PyTorch version of ``dot`` (any device): each row times the
    table, lane by lane, then summed by halving levels -> (18, B)."""
    lf = limb_field(params)
    x = lf.mont_mul(torch.stack(list(rows), dim=1), table.unsqueeze(1))
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        s = lf.add(x[..., :half], x[..., half : 2 * half])
        x = torch.cat([s, x[..., 2 * half :]], dim=-1) if n % 2 else s
        n = x.shape[-1]
    return x[..., 0]


def plain_linear_combination(params: FieldParams, polys, scalars):
    """The plain PyTorch version of ``lincomb`` (any device): one product by
    each term's scalar and one sum per term after the first."""
    lf = limb_field(params)
    acc = None
    for poly, s in zip(polys, scalars):
        t = lf.mont_mul(poly, lf.const_rows(s, poly[:, :1]))
        acc = t if acc is None else lf.add(acc, t)
    return acc


def _launch(params: FieldParams, op: str, a, b):
    if b is None:
        b = a
    shape = None
    if a.ndim != 2 or b.ndim != 2:
        if a.shape != b.shape:
            a, b = torch.broadcast_tensors(a, b)
        shape = a.shape
        a, b = a.reshape(L, -1), b.reshape(L, -1)
    # (18, n) against (18, 1): the column is read with lane stride 0
    n = max(a.shape[1], b.shape[1])
    for t in (a, b):
        if t.dtype != torch.int32 or not t.is_cuda or t.shape[0] != L or t.shape[1] not in (1, n):
            raise ValueError(
                f"field kernel takes (18, n) int32 CUDA tensors, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if b.device != a.device:
        raise ValueError("field kernel operands lie on different devices")
    out = a.new_empty((L, n))
    with build.on_device(a):
        err = build.get_lib("field_kernels").bb_field_op(
            _OPS[op],
            a.data_ptr(), a.stride(0), a.stride(1) if a.shape[1] == n else 0,
            b.data_ptr(), b.stride(0), b.stride(1) if b.shape[1] == n else 0,
            out.data_ptr(), n, build.field_consts(params), build.stream_of(a),
        )
    build.check(err, f"field_op[{op}]")
    _count(op, n)
    return out if shape is None else out.reshape(shape)


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
    out = a.new_empty((L, n))
    with build.on_device(a):
        err = build.get_lib("field_kernels").bb_field_pow(
            a.data_ptr(), a.stride(0), a.stride(1), out.data_ptr(), n,
            words.ctypes.data, exponent.bit_length(), build.field_consts(params), build.stream_of(a),
        )
    build.check(err, "field_pow")
    _count("pow", n)
    return out if len(shape) == 2 else out.reshape(shape)


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


def scan_plan(rows: int, n: int, sms: int, threads: int = SCAN_THREADS, warp: int = 32,
              max_items: int = SCAN_MAX_ITEMS) -> tuple:
    """K1 scan's (threads, items, tiles) for `rows` rows of n elements on a
    card of `sms` SMs: a row of at most one warp's elements is one warp of
    one element a lane, one of at most `threads` x `max_items` one CTA of
    the fewest items that cover it (neither with a look-back); a longer row
    takes tiles of `threads` x max_items / 2 while all tiles of all rows fit
    on the SMs at once, else of `threads` x max_items."""
    if n <= warp:
        return warp, 1, 1
    if n <= threads * max_items:
        items = 1
        while threads * items < n:
            items *= 2
        return threads, items, 1
    items = max_items // 2
    if rows * -(-n // (threads * items)) > sms:
        items = max_items
    return threads, items, -(-n // (threads * items))


def scan_scratch_words(rows: int, tiles: int) -> tuple:
    """The int32 words of a chained scan's two scratch buffers: its state
    (two counters and a flag per tile, zero before and after each launch)
    and its data (each tile's total and inclusive prefix). They are apart,
    so that no flag of a later launch with more tiles lands on data an
    earlier one left."""
    return 2 + rows * tiles, rows * tiles * SCAN_DATA_WORDS_PER_TILE


_sms: dict = {}
_scan_state: dict = {}
_scan_data: dict = {}


def _multiprocessors(device) -> int:
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _launch_scan(params: FieldParams, mode: str, a, b, dim: int, reverse: bool):
    moved = a.movedim(dim, -1).shape
    a3 = _scan_rows(a, dim)
    b3 = a3 if b is None else _scan_rows(b, dim)
    if b3.device != a3.device or b3.shape != a3.shape:
        raise ValueError("scan kernel operands differ in device or shape")
    _, rows, n = a3.shape
    out = a3.new_empty((L, rows, n))
    device = a3.device
    threads, items, tiles = scan_plan(rows, n, _multiprocessors(device))
    with build.on_device(a3):
        stream = build.stream_of(a3)
        state = data = None
        state_words = data_words = 0
        if tiles > 1:
            state_words, data_words = scan_scratch_words(rows, tiles)
            state = _scratch(_scan_state, device, stream, state_words).data_ptr()
            data = _scratch(_scan_data, device, stream, data_words).data_ptr()
        err = build.get_lib("field_kernels").bb_field_scan(
            _SCAN_MODES[mode], int(reverse),
            a3.data_ptr(), a3.stride(0), a3.stride(1), a3.stride(2),
            b3.data_ptr(), b3.stride(0), b3.stride(1), b3.stride(2),
            out.data_ptr(), rows, n, threads, items, tiles, state, state_words, data, data_words,
            build.field_consts(params), stream,
        )
    build.check(err, f"field_scan[{mode}]")
    _count("scan", n)
    return out.reshape(moved).movedim(-1, dim)


def _operands(ts, n: int, what: str) -> None:
    """Raise unless every tensor is an (18, n) int32 CUDA tensor on one device."""
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.int32 or not t.is_cuda or t.ndim != 2 or t.shape[0] != L or t.shape[1] != n:
            raise ValueError(f"{what} kernel takes (18, {n}) int32 CUDA tensors, got {tuple(t.shape)} {t.dtype} on {t.device}")
        if t.device != dev:
            raise ValueError(f"{what} kernel operands lie on different devices")


_dot_ctas: dict = {}
_dot_scratch: dict = {}


def dot_ctas(device) -> int:
    """The CTAs of dot that the card holds at once (CUDA's occupancy query,
    times the SMs)."""
    n = _dot_ctas.get(device)
    if n is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = build.get_lib("field_kernels").bb_field_dot_ctas(ctypes.addressof(out))
        build.check(err, "the field_dot occupancy query")
        n = _dot_ctas[device] = out.value
    return n


def dot_grid(capacity: int, rows: int, n: int) -> int:
    """dot's CTAs per row: all rows' CTAs fill the card once (`capacity`
    CTAs), and no CTA starts without a lane."""
    return max(1, min(capacity // rows, -(-n // DOT_THREADS)))


def _scratch(cache: dict, device, stream: int, words: int) -> torch.Tensor:
    """A kernel's zeroed scratch for one stream in `cache`, at least `words`
    int32 words, grown and never shrunk: dot's tickets and scan's counters
    and flags are back at zero when each launch ends, so launches in the
    stream's order share it."""
    key = (device, stream)
    s = cache.get(key)
    if s is None or s.numel() < words:
        s = cache[key] = torch.zeros(words, dtype=torch.int32, device=device)
    return s


def _launch_dot(params: FieldParams, rows, table):
    n = table.shape[1] if table.ndim == 2 else -1
    _operands([table, *rows], n, "dot")
    if n < 1:
        raise ValueError("dot kernel takes at least one lane")
    b_all = len(rows)
    device = table.device
    out = table.new_empty((L, b_all))
    lib = build.get_lib("field_kernels")
    with build.on_device(table):
        stream = build.stream_of(table)
        for start in range(0, b_all, DOT_MAX_ROWS):
            part = rows[start : start + DOT_MAX_ROWS]
            b = len(part)
            ctas = dot_grid(dot_ctas(device), b, n)
            scratch = _scratch(_dot_scratch, device, stream, DOT_MAX_ROWS + ctas * b * 9)
            args = np.array([v for r in part for v in (r.data_ptr(), r.stride(0), r.stride(1))], dtype=np.int64)
            err = lib.bb_field_dot(
                b, args.ctypes.data, table.data_ptr(), table.stride(0), table.stride(1),
                out.data_ptr() + 4 * start, b_all, 1, n, ctas, scratch.data_ptr(), scratch.numel(),
                build.field_consts(params), stream,
            )
            build.check(err, "field_dot")
            _count("dot", n)
    return out


def _launch_lincomb(params: FieldParams, polys, scalars):
    n = polys[0].shape[1] if polys[0].ndim == 2 else -1
    _operands(polys, n, "lincomb")
    p = params.modulus
    lib = build.get_lib("field_kernels")
    acc = None
    with build.on_device(polys[0]):
        stream = build.stream_of(polys[0])
        for start in range(0, len(polys), LINCOMB_MAX_TERMS):
            part = polys[start : start + LINCOMB_MAX_TERMS]
            args = np.array([v for p in part for v in (p.data_ptr(), p.stride(0), p.stride(1))], dtype=np.int64)
            # each scalar's internal Montgomery form, 32 little-endian bytes
            mont = b"".join((s * R_INTERNAL % p).to_bytes(32, "little") for s in scalars[start : start + LINCOMB_MAX_TERMS])
            out = polys[0].new_empty((L, n))
            err = lib.bb_field_lincomb(len(part), args.ctypes.data, mont, out.data_ptr(), n,
                                       build.field_consts(params), stream)
            build.check(err, "field_lincomb")
            _count("lincomb", n)
            acc = out if acc is None else _launch(params, "add", acc, out)
    return acc


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


def dot(params: FieldParams, rows, table):
    """(18, B): row r times `table` lane by lane, summed, for B rows of one
    length n (a list of (18, n) tensors) against an (18, n) table."""
    rows = list(rows)
    if not rows:
        raise ValueError("dot takes at least one row")
    if table.is_cuda:
        return _launch_dot(params, rows, table)
    return plain_dot(params, rows, table)


def linear_combination(params: FieldParams, polys, scalars):
    """(18, n): sum_j scalars[j] polys[j] for host-int field values and
    (18, n) tensors of one length."""
    polys, scalars = list(polys), [int(s) for s in scalars]
    if not polys or len(polys) != len(scalars):
        raise ValueError("linear_combination takes one scalar per polynomial, and at least one")
    if polys[0].is_cuda:
        return _launch_lincomb(params, polys, scalars)
    return plain_linear_combination(params, polys, scalars)
