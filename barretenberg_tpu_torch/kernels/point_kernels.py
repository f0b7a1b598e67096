"""K3: the complete masked G1 Jacobian group law over Fq, and its four
lane-wise chains as one launch each (K3d, K3e, K3f, K3g).

Replaces the JAX package's Pallas kernels ``kernels/point_kernels.py``
``_kernel_fn`` / ``_dbl_rows`` (public ``dbl``, ``add``, ``mixed_add``).
Source: ``csrc/point_kernels.cu`` (+ ``csrc/point.cuh``, the group law it
shares with the MSM bucket kernels of ``msm_kernels.py`` and the chains of
``csrc/point_chains.cu``, and ``csrc/field.cuh``). On the main path the
lane-wise launches serve only the small MSM's tree sum (``add``);
``dbl`` and ``mixed_add`` run inside K3d and K3e, and the Pippenger MSM's
bucket phase and window combine run in ``msm_kernels.py``.

Each launch computes one point operation per lane - dbl-2009-l,
add-2007-bl or madd-2007-bl, with lane selects for P == Q (-> doubling),
P == -Q (-> infinity) and either operand at infinity.

What bounds it on the card: operations. An ``add`` moves 9 coordinate arrays
and 3 mask bytes per lane (651 bytes) and does 16 field multiplications
(5,472 32-bit multiply-adds), ``mixed_add`` 579 bytes and 11, ``dbl`` 432
bytes and 7; at the card's rates the multiplies take 1.1-1.7x as long as
the bytes (chip_smoke.py reckons both). What the design does about it:
every intermediate field element of one operation stays in the thread's
registers (no spill at 168 registers for ``add``; the ptxas counts are in
PERF.md), so device memory sees each coordinate once; the rare P == Q
lanes take the doubling as a branch instead of computing it for every lane.

K3d ``scalar_mul_bits`` (``csrc/point_chains.cu``) replaces the
``lax.scan`` of the JAX package's ``Curve._scalar_mul_bits``
(``groups/group.py:298-311``, ``dbl`` and ``mixed_add`` per bit): the
small-MSM double-and-add, one thread per lane running all 254 steps in
registers. It is bound by that thread's chain of dependent products, not by
the card's rates, so its CTAs are one warp each (the lanes spread over the
SMs), and ``fe_mul``'s lazy-carry columns keep each product's dependent work
short. K3e ``fixed_base`` replaces the
``fori_loop`` of ``groups/g1.py:198-210`` (``jnp.take`` + ``mixed_add`` per
8-bit window): it is bound by operations; each lane walks the 32 windows
with its sum in registers, reading each table entry as one 80-byte row, and
skips the adds from and of infinity. Both run the plain loops' point
operations in their order, so the coordinates are equal limb for limb.

K3f ``table_rows`` (``csrc/point_chains.cu``) replaces the ``fori_loop`` of
``dbl`` in the JAX package's ``generate_pippenger_point_table``
(``msm/pippenger.py:457-458``, c doublings per row, one jitted loop per
row): the rows 2^(r c) P of the precomputed Pippenger table, one thread per
point carrying the Jacobian sum through all (rows - 1) * c doublings and
storing it after every c. It is bound by operations; the rows are then
normalised to affine in one batched normalisation (affine coordinates are
unique, so how the JAX package chunks its normalisations cannot show).

K3g ``windowed_walk`` (``csrc/point_chains.cu``) replaces the two
``lax.scan``s of the JAX package's arbitrary-base scalar multiplication
(``groups/group.py:324-397``: ``_build_mul_table``, one ``mixed_add`` per
table entry, and ``_windowed_walk``, per signed window c ``dbl`` and one
``add`` of a gathered table entry per digit set), behind
``Curve.scalar_mul_windowed`` and ``groups/g1.py::scalar_mul_glv``. One
thread per lane builds its table T[m] = m P (m <= 2^(c-1)) in device memory
and walks the rounds most significant first, against T alone (windowed:
the full scalar's digits, computed in the kernel from the Montgomery
scalar) or T and psi(T) = (beta x, -y, z) (GLV: K4's digits of k1 and k2).
It is bound by that thread's chain of dependent products (~2,770 a lane
for the windowed walk at c = 5, ~1,950 for GLV), so its CTAs are one warp
each, as K3d's; the point operations are the plain walk's in its order.

Infinity masks travel as one byte per lane; the wrapper converts to and
from ``bool``. A CUDA batch always launches the kernel (or raises); a CPU
batch always takes the plain version below.
"""

from __future__ import annotations

import torch

from ..fields.params import FQ_PARAMS, FR_PARAMS, LIMB_MASK, NUM_LIMBS
from ..groups.group import AffinePoints, JacobianPoints
from . import build
from .field_kernels import limb_field

L = NUM_LIMBS
ROW_WORDS = 20  # csrc/point.cuh: one point-table row
ENTRY_WORDS = 28  # csrc/point_chains.cu: one K3g table entry (x, y, z, inf)
SCALAR_BITS = 254  # bits of an Fr scalar
MAX_WALK_C = 16  # K3g's widest window (csrc/point_chains.cu WALK_MAX_C)

# Kernel launches per op since the counters were last reset (reset_counts),
# and how many of them ran one lane.
launch_counts = {"dbl": 0, "add": 0, "mixed_add": 0, "scalar_mul_bits": 0, "fixed_base": 0, "table_rows": 0,
                 "windowed_walk": 0}
single_lane_counts = dict.fromkeys(launch_counts, 0)


def reset_counts() -> None:
    for counts in (launch_counts, single_lane_counts):
        for op in counts:
            counts[op] = 0


def _count(op: str, lanes: int) -> None:
    launch_counts[op] += 1
    if lanes == 1:
        single_lane_counts[op] += 1


# ---------------------------------------------------------------------------
# Plain PyTorch version (limb_ops.LimbField arithmetic, any device)
# ---------------------------------------------------------------------------
def _dbl_xyz(f, x, y, z):
    a = f.sqr(x)
    b = f.sqr(y)
    c = f.sqr(b)
    d = f.sub(f.sqr(f.add(x, b)), f.add(a, c))
    d = f.double(d)
    e = f.add(f.double(a), a)
    ff = f.sqr(e)
    x3 = f.sub(ff, f.double(d))
    y3 = f.sub(f.mont_mul(e, f.sub(d, x3)), f.double(f.double(f.double(c))))
    z3 = f.double(f.mont_mul(y, z))
    return x3, y3, z3


def plain_dbl(p: JacobianPoints) -> JacobianPoints:
    """Point doubling, dbl-2009-l for a = 0. BN254 has prime order, so no
    affine point has y = 0."""
    f = limb_field(FQ_PARAMS)
    return JacobianPoints(*_dbl_xyz(f, p.x, p.y, p.z), p.inf)


def _merge(f, p, q_x, q_y, q_z, q_inf, x3, y3, z3, h_zero, r_zero):
    """The reference's branch ladder as lane selects. The doubling is only
    computed when some lane has P == Q (as in the CUDA kernel)."""
    both_live = ~p.inf & ~q_inf
    use_dbl = both_live & h_zero & r_zero
    cancel = both_live & h_zero & ~r_zero
    x, y, z = x3, y3, z3
    if bool(use_dbl.any()):
        dx, dy, dz = _dbl_xyz(f, p.x, p.y, p.z)
        x = f.select(use_dbl, dx, x3)
        y = f.select(use_dbl, dy, y3)
        z = f.select(use_dbl, dz, z3)
    # P at infinity -> Q; Q at infinity -> P
    x = f.select(q_inf, p.x, f.select(p.inf, q_x, x))
    y = f.select(q_inf, p.y, f.select(p.inf, q_y, y))
    z = f.select(q_inf, p.z, f.select(p.inf, q_z, z))
    inf = torch.where(q_inf, p.inf, torch.where(p.inf, q_inf, cancel))
    return JacobianPoints(x, y, z, inf)


def plain_add(p: JacobianPoints, q: JacobianPoints) -> JacobianPoints:
    """Complete Jacobian addition (add-2007-bl), mask-merged."""
    f = limb_field(FQ_PARAMS)
    mul = f.mont_mul
    z1z1 = f.sqr(p.z)
    z2z2 = f.sqr(q.z)
    u1 = mul(p.x, z2z2)
    u2 = mul(q.x, z1z1)
    s1 = mul(p.y, mul(q.z, z2z2))
    s2 = mul(q.y, mul(p.z, z1z1))
    h = f.sub(u2, u1)
    r = f.double(f.sub(s2, s1))
    i = f.sqr(f.double(h))
    j = mul(h, i)
    v = mul(u1, i)
    x3 = f.sub(f.sqr(r), f.add(j, f.double(v)))
    y3 = f.sub(mul(r, f.sub(v, x3)), f.double(mul(s1, j)))
    z3 = mul(f.sub(f.sqr(f.add(p.z, q.z)), f.add(z1z1, z2z2)), h)
    return _merge(f, p, q.x, q.y, q.z, q.inf, x3, y3, z3, f.is_zero(h), f.is_zero(r))


def plain_mixed_add(p: JacobianPoints, q: AffinePoints) -> JacobianPoints:
    """Jacobian + affine (madd-2007-bl), mask-merged."""
    f = limb_field(FQ_PARAMS)
    mul = f.mont_mul
    z1z1 = f.sqr(p.z)
    u2 = mul(q.x, z1z1)
    s2 = mul(q.y, mul(p.z, z1z1))
    h = f.sub(u2, p.x)
    r = f.double(f.sub(s2, p.y))
    hh = f.sqr(h)
    i = f.double(f.double(hh))
    j = mul(h, i)
    v = mul(p.x, i)
    x3 = f.sub(f.sqr(r), f.add(j, f.double(v)))
    y3 = f.sub(mul(r, f.sub(v, x3)), f.double(mul(p.y, j)))
    z3 = f.sub(f.sqr(f.add(p.z, h)), f.add(z1z1, hh))
    one = f.const_rows(1, p.x)
    return _merge(f, p, q.x, q.y, one, q.inf, x3, y3, z3, f.is_zero(h), f.is_zero(r))


def _infinity(lanes: int, device) -> JacobianPoints:
    zero = torch.zeros((L, lanes), dtype=torch.int32, device=device)
    return JacobianPoints(zero, zero, zero, torch.ones(lanes, dtype=torch.bool, device=device))


def _tile(p: AffinePoints, lanes: int) -> AffinePoints:
    """Lane l of the result is point l % n."""
    reps = lanes // p.x.shape[1]
    if reps == 1:
        return p
    return AffinePoints(p.x.repeat(1, reps), p.y.repeat(1, reps), p.inf.repeat(reps))


def plain_scalar_mul_bits(p: AffinePoints, bits: torch.Tensor) -> JacobianPoints:
    """Double-and-add over an MSB-first bit array: bits (nbits, lanes) in
    {0, 1}, lane l multiplying point l % n of p. Per bit one doubling of
    every lane and one mixed addition, kept where the bit is set."""
    f = limb_field(FQ_PARAMS)
    q = _tile(p, bits.shape[1])
    acc = _infinity(bits.shape[1], p.x.device)
    for k in range(bits.shape[0]):
        acc = plain_dbl(acc)
        added = plain_mixed_add(acc, q)
        take = bits[k] > 0
        acc = JacobianPoints(
            f.select(take, added.x, acc.x), f.select(take, added.y, acc.y),
            f.select(take, added.z, acc.z), torch.where(take, added.inf, acc.inf),
        )
    return acc


def plain_fixed_base(digits: torch.Tensor, rows: torch.Tensor) -> JacobianPoints:
    """Fixed-base window multiplication: digits (windows, n), rows the
    window table as ``point_table`` rows (windows * per_window entries); per
    window one gather of entry w * per_window + digit and one mixed
    addition, from infinity."""
    windows, n = digits.shape
    per_window = rows.shape[0] // windows
    acc = _infinity(n, digits.device)
    for w in range(windows):
        idx = digits[w].to(torch.int64) + w * per_window
        acc = plain_mixed_add(acc, row_points(rows.index_select(0, idx)))
    return acc


def plain_table_rows(p: AffinePoints, rows: int, c: int) -> JacobianPoints:
    """Rows 1 .. rows-1 of the precomputed Pippenger table as Jacobian
    points, (18, (rows - 1) * n), row r at lanes [(r - 1) n, r n): from p
    with z = one, c lane-wise doublings per row."""
    f = limb_field(FQ_PARAMS)
    acc = JacobianPoints(p.x, p.y, f.const_rows(1, p.x), p.inf)
    out = []
    for _ in range(rows - 1):
        for _ in range(c):
            acc = plain_dbl(acc)
        out.append(acc)
    return JacobianPoints(*(torch.cat([getattr(q, k) for q in out], dim=-1) for k in ("x", "y", "z", "inf")))


def walk_rounds(c: int, glv: bool) -> int:
    """Digit rounds of K3g's walk at window c: a 128-bit GLV half's
    ceil(128 / c) signed windows and the final carry, or the full 254-bit
    scalar's ceil(254 / c) and the carry."""
    return -(-(128 if glv else SCALAR_BITS) // c) + 1


def plain_mul_table(p: AffinePoints, size: int) -> JacobianPoints:
    """T[m] = m P for m < size, as (18, size, n) coordinates and (size, n)
    flags: T[0] at infinity with zero coordinates, then one mixed add of P
    per entry (the JAX package's ``Curve._build_mul_table`` order)."""
    acc = _infinity(p.x.shape[1], p.x.device)
    tab = [acc]
    for _ in range(size - 1):
        acc = plain_mixed_add(acc, p)
        tab.append(acc)
    return JacobianPoints(*(torch.stack([getattr(q, k) for q in tab], dim=-2) for k in ("x", "y", "z", "inf")))


def endo_table(tab: JacobianPoints) -> JacobianPoints:
    """psi(T) = (beta x, -y, z) of every table entry."""
    f = limb_field(FQ_PARAMS)
    return JacobianPoints(f.mont_mul(tab.x, f.const_rows(FQ_PARAMS.cube_root, tab.x)), f.neg(tab.y), tab.z, tab.inf)


def plain_table_walk(tables, digit_sets, c: int) -> JacobianPoints:
    """The signed-window walk, most significant round first: per round c
    doublings, then per (table, digits) pair one full add of entry |d| of
    each lane's table, with y negated where d < 0; digit_sets: (rounds, n)
    each, LSB round first (``Curve._windowed_walk``)."""
    f = limb_field(FQ_PARAMS)
    rounds, n = digit_sets[0].shape
    acc = _infinity(n, tables[0].x.device)
    for r in reversed(range(rounds)):
        for _ in range(c):
            acc = plain_dbl(acc)
        for tab, d in zip(tables, digit_sets):
            dr = d[r].to(torch.int64)
            idx = dr.abs().reshape(1, 1, n)
            x, y, z = (t.gather(1, idx.expand(L, 1, n))[:, 0] for t in tab[:3])
            inf = tab.inf.gather(0, idx[0])[0]
            acc = plain_add(acc, JacobianPoints(x, f.select(dr < 0, f.neg(y), y), z, inf))
    return acc


def plain_windowed_walk(p: AffinePoints, scalars_mont: torch.Tensor, c: int) -> JacobianPoints:
    """K3g's windowed mode: the full-width signed c-bit digits of each lane's
    scalar (``msm/wnaf.py::signed_digits_full`` of its plain value) walked
    against the lane's table of 2^(c-1) + 1 multiples of its point."""
    from ..msm.wnaf import signed_digits_full  # msm imports this module

    fr = limb_field(FR_PARAMS)
    plain_one = torch.zeros_like(scalars_mont)
    plain_one[0] = 1
    digits = signed_digits_full(fr.mont_mul(scalars_mont, plain_one), c)
    return plain_table_walk([plain_mul_table(p, (1 << (c - 1)) + 1)], [digits], c)


def plain_glv_walk(p: AffinePoints, digits: torch.Tensor, c: int) -> JacobianPoints:
    """K3g's GLV mode: digits (rounds, 2, n) of k1 and k2 (K4's layout)
    walked against the table T and psi(T), sharing the doublings."""
    tab = plain_mul_table(p, (1 << (c - 1)) + 1)
    return plain_table_walk([tab, endo_table(tab)], [digits[:, 0], digits[:, 1]], c)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------
def _coord(t: torch.Tensor, n: int, device) -> torch.Tensor:
    if t.dtype != torch.int32 or t.shape != (L, n) or t.device != device or not t.is_cuda:
        raise ValueError(
            f"point kernel takes (18, {n}) int32 CUDA coordinates, got {tuple(t.shape)} {t.dtype} on {t.device}"
        )
    return t.contiguous()


def _mask(m: torch.Tensor, n: int, device) -> torch.Tensor:
    if m.dtype != torch.bool or m.shape != (n,) or m.device != device:
        raise ValueError(f"point kernel takes ({n},) bool infinity masks, got {tuple(m.shape)} {m.dtype}")
    return m.contiguous().view(torch.uint8)


def _launch_dbl(p: JacobianPoints) -> JacobianPoints:
    n, dev = p.x.shape[1], p.x.device
    x, y, z = (_coord(t, n, dev) for t in (p.x, p.y, p.z))
    ox, oy, oz = (torch.empty_like(x) for _ in range(3))
    lib = build.get_lib("point_kernels")
    with torch.cuda.device(dev):
        err = lib.bb_point_dbl(
            x.data_ptr(), y.data_ptr(), z.data_ptr(),
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(),
            n, build.field_consts(FQ_PARAMS), build.current_stream(),
        )
    build.check(err, "point_dbl")
    _count("dbl", n)
    return JacobianPoints(ox, oy, oz, p.inf)


def _launch_add(p: JacobianPoints, q, mixed: bool) -> JacobianPoints:
    n, dev = p.x.shape[1], p.x.device
    x1, y1, z1 = (_coord(t, n, dev) for t in (p.x, p.y, p.z))
    x2, y2 = (_coord(t, n, dev) for t in (q.x, q.y))
    z2 = None if mixed else _coord(q.z, n, dev)
    i1, i2 = _mask(p.inf, n, dev), _mask(q.inf, n, dev)
    ox, oy, oz = (torch.empty_like(x1) for _ in range(3))
    oi = torch.empty(n, dtype=torch.uint8, device=dev)
    lib = build.get_lib("point_kernels")
    with torch.cuda.device(dev):
        err = lib.bb_point_add(
            1 if mixed else 0,
            x1.data_ptr(), y1.data_ptr(), z1.data_ptr(), i1.data_ptr(),
            x2.data_ptr(), y2.data_ptr(), None if mixed else z2.data_ptr(), i2.data_ptr(),
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oi.data_ptr(),
            n, build.field_consts(FQ_PARAMS), build.current_stream(),
        )
    op = "mixed_add" if mixed else "add"
    build.check(err, f"point_{op}")
    _count(op, n)
    return JacobianPoints(ox, oy, oz, oi.view(torch.bool))


def point_table(px, py, pinf) -> torch.Tensor:
    """An affine point table as the kernels read it: one 80-byte row per
    point - x and y as 9 x 30-bit words each (two 15-bit limbs per word),
    the infinity flag, a pad word."""
    def words(t):
        return (t[0::2] | (t[1::2] << 15)).t()

    table = torch.zeros((px.shape[1], ROW_WORDS), dtype=torch.int32, device=px.device)
    table[:, :9] = words(px)
    table[:, 9:18] = words(py)
    table[:, 18] = pinf
    return table


def row_points(rows: torch.Tensor) -> AffinePoints:
    """``point_table`` rows back to planar affine points."""
    def limbs(w):
        w = w.t()
        return torch.stack((w & LIMB_MASK, w >> 15), 1).reshape(L, -1)

    return AffinePoints(limbs(rows[:, :9]), limbs(rows[:, 9:18]), rows[:, 18] != 0)


def _launch_scalar_mul_bits(p: AffinePoints, bits: torch.Tensor) -> JacobianPoints:
    n, dev = p.x.shape[1], p.x.device
    if bits.dim() != 2 or bits.device != dev or n == 0 or bits.shape[1] % n:
        raise ValueError(
            f"scalar_mul_bits takes (nbits, lanes) bits on {dev} with lanes a multiple of {n}, "
            f"got {tuple(bits.shape)} on {bits.device}"
        )
    nbits, lanes = bits.shape
    x, y = (_coord(t, n, dev) for t in (p.x, p.y))
    inf = _mask(p.inf, n, dev)
    bits = (bits if bits.dtype == torch.uint8 else (bits > 0).to(torch.uint8)).contiguous()
    ox, oy, oz = (torch.empty((L, lanes), dtype=torch.int32, device=dev) for _ in range(3))
    oi = torch.empty(lanes, dtype=torch.uint8, device=dev)
    lib = build.get_lib("point_chains")
    with torch.cuda.device(dev):
        err = lib.bb_scalar_mul_bits(
            x.data_ptr(), y.data_ptr(), inf.data_ptr(), n, bits.data_ptr(), nbits,
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oi.data_ptr(),
            lanes, build.field_consts(FQ_PARAMS), build.current_stream(),
        )
    build.check(err, "scalar_mul_bits")
    _count("scalar_mul_bits", lanes)
    return JacobianPoints(ox, oy, oz, oi.view(torch.bool))


def _launch_fixed_base(digits: torch.Tensor, rows: torch.Tensor) -> JacobianPoints:
    dev = rows.device
    entries = rows.shape[0]
    if rows.dtype != torch.int32 or rows.shape != (entries, ROW_WORDS) or not rows.is_contiguous():
        raise ValueError(f"fixed_base takes (entries, {ROW_WORDS}) int32 point_table rows, got {tuple(rows.shape)}")
    if digits.dtype != torch.uint8 or digits.dim() != 2 or digits.device != dev or entries % digits.shape[0]:
        raise ValueError(
            f"fixed_base takes (windows, n) uint8 digits on {dev} and a table of windows x entries, "
            f"got {tuple(digits.shape)} {digits.dtype} on {digits.device} and {entries} entries"
        )
    windows, n = digits.shape
    digits = digits.contiguous()
    ox, oy, oz = (torch.empty((L, n), dtype=torch.int32, device=dev) for _ in range(3))
    oi = torch.empty(n, dtype=torch.uint8, device=dev)
    lib = build.get_lib("point_chains")
    with torch.cuda.device(dev):
        err = lib.bb_fixed_base(
            rows.data_ptr(), digits.data_ptr(), windows, entries // windows,
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oi.data_ptr(),
            n, build.field_consts(FQ_PARAMS), build.current_stream(),
        )
    build.check(err, "fixed_base")
    _count("fixed_base", n)
    return JacobianPoints(ox, oy, oz, oi.view(torch.bool))


def _launch_table_rows(p: AffinePoints, rows: int, c: int) -> JacobianPoints:
    n, dev = p.x.shape[1], p.x.device
    if rows < 2 or c < 1:
        raise ValueError(f"table_rows takes rows >= 2 and c >= 1, got rows={rows} c={c}")
    x, y = (_coord(t, n, dev) for t in (p.x, p.y))
    inf = _mask(p.inf, n, dev)
    lanes = (rows - 1) * n
    ox, oy, oz = (torch.empty((L, lanes), dtype=torch.int32, device=dev) for _ in range(3))
    oi = torch.empty(lanes, dtype=torch.uint8, device=dev)
    lib = build.get_lib("point_chains")
    with torch.cuda.device(dev):
        err = lib.bb_table_rows(
            x.data_ptr(), y.data_ptr(), inf.data_ptr(), n, rows, c,
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oi.data_ptr(),
            build.field_consts(FQ_PARAMS), build.current_stream(),
        )
    build.check(err, "table_rows")
    _count("table_rows", n)
    return JacobianPoints(ox, oy, oz, oi.view(torch.bool))


def _launch_windowed_walk(p: AffinePoints, c: int, scalars=None, digits=None) -> JacobianPoints:
    n, dev = p.x.shape[1], p.x.device
    glv = digits is not None
    rounds = walk_rounds(c, glv)
    x, y = (_coord(t, n, dev) for t in (p.x, p.y))
    inf = _mask(p.inf, n, dev)
    if glv:
        if digits.dtype != torch.int32 or digits.shape != (rounds, 2, n) or digits.device != dev:
            raise ValueError(f"glv_walk takes ({rounds}, 2, {n}) int32 digits on {dev}, got "
                             f"{tuple(digits.shape)} {digits.dtype} on {digits.device}")
        src = digits.contiguous()
    else:
        src = _coord(scalars, n, dev)
    table = torch.empty(n * ((1 << (c - 1)) + 1) * ENTRY_WORDS, dtype=torch.int32, device=dev)
    ox, oy, oz = (torch.empty((L, n), dtype=torch.int32, device=dev) for _ in range(3))
    oi = torch.empty(n, dtype=torch.uint8, device=dev)
    lib = build.get_lib("point_chains")
    with torch.cuda.device(dev):
        err = lib.bb_windowed_walk(
            1 if glv else 0, x.data_ptr(), y.data_ptr(), inf.data_ptr(), n, src.data_ptr(), c, rounds,
            table.data_ptr(), ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oi.data_ptr(),
            build.field_consts(FQ_PARAMS), build.field_consts(FR_PARAMS), build.endo_consts(),
            build.current_stream(),
        )
    build.check(err, "windowed_walk")
    _count("windowed_walk", n)
    return JacobianPoints(ox, oy, oz, oi.view(torch.bool))


def _walk_window(c: int) -> None:
    if not 1 <= c <= MAX_WALK_C:
        raise ValueError(f"the windowed walk takes 1 <= c <= {MAX_WALK_C}, got {c}")


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------
def dbl(p: JacobianPoints) -> JacobianPoints:
    return _launch_dbl(p) if p.x.is_cuda else plain_dbl(p)


def add(p: JacobianPoints, q: JacobianPoints) -> JacobianPoints:
    return _launch_add(p, q, mixed=False) if p.x.is_cuda else plain_add(p, q)


def mixed_add(p: JacobianPoints, q: AffinePoints) -> JacobianPoints:
    return _launch_add(p, q, mixed=True) if p.x.is_cuda else plain_mixed_add(p, q)


def scalar_mul_bits(p: AffinePoints, bits: torch.Tensor) -> JacobianPoints:
    """K3d: per lane l, [k_l] p[l % n] from the MSB-first bits (nbits, lanes)."""
    return _launch_scalar_mul_bits(p, bits) if p.x.is_cuda else plain_scalar_mul_bits(p, bits)


def fixed_base(digits: torch.Tensor, rows: torch.Tensor) -> JacobianPoints:
    """K3e: per lane, the sum over windows w of rows[w * per_window + digits[w]]."""
    return _launch_fixed_base(digits, rows) if rows.is_cuda else plain_fixed_base(digits, rows)


def table_rows(p: AffinePoints, rows: int, c: int) -> JacobianPoints:
    """K3f: rows 1 .. rows-1 of the precomputed Pippenger table, row r
    holding 2^(r c) p, as Jacobian points (18, (rows - 1) * n)."""
    return _launch_table_rows(p, rows, c) if p.x.is_cuda else plain_table_rows(p, rows, c)


def windowed_walk(p: AffinePoints, scalars_mont: torch.Tensor, c: int) -> JacobianPoints:
    """K3g, windowed: per lane, [k] p for the lane's internal-Montgomery Fr
    scalar k ((18, n)), by signed c-bit windows over the full scalar."""
    _walk_window(c)
    return _launch_windowed_walk(p, c, scalars=scalars_mont) if p.x.is_cuda else plain_windowed_walk(p, scalars_mont, c)


def glv_walk(p: AffinePoints, digits: torch.Tensor, c: int) -> JacobianPoints:
    """K3g, GLV: per lane, k1 p + k2 psi(p) from the signed c-bit digits of
    k1 and k2, (rounds, 2, n) int32 (K4's layout for one set)."""
    _walk_window(c)
    return _launch_windowed_walk(p, c, digits=digits) if p.x.is_cuda else plain_glv_walk(p, digits, c)
