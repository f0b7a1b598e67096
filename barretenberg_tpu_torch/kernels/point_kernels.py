"""K3: the complete masked G1 Jacobian group law over Fq.

Replaces the JAX package's Pallas kernels ``kernels/point_kernels.py``
``_kernel_fn`` / ``_dbl_rows`` (public ``dbl``, ``add``, ``mixed_add``).
Source: ``csrc/point_kernels.cu`` (+ ``csrc/point.cuh``, the group law it
shares with the MSM bucket kernels of ``msm_kernels.py``, and
``csrc/field.cuh``). On the main path these launches now serve SRS
generation's fixed-base mixed adds and the small-MSM path
(``msm/naive.py``: double-and-add over all lanes, then a tree sum); the
Pippenger MSM's bucket phase and window combine run in ``msm_kernels.py``.

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

Infinity masks travel as one byte per lane; the wrapper converts to and
from ``bool``. A CUDA batch always launches the kernel (or raises); a CPU
batch always takes the plain version below.
"""

from __future__ import annotations

import torch

from ..fields.params import FQ_PARAMS, NUM_LIMBS
from ..groups.group import AffinePoints, JacobianPoints
from . import build
from .field_kernels import limb_field

L = NUM_LIMBS

# Kernel launches per op since the counters were last reset (reset_counts),
# and how many of them ran one lane.
launch_counts = {"dbl": 0, "add": 0, "mixed_add": 0}
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


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------
def dbl(p: JacobianPoints) -> JacobianPoints:
    return _launch_dbl(p) if p.x.is_cuda else plain_dbl(p)


def add(p: JacobianPoints, q: JacobianPoints) -> JacobianPoints:
    return _launch_add(p, q, mixed=False) if p.x.is_cuda else plain_add(p, q)


def mixed_add(p: JacobianPoints, q: AffinePoints) -> JacobianPoints:
    return _launch_add(p, q, mixed=True) if p.x.is_cuda else plain_mixed_add(p, q)
