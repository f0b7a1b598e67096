"""BN254 G1 instantiation (reference: curves/bn254/g1.hpp).

Curve: y^2 = x^3 + 3 over Fq, generator (1, 2). ``g1(device)`` returns the
one cached ``Curve`` per device (default: the CUDA card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import resolve_device
from ..fields import fq as _fq
from ..fields.params import FQ_MODULUS, FR_MODULUS
from ..transcript.keccak import keccak256
from ..utils import host_curve
from .group import AffinePoints, Curve, JacobianPoints


@functools.lru_cache(maxsize=None)
def _g1(device: torch.device) -> Curve:
    return Curve(_fq(device), b_value=3, generator_xy=(1, 2))


def g1(device=None) -> Curve:
    return _g1(resolve_device(device))


def points_to_host(p: AffinePoints) -> list:
    """Affine device batch -> list of host (x, y) tuples / None."""
    fq = _fq(p.x.device)
    xs = fq.decode(p.x)
    ys = fq.decode(p.y)
    infs = p.inf.cpu().numpy()
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


def jacobian_to_host(p: JacobianPoints) -> list:
    return points_to_host(g1(p.x.device).batch_normalize(p))


def host_to_affine_points(pts: list, device=None) -> AffinePoints:
    fq = _fq(device)
    xs = [0 if pt is None else pt[0] for pt in pts]
    ys = [0 if pt is None else pt[1] for pt in pts]
    inf = torch.tensor([pt is None for pt in pts], dtype=torch.bool, device=fq.device)
    return AffinePoints(fq.encode(xs), fq.encode(ys), inf)


@functools.lru_cache(maxsize=None)
def _fixed_base_table_host() -> tuple:
    """32 * 256 host points: entry [w*256 + k] = [k * 2^(8w)]G (~8k host
    group adds, built once). For a FIXED base the whole window table
    precomputes, so a 254-bit multiply needs 32 gathers + 32 mixed adds and
    zero doublings."""
    pts: list = []
    base = host_curve.G1_GENERATOR
    for _w in range(32):
        cur = None
        row = [None]
        for _k in range(255):
            cur = host_curve.g1_add(cur, base)
            row.append(cur)
        pts.extend(row)
        base = host_curve.g1_add(cur, base)  # 256*2^(8w)*G = 2^(8(w+1))*G
    return tuple(pts)


@functools.lru_cache(maxsize=None)
def fixed_base_table(device: torch.device) -> torch.Tensor:
    """The 32 * 256 window table on one device, built once, as the
    (8192, 20) point rows K3e reads (``point_kernels.point_table``)."""
    from ..kernels import point_kernels

    return point_kernels.point_table(*host_to_affine_points(list(_fixed_base_table_host()), device))


def fixed_base_digits(scalars: list, device=None) -> torch.Tensor:
    """Host-int scalars -> (32, n) uint8 window digits (the little-endian
    bytes of each scalar mod r) on the device."""
    n = len(scalars)
    buf = np.frombuffer(
        b"".join((int(s) % FR_MODULUS).to_bytes(32, "little") for s in scalars),
        dtype=np.uint8,
    ).reshape(n, 32)
    return torch.from_numpy(np.ascontiguousarray(buf.T)).to(resolve_device(device))


def scalars_to_bits_msb(scalars: list, nbits: int = 254, device=None) -> torch.Tensor:
    """Host ints -> (nbits, N) uint8 bits, most significant first, on the
    device (the input K3d takes)."""
    n = len(scalars)
    buf = np.frombuffer(b"".join(int(s).to_bytes(32, "big") for s in scalars), dtype=np.uint8).reshape(n, 32)
    bits = np.unpackbits(buf, axis=1)[:, 256 - nbits :]
    return torch.from_numpy(np.ascontiguousarray(bits.T)).to(resolve_device(device))


def random_points_device(n: int, rng: np.random.Generator, device=None) -> AffinePoints:
    """n random multiples of the generator: one K3d launch over n lanes (each
    reading the one generator point) and one batched normalisation. The
    scalars are drawn from ``rng`` as the JAX package draws them (32 bytes
    each, mod r, 0 -> 1), so one seed gives its points."""
    scalars = [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS or 1 for _ in range(n)]
    curve = g1(device)
    bits = scalars_to_bits_msb(scalars, device=curve.device)
    return curve.batch_normalize(curve.scalar_mul_bits(curve.generator(1), bits))


def _x_candidate(seed: bytes, lane: int, attempt: int) -> int:
    h = keccak256(seed + lane.to_bytes(8, "little") + attempt.to_bytes(4, "little"))
    return int.from_bytes(h, "big") % FQ_MODULUS


def hash_to_curve(seed: bytes, n: int = 1, attempts: int = 8, device=None) -> AffinePoints:
    """Deterministic hash-to-curve for n G1 points (the reference's
    rejection walk): x candidates are keccak256(seed || lane || attempt) mod
    q on the host; each lane takes its first x with x^3 + 3 a quadratic
    residue and y = sqrt(x^3 + 3) = (x^3 + 3)^((q+1)/4). The roots of all n
    * attempts candidates are one K1 ``pow`` launch; lanes that miss every
    attempt (probability ~2^-attempts) finish on the host."""
    fq = _fq(device)
    xs = fq.encode([_x_candidate(seed, lane, j) for lane in range(n) for j in range(attempts)])
    yy = fq.add(fq.mul(fq.sqr(xs), xs), fq.const(3).reshape(18, 1))
    y = fq.sqrt(yy)
    ok = fq.eq(fq.sqr(y), yy).cpu().numpy().reshape(n, attempts)
    cols = torch.from_numpy(np.arange(n) * attempts + np.argmax(ok, axis=1)).to(fq.device)
    x_sel, y_sel = xs.index_select(1, cols), y.index_select(1, cols)
    misses = np.nonzero(~ok.any(axis=1))[0]
    if len(misses):  # host completion of the rare exhausted lanes
        fix_x, fix_y = [], []
        for lane in misses:
            j = attempts
            while True:
                x = _x_candidate(seed, int(lane), j)
                yy = (x * x % fq.p * x + 3) % fq.p
                yv = pow(yy, (fq.p + 1) // 4, fq.p)
                if yv * yv % fq.p == yy:
                    fix_x.append(x)
                    fix_y.append(yv)
                    break
                j += 1
        midx = torch.from_numpy(misses).to(fq.device)
        x_sel[:, midx] = fq.encode(fix_x)
        y_sel[:, midx] = fq.encode(fix_y)
    return AffinePoints(x_sel, y_sel, torch.zeros(n, dtype=torch.bool, device=fq.device))


def random_affine_points(n: int, rng: np.random.Generator, device=None) -> AffinePoints:
    """Seeded random on-curve affine points: hash_to_curve of 32 bytes of
    ``rng`` (as the JAX package draws them)."""
    return hash_to_curve(rng.bytes(32), n, device=device)


def scalar_mul_glv(p: AffinePoints, scalars_mont: torch.Tensor, c: int = 5) -> JacobianPoints:
    """Arbitrary-base GLV + signed-window scalar multiplication: per lane
    k = k1 - k2 lambda with 128-bit halves, k1 walked against the lane's
    table T and k2 against psi(T) = (beta x, -y, z), sharing the doublings.
    One K4 launch (the split and the digits) and one K3g launch."""
    from ..kernels import msm_kernels, point_kernels

    n = p.x.shape[1]
    rounds = msm_kernels.digit_rounds(c)
    digits = msm_kernels.glv_digits(scalars_mont, 1, c, rounds * 2 * n).reshape(rounds, 2, n)
    return point_kernels.glv_walk(p, digits, c)


def scalar_mul(p: AffinePoints, scalar: int) -> JacobianPoints:
    """Multiply a batch of affine points by one host-known scalar: one K3d
    launch over the scalar's bits (the bit column materialised for every
    lane); scalar 0 gives infinity."""
    curve = g1(p.x.device)
    scalar = int(scalar) % FR_MODULUS
    n = p.x.shape[1]
    if scalar == 0:
        return curve.infinity(n)
    nbits = scalar.bit_length()
    bits = torch.tensor([(scalar >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=torch.uint8)
    return curve.scalar_mul_bits(p, bits.to(curve.device).reshape(nbits, 1).expand(nbits, n).contiguous())


def fixed_base_mul(scalars: list, device=None) -> JacobianPoints:
    """[k_i]G for a list of host-int scalars, via the window table: 32
    gather + mixed-add steps for any batch size, one K3e launch on the card
    (the fast path for SRS generation and any generator exponentiation)."""
    from ..kernels import point_kernels

    dev = resolve_device(device)
    return point_kernels.fixed_base(fixed_base_digits(scalars, dev), fixed_base_table(dev))
