"""Structured reference string (powers-of-tau SRS) handling.

Mirrors the reference's ReferenceString + io::read_transcript. Two sources:
  * `load(path, degree)` - the reference's trusted-setup transcript format
    (BE-serialized points);
  * `generate(degree, secret)` - a device-computed fake SRS for tests and
    smoke runs ([tau^i]G via the fixed-base window table; the real library
    never generates - its SRS is an input artifact).
"""

from __future__ import annotations

import functools
import struct

import torch

from ..config import resolve_device
from ..fields import fq as _fq
from ..fields.params import FR_MODULUS
from ..groups import AffinePoints
from ..groups.g1 import fixed_base_mul, g1 as _g1, points_to_host
from ..utils import host_curve

_WORD_MASK = (1 << 64) - 1


def _read_fq(buf: bytes, off: int) -> int:
    """4 x u64, least-significant word first, each word big-endian."""
    v = 0
    for j in range(4):
        word = int.from_bytes(buf[off + 8 * j : off + 8 * j + 8], "big")
        v |= word << (64 * j)
    return v


def _write_fq(v: int) -> bytes:
    return b"".join(
        ((v >> (64 * j)) & _WORD_MASK).to_bytes(8, "big") for j in range(4)
    )


class ReferenceString:
    """monomials: AffinePoints batch of [1, tau, tau^2, ...]G (degree points)
    on one device; g2_x: host G2 affine point ((x0,x1),(y0,y1)) = [tau]G2."""

    def __init__(self, monomials: AffinePoints, g2_x, degree: int):
        self.monomials = monomials
        self.g2_x = g2_x
        self.degree = degree
        self._pip_tables: dict = {}

    def pippenger_table(self, n: int):
        """The precomputed Pippenger table of the first n monomials
        (msm/pippenger.py::generate_pippenger_point_table), built on the
        monomials' device at first use and cached per n: commitments against
        it need one bucket set and no Horner combine."""
        tab = self._pip_tables.get(n)
        if tab is None:
            from ..msm.pippenger import generate_pippenger_point_table

            dev = self.monomials.x.device
            pts = _g1(dev).take_affine(self.monomials, torch.arange(n, device=dev))
            tab = generate_pippenger_point_table(pts)
            self._pip_tables[n] = tab
        return tab

    # -- constructors -------------------------------------------------------
    @staticmethod
    def load(path: str, degree: int, device=None) -> "ReferenceString":
        """Parse the reference's transcript format: 28-byte network-order
        manifest, num_g1_points G1 points, 2 G2 points; the first monomial
        is the plain generator, file points fill [1..degree)."""
        fq = _fq(device)
        with open(path, "rb") as f:
            buf = f.read()
        (_, _, _, _, num_g1, _num_g2, _) = struct.unpack(">7I", buf[:28])
        assert num_g1 >= degree - 1, "transcript too small for degree"
        xs = [1]
        ys = [2]
        off = 28
        for i in range(degree - 1):
            xs.append(_read_fq(buf, off + 64 * i))
            ys.append(_read_fq(buf, off + 64 * i + 32))
        g2_off = off + 64 * num_g1 + 128  # skip [1]_2, read [x]_2
        g2_x = (
            (_read_fq(buf, g2_off), _read_fq(buf, g2_off + 32)),
            (_read_fq(buf, g2_off + 64), _read_fq(buf, g2_off + 96)),
        )
        monomials = AffinePoints(
            fq.encode(xs),
            fq.encode(ys),
            torch.zeros(degree, dtype=torch.bool, device=fq.device),
        )
        return ReferenceString(monomials, g2_x, degree)

    @staticmethod
    def save(path: str, monomial_values: list, g2_x) -> None:
        """Write a transcript file in the reference format (points are host
        (x, y) int tuples EXCLUDING the leading generator)."""
        n = len(monomial_values)
        manifest = struct.pack(">7I", 0, 1, n, 2, n, 2, 0)
        out = [manifest]
        for x, y in monomial_values:
            out.append(_write_fq(x))
            out.append(_write_fq(y))
        g2_gen = host_curve.G2_GENERATOR
        for pt in (g2_gen, g2_x):
            out.append(_write_fq(pt[0][0]))
            out.append(_write_fq(pt[0][1]))
            out.append(_write_fq(pt[1][0]))
            out.append(_write_fq(pt[1][1]))
        out.append(b"\x00" * 64)  # checksum placeholder
        with open(path, "wb") as f:
            f.write(b"".join(out))

    @staticmethod
    def generate(degree: int, secret: int, device=None) -> "ReferenceString":
        """Test/smoke SRS: [tau^i]G1 for i < degree plus [tau]G2.

        The tau powers are host ints (cheap); the degree generator
        multiplications run via the fixed-base window table
        (groups/g1.fixed_base_mul): 32 gather + mixed-add steps over all
        lanes, no doublings, one K3e launch on the card; then one batched
        normalisation of all of them (one K1 pow and two K1 scans)."""
        dev = resolve_device(device)
        tau = secret % FR_MODULUS
        powers = [1] * degree
        for i in range(1, degree):
            powers[i] = powers[i - 1] * tau % FR_MODULUS
        mono_jac = fixed_base_mul(powers, dev)
        monomials = _g1(dev).batch_normalize(mono_jac)
        g2_x = host_curve.g2_mul(host_curve.G2_GENERATOR, tau)
        return ReferenceString(monomials, g2_x, degree)

    # -- views --------------------------------------------------------------
    @functools.cached_property
    def g2_miller_lines(self):
        """Precomputed Miller lines for ([1]_2, [x]_2) - the verifier
        reference string."""
        from ..pairing import tower

        return (
            tower.precompute_miller_lines(host_curve.G2_GENERATOR),
            tower.precompute_miller_lines(self.g2_x),
        )

    def monomials_host(self) -> list:
        return points_to_host(self.monomials)

    def srs_pairing_check(self) -> bool:
        """e(-[x]_1, [1]_2) * e([1]_1, [x]_2) == 1 (the SRS sanity gate)."""
        from ..pairing import pairing_check

        first_two = _g1(self.monomials.x.device).take_affine(
            self.monomials, torch.arange(2, device=self.monomials.x.device)
        )
        pts = points_to_host(first_two)
        return pairing_check(
            [
                (host_curve.g1_neg(pts[1]), host_curve.G2_GENERATOR),
                (pts[0], self.g2_x),
            ]
        )


@functools.lru_cache(maxsize=4)
def _test_srs(degree: int, secret: int, device: torch.device) -> ReferenceString:
    return ReferenceString.generate(degree, secret, device)


def test_srs(degree: int, secret: int = 0xA11CE, device=None) -> ReferenceString:
    """Cached deterministic SRS for tests and smoke runs."""
    return _test_srs(degree, secret, resolve_device(device))


test_srs.__test__ = False  # a fixture factory, not a pytest test
