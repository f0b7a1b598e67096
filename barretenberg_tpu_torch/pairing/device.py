"""Batched optimal-ate pairing on the card, and the SRS checks built on it.

Port of the JAX package's ``pairing/device.py`` (reference:
curves/bn254/pairing.cpp:162-331; test_io.cpp:12's SRS gate). The host
tower (pairing/tower.py) is the oracle.

Lanes hold independent pairings e(P, Q); a group of g consecutive lanes is
one product prod e(P_i, Q_i) (the verifier / SRS-check shape), and every
group has the same g. Per call:

* the Miller lines come from the host precompute
  (``tower.precompute_miller_lines``, pairing.cpp:120-160), computed and
  encoded once per distinct G2 point - an SRS check has two, [tau]G2 and
  the generator - into a table the kernel reads by each lane's Q index;
* K5a ``miller_loop`` runs every lane's whole Miller loop in one launch,
  scaling each line by the lane's P as it reads it;
* K5b ``final_exp`` folds each group's lanes and runs the final
  exponentiation in one launch (kernels/pairing_kernels.py).

``_prepare_lines`` returns that compact form with the JAX package's step
indices ``i1`` / ``i2``; ``expand_lines`` gives the JAX package's per-lane
line layout (three (L + 1, 2, 18, B) arrays, the identity row last) from it.
Entry points run on the card unless a CPU device is passed (the plain
versions then run); nothing falls back to the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import resolve_device
from ..fields import fq as _fq, fr as _fr
from ..fields.quadratic import QuadraticField
from ..fields.tower import SexticField, TwelfthField
from ..kernels import pairing_kernels
from ..utils import host_curve
from . import tower as ht

L = 18


@functools.lru_cache(maxsize=None)
def _fq12(device: torch.device) -> TwelfthField:
    return TwelfthField(SexticField(QuadraticField(_fq(device))))


def fq12(device=None) -> TwelfthField:
    """The lane-wise Fq12 tower on `device`."""
    return _fq12(resolve_device(device))


@functools.lru_cache(maxsize=64)
def _q_lines(q) -> tuple:
    return tuple(ht.precompute_miller_lines(q))


# ---------------------------------------------------------------------------
# line preparation
# ---------------------------------------------------------------------------
def _prepare_lines(groups, device=None):
    """groups: list of groups; each group a list of (P, Q[, lines]) with P =
    (px, py) host ints, Q = G2 affine ((x0, x1), (y0, y1)), or None when
    precomputed `lines` are passed. Returns ((table, q_idx, px, py), (i1,
    i2), (n_groups, group_size)): the line table (nq, L, 3, 2, 18) of the
    distinct line lists, each lane's row of it (int32), the lanes' P in
    internal Montgomery form ((18, B) each), the per-NAF-step line indices
    (L is the identity line) and the lane layout."""
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError("all groups must have the same size")
    gsize = sizes.pop()
    fq = _fq(device)
    flat = [pair for grp in groups for pair in grp]
    keys: dict = {}
    distinct, q_idx = [], []
    for entry in flat:
        lines = entry[2] if len(entry) > 2 and entry[2] is not None else None
        key = ("lines", id(lines)) if lines is not None else ("q", entry[1])
        if key not in keys:
            keys[key] = len(distinct)
            distinct.append(lines if lines is not None else _q_lines(entry[1]))
        q_idx.append(keys[key])
    n_lines = len(distinct[0])
    if any(len(lines) != n_lines for lines in distinct):
        raise ValueError("every line list must have the same length")
    vals = [v for lines in distinct for line in lines for coord in line for v in coord]
    table = fq.encode(vals).reshape(L, len(distinct), n_lines, 3, 2).permute(1, 2, 3, 4, 0).contiguous()
    q_idx = torch.tensor(q_idx, dtype=torch.int32, device=fq.device)
    px = fq.encode([entry[0][0] for entry in flat])
    py = fq.encode([entry[0][1] for entry in flat])
    i1, i2 = pairing_kernels.miller_steps(n_lines)
    return (table, q_idx, px, py), (i1, i2), (len(groups), gsize)


def expand_lines(table, q_idx, px, py):
    """The JAX package's line arrays from ``_prepare_lines``' compact form:
    (o, vw P.y, vv P.x), each (L + 1, 2, 18, B), row L the identity line
    ((1, 0), (0, 0), (0, 0)) of every lane."""
    fq = _fq(px.device)
    lanes = table.index_select(0, q_idx.long()).permute(4, 1, 2, 3, 0)  # (18, L, 3, 2, B)
    o = lanes[:, :, 0]
    vw = fq.mul(lanes[:, :, 1], py.unsqueeze(1).unsqueeze(1))
    vv = fq.mul(lanes[:, :, 2], px.unsqueeze(1).unsqueeze(1))
    b = px.shape[1]
    one, zero = fq.full((b,), fq.one), fq.zeros((b,))
    ident_o = torch.stack([one, zero], dim=1).unsqueeze(1)  # (18, 1, 2, B)
    ident_v = torch.zeros_like(ident_o)
    return tuple(
        torch.cat([arr, row], dim=1).movedim(0, 2) for arr, row in zip((o, vw, vv), (ident_o, ident_v, ident_v))
    )


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def reduced_ate_pairing_groups(groups, device=None):
    """For each group [(P, Q[, lines]), ...]: the product of the group's
    reduced ate pairings, computed on `device` (default: the card) - one
    K5a and one K5b launch for all groups. Returns host tower-fq12 values,
    one per group."""
    (table, q_idx, px, py), (i1, i2), (_, gsize) = _prepare_lines(groups, device)
    f = pairing_kernels.miller_loop(table, q_idx, px, py, i1, i2)
    out = pairing_kernels.final_exp(f, gsize)
    return _fq12(torch.device("cpu")).decode(out.cpu())


def reduced_ate_pairing(p, q, device=None) -> tuple:
    """Single pairing e(P, Q) on `device`; host tower-fq12 result
    (pairing.cpp:333-347's entry)."""
    return reduced_ate_pairing_groups([[(p, q)]], device)[0]


def pairing_check_groups(groups, device=None) -> list[bool]:
    """True per group iff the group's pairing product is one (the verifier /
    SRS-check shape e(A, Q1) * e(B, Q2) == 1)."""
    return [ht.fq12_eq_one(r) for r in reduced_ate_pairing_groups(groups, device)]


def srs_on_curve_all(srs) -> bool:
    """y^2 == x^3 + 3 for EVERY monomial, one lane-wise sweep on the
    monomials' device (test_io.cpp:12 checks all loaded points on-curve):
    four K1 launches on the card."""
    mono = srs.monomials
    fq = _fq(mono.x.device)
    lhs = fq.sqr(mono.y)
    rhs = fq.add(fq.mul(fq.sqr(mono.x), mono.x), fq.const(3).reshape(L, 1))
    return bool(fq.eq(lhs, rhs).all())


def validate_srs_rlc(srs, seed: int = 0xC0FFEE) -> bool:
    """Full-coverage SRS consistency via one random linear combination:
    e(-sum_i r_i [tau^i]G, [tau]G2) * e(sum_i r_i [tau^(i+1)]G, G2) == 1
    holds for random r iff every adjacent pair is tau-consistent (up to
    2^-254 soundness error). Two MSMs and one two-pairing product cover all
    degree indices - the cryptographic scale-up of test_io.cpp:12's
    per-index pairing gate. r is drawn as the JAX package draws it."""
    from ..groups.g1 import g1, jacobian_to_host
    from ..msm import msm

    d = srs.degree
    dev = srs.monomials.x.device
    fr = _fr(dev)
    r = fr.random_elements(d, np.random.default_rng(seed))
    zero = fr.zeros((1,))
    r_lo = torch.cat([r[:, : d - 1], zero], dim=1)  # r_i at i < d - 1
    r_hi = torch.cat([zero, r[:, : d - 1]], dim=1)  # r_i at i + 1
    pts = g1(dev).take_affine(srs.monomials, torch.arange(d, device=dev))
    a = jacobian_to_host(msm(r_lo, pts))[0]
    b = jacobian_to_host(msm(r_hi, pts))[0]
    return pairing_check_groups(
        [[(host_curve.g1_neg(a), srs.g2_x), (b, host_curve.G2_GENERATOR)]], dev
    )[0]


def validate_srs_device(srs, indices=None) -> bool:
    """Batched SRS consistency proof: e(-[tau^i]G, [tau]G2) * e([tau^(i+1)]G,
    G2) == 1 for every sampled i (default: every i < degree - 1), all lanes
    in one K5a and one K5b launch (the scaled-up analog of test_io.cpp:12's
    pairing gate). Only the sampled columns are decoded to the host."""
    from ..groups.g1 import g1, points_to_host

    if indices is None:
        indices = range(srs.degree - 1)
    indices = list(indices)
    dev = srs.monomials.x.device
    cols = sorted({i for i in indices} | {i + 1 for i in indices})
    sampled = points_to_host(g1(dev).take_affine(srs.monomials, torch.tensor(cols, device=dev)))
    col_pos = {c: k for k, c in enumerate(cols)}
    groups = [
        [
            (host_curve.g1_neg(sampled[col_pos[i]]), srs.g2_x),
            (sampled[col_pos[i + 1]], host_curve.G2_GENERATOR),
        ]
        for i in indices
    ]
    return all(pairing_check_groups(groups, dev))
