#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

builds the CUDA kernels from barretenberg_tpu_torch/csrc with nvcc (one
process per source, all at once), holds each against its plain PyTorch
version on the card (exact equality: every value is a canonical field
element) - the MSM bucket kernels also on edge rounds against the host
oracle - reproduces the pinned n = 16 proof digest on the card, checks a
Pippenger MSM against the host oracle, and then drives the main path at
n = 2^16 gates: SRS generation, verifier-key preprocessing,
`Prover.construct_proof`, host `verify_proof`, failing if any kernel was
never launched there. Each phase prints one JSON line and any failing phase
exits non-zero. Without a CUDA device the script exits non-zero and prints
no result.

`--cpu-rehearsal` walks the same control flow at toy sizes on the CPU (plain
versions only) to find wrong paths and shapes without a card; it never
reports success.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.fields import fq as get_fq, fr as get_fr
from barretenberg_tpu_torch.fields.limbs import ints_to_limbs
from barretenberg_tpu_torch.fields.params import FQ_PARAMS, FR_MODULUS, FR_PARAMS, R_INTERNAL
from barretenberg_tpu_torch.groups import AffinePoints, JacobianPoints
from barretenberg_tpu_torch.groups.g1 import fixed_base_mul, g1 as get_g1, jacobian_to_host, points_to_host
from barretenberg_tpu_torch.kernels import build, butterfly, field_kernels, msm_kernels, point_kernels
from barretenberg_tpu_torch.msm import optimal_window, pippenger
from barretenberg_tpu_torch.msm.pippenger import glv_entries
from barretenberg_tpu_torch.plonk import preprocess
from barretenberg_tpu_torch.polynomials import get_domain
from barretenberg_tpu_torch.srs import test_srs
from barretenberg_tpu_torch.transcript.keccak import keccak256
from barretenberg_tpu_torch.utils import host_curve

GOLDEN_DIGEST = "f9b1f779dea05d9cd75e1e34e69dc3ca20b1b131044e767a52f68a9feb50a990"

# Roofline constants (NVIDIA H100 SXM data sheet): memory rate, and the
# integer multiply-add issue rate reckoned from the float32 rate - 67e12
# FLOP/s is 33.5e12 FMA/s over 128 FP32 lanes per SM; the INT32 multiply-add
# has half as many lanes.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 2 / 2
# One Montgomery multiply (csrc/field.cuh): 9 x (2 x 9 + 1) = 171 wide
# 32x32->64 multiplies, each two 32-bit multiply-add instructions.
IMAD_PER_FIELD_MUL = 171 * 2
ELEM_BYTES = 18 * 4
# field multiplications per point operation (csrc/point_kernels.cu)
POINT_MULS = {"dbl": 7, "add": 16, "mixed_add": 11}
# coordinate arrays + mask bytes moved per lane (each input once, each output once)
POINT_BYTES = {"dbl": 6 * ELEM_BYTES, "add": 9 * ELEM_BYTES + 3, "mixed_add": 8 * ELEM_BYTES + 3}
JAC_BYTES = 3 * ELEM_BYTES + 1  # a Jacobian point with its infinity byte
MSM_BLOCK = 128  # pippenger's default block

REPLACES = {
    "field": "barretenberg_tpu/kernels/field_kernels.py:64",
    "butterfly": "barretenberg_tpu/kernels/butterfly.py:79",
    "point": "barretenberg_tpu/kernels/point_kernels.py:179",
    "bucket_accumulate": "barretenberg_tpu/kernels/point_kernels.py:179 (mixed_add) in the lax.scan of barretenberg_tpu/msm/pippenger.py:178",
    "bucket_reduce": "barretenberg_tpu/kernels/point_kernels.py:179 (add) in barretenberg_tpu/msm/pippenger.py:82 and :107",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, why: str) -> None:
    emit({"phase": phase, "ok": False, "error": why})
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(fn, device, reps: int) -> float:
    """Mean milliseconds per call: CUDA events around `reps` calls after one
    warm-up (host clock on the CPU rehearsal)."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def bound(nbytes: float, imads: float):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = imads / IMAD_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_abs_err(got, want) -> int:
    worst = 0
    for g, w in zip(got, want):
        worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return worst


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def rand_values(n: int, p: int, rng) -> list:
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def edge_elements(field, n: int, rng) -> torch.Tensor:
    """Seeded random lanes with the edge values 0, 1, p-1 in front."""
    vals = rand_values(n, field.p, rng)
    vals[:3] = [0, 1, field.p - 1]
    return field.encode(vals)


def edge_points(curve, n: int, rng):
    """Two Jacobian batches P, Q (non-trivial z) and Q's affine form, with
    edge lanes: 0 P=inf, 1 Q=inf, 2 both inf, 3 P==Q, 4 P==-Q."""
    dev, f = curve.device, curve.f
    ks = rand_values(2 * n, FR_MODULUS, rng)
    base = curve.batch_normalize(fixed_base_mul(ks, dev))
    idx = torch.arange(n, device=dev)
    pa = curve.take_affine(base, idx)
    qa = curve.take_affine(base, idx + n)
    qa = AffinePoints(qa.x.clone(), qa.y.clone(), qa.inf.clone())
    qa.x[:, 3], qa.y[:, 3] = pa.x[:, 3], pa.y[:, 3]
    qa.x[:, 4], qa.y[:, 4] = pa.x[:, 4], f.neg(pa.y[:, 4:5])[:, 0]

    def lift(aff, zs):  # (x, y) -> (x z^2, y z^3, z)
        z2 = f.sqr(zs)
        return JacobianPoints(f.mul(aff.x, z2), f.mul(aff.y, f.mul(z2, zs)), zs, aff.inf.clone())

    p = lift(pa, f.encode([v or 1 for v in rand_values(n, f.p, rng)]))
    q = lift(qa, f.encode([v or 1 for v in rand_values(n, f.p, rng)]))
    p.inf[0] = p.inf[2] = True
    q.inf[1] = q.inf[2] = True
    qa.inf[1] = qa.inf[2] = True
    return p, q, qa


def fixture_arrays(n: int, seed: int):
    """The random satisfiable arithmetic-gate circuit of the reference's
    prover tests, as limb arrays: wires, selectors, sigma mappings. Even
    gates w_o = w_l.w_r + w_l + w_r + 1, odd gates q_c = -(w_l + w_r + w_o);
    the upper half repeats the lower half and is wired to it."""
    p = FR_MODULUS
    rng = np.random.default_rng(seed)

    def rand():
        return int.from_bytes(rng.bytes(32), "little") % p

    w_l, w_r, w_o = [0] * n, [0] * n, [0] * n
    q_m, q_l, q_r, q_o, q_c = [0] * n, [0] * n, [0] * n, [0] * n, [0] * n
    for i in range(n // 4):
        e, o = 2 * i, 2 * i + 1
        w_l[e], w_r[e] = rand(), rand()
        w_o[e] = (w_l[e] * w_r[e] + w_l[e] + w_r[e] + 1) % p
        q_m[e], q_l[e], q_r[e], q_o[e], q_c[e] = 1, 1, 1, p - 1, 1
        w_l[o], w_r[o], w_o[o] = rand(), rand(), rand()
        q_c[o] = (-(w_l[o] + w_r[o] + w_o[o])) % p
        q_l[o], q_r[o], q_o[o] = 1, 1, 1
    shift = n // 2
    for arr in (w_l, w_r, w_o, q_m, q_l, q_r, q_o, q_c):
        arr[shift:] = arr[:shift]
    i = np.arange(shift, dtype=np.uint32)
    s1, s2, s3 = (np.zeros(n, dtype=np.uint32) for _ in range(3))
    for col, s in enumerate((s1, s2, s3)):
        s[shift:] = i + (col << 30)
        s[:shift] = i + shift + (col << 30)
        for j in (shift - 1, n - 1):
            s[j] = j + (col << 30)
    for j in (shift - 1, n - 1):
        w_l[j] = w_r[j] = w_o[j] = 0
        q_c[j] = 0
    q_l[n - 1] = q_r[n - 1] = q_o[n - 1] = q_m[n - 1] = 0

    def enc(vals):
        return ints_to_limbs([v * R_INTERNAL % p for v in vals])

    return (
        [enc(w) for w in (w_l, w_r, w_o)],
        [enc(q) for q in (q_m, q_l, q_r, q_o, q_c)],
        (s1, s2, s3),
    )


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def field_op(params, op: str, x, y):
    """K1's public wrapper for one op."""
    if op == "sqr":
        return field_kernels.sqr(params, x)
    return {"mul": field_kernels.mont_mul, "add": field_kernels.add, "sub": field_kernels.sub}[op](params, x, y)


def check_field_kernels(device, lanes_check: int, lanes_time: int, rng, records: list) -> None:
    for params, get in ((FR_PARAMS, get_fr), (FQ_PARAMS, get_fq)):
        field = get(device)
        a, b = edge_elements(field, lanes_check, rng), edge_elements(field, lanes_check, rng)
        col = field.encode([rand_values(1, field.p, rng)[0]])  # (18, 1) broadcast operand
        for op in ("mul", "sqr", "add", "sub"):
            cases = [(a, None)] if op == "sqr" else [(a, b), (a, col), (a[:, ::2], b[:, 1::2])]
            for x, y in cases:
                got = field_op(params, op, x, y)
                want = field_kernels.plain(params, op, x, y)
                if not torch.equal(got, want):
                    fail("kernels", f"field {op} over {params.name} disagrees with its plain version")
    # timing at the main path's widest shape: the 4n = 2^18 quotient domain
    field = get_fr(device)
    a, b = field.random_elements(lanes_time, rng), field.random_elements(lanes_time, rng)
    for op in ("mul", "sqr", "add", "sub"):
        y = None if op == "sqr" else b
        got = field_op(FR_PARAMS, op, a, y)
        want = field_kernels.plain(FR_PARAMS, op, a, y)
        nbytes = (2 if op == "sqr" else 3) * ELEM_BYTES * lanes_time
        imads = IMAD_PER_FIELD_MUL * lanes_time if op in ("mul", "sqr") else 0
        b_ms, b_by = bound(nbytes, imads)
        records.append({
            "name": f"field_{op}", "module": "field", "op": op, "route": "cuda",
            "source": "barretenberg_tpu_torch/csrc/field_kernels.cu",
            "replaces": REPLACES["field"], "shape": [18, lanes_time],
            "max_abs_err": max_abs_err([got], [want]),
            "ms": time_ms(lambda: field_op(FR_PARAMS, op, a, y), device, 50),
            "plain_ms": time_ms(lambda: field_kernels.plain(FR_PARAMS, op, a, y), device, 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })


def check_butterfly(device, log2n_check: int, log2n_time: int, rng, records: list) -> None:
    field = get_fr(device)
    total = 1 << log2n_check
    x = edge_elements(field, total, rng)
    for h in sorted({1, 32, total // 2}):
        for nb in (1, 128):
            if 2 * h * nb > total:
                continue
            g = total // (2 * h * nb)
            x5 = x.reshape(18, g, 2, h, nb)
            for tw in (field.random_elements(h, rng), field.random_elements(2 * h, rng)[:, ::2]):
                got = butterfly.butterfly_stage(FR_PARAMS, x5, tw)
                if not torch.equal(got, butterfly.plain(FR_PARAMS, x5, tw)):
                    fail("kernels", f"butterfly stage h={h} nb={nb} disagrees with its plain version")
    # timing: the mean over all stages of one 4n = 2^18 transform
    n = 1 << log2n_time
    domain = get_domain(n, device)
    x = field.random_elements(n, rng)
    table = domain.twiddles

    def stages(fn):
        for s in range(log2n_time):
            h = 1 << s
            fn(FR_PARAMS, x.reshape(18, n // (2 * h), 2, h, 1), table[:, :: n // (2 * h)][:, :h])

    h = n // 4
    x5, tw = x.reshape(18, 2, 2, h, 1), table[:, ::2][:, :h]
    err = max_abs_err([butterfly.butterfly_stage(FR_PARAMS, x5, tw)], [butterfly.plain(FR_PARAMS, x5, tw)])
    nbytes = 2 * ELEM_BYTES * n + ELEM_BYTES * (n - 1) / log2n_time  # array in+out, twiddles once
    b_ms, b_by = bound(nbytes, IMAD_PER_FIELD_MUL * (n // 2))
    records.append({
        "name": "butterfly_stage", "module": "butterfly", "op": "stage", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/butterfly.cu",
        "replaces": REPLACES["butterfly"], "shape": [18, n], "max_abs_err": err,
        "ms": time_ms(lambda: stages(butterfly.butterfly_stage), device, 10) / log2n_time,
        "plain_ms": time_ms(lambda: stages(butterfly.plain), device, 1) / log2n_time,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })


def check_point_kernels(device, lanes_check: int, shapes: dict, rng, records: list) -> None:
    curve = get_g1(device)
    p, q, qa = edge_points(curve, lanes_check, rng)
    host_p, host_q = jacobian_to_host(p), jacobian_to_host(q)
    ops = {
        "dbl": (lambda a, b, c: point_kernels.dbl(a), lambda a, b, c: point_kernels.plain_dbl(a)),
        "add": (lambda a, b, c: point_kernels.add(a, b), lambda a, b, c: point_kernels.plain_add(a, b)),
        "mixed_add": (lambda a, b, c: point_kernels.mixed_add(a, c), lambda a, b, c: point_kernels.plain_mixed_add(a, c)),
    }
    for op, (kernel, plain) in ops.items():
        got, want = kernel(p, q, qa), plain(p, q, qa)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail("kernels", f"point {op} disagrees with its plain version")
        # and the plain version itself against the host oracle, on the edge lanes
        m = 16
        host = jacobian_to_host(JacobianPoints(got.x[:, :m], got.y[:, :m], got.z[:, :m], got.inf[:m]))
        ref = [host_curve.g1_add(a, a if op == "dbl" else b) for a, b in zip(host_p[:m], host_q[:m])]
        if host != ref:
            fail("kernels", f"point {op} disagrees with the host group law")
    for op, (kernel, plain) in ops.items():
        lanes = shapes[op]
        sub = lambda t: t[..., :lanes].contiguous()
        ps, qs, qas = (type(v)(*(sub(t) for t in v)) for v in (p, q, qa))
        got, want = kernel(ps, qs, qas), plain(ps, qs, qas)
        b_ms, b_by = bound(POINT_BYTES[op] * lanes, POINT_MULS[op] * IMAD_PER_FIELD_MUL * lanes)
        records.append({
            "name": f"point_{op}", "module": "point", "op": op, "route": "cuda",
            "source": "barretenberg_tpu_torch/csrc/point_kernels.cu",
            "replaces": REPLACES["point"], "shape": [18, lanes],
            "max_abs_err": max_abs_err(got[:3], want[:3]),
            "ms": time_ms(lambda: kernel(ps, qs, qas), device, 50),
            "plain_ms": time_ms(lambda: plain(ps, qs, qas), device, 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })


def msm_edge_inputs(device, m: int, nbuckets: int, rng):
    """Four rounds of bucket entries over m points (a multiple of the block):
    round 0 every digit equal (one bucket spans every block), round 1 every
    digit zero (every entry dead), round 2 random signed digits with P and
    -P first in bucket 0 (they cancel), round 3 random with P twice first in
    bucket 0 (a doubling mid-walk); entries 4-11 are points at infinity."""
    curve = get_g1(device)
    pts = curve.batch_normalize(fixed_base_mul(rand_values(m, FR_MODULUS, rng), device))
    px, py, pinf = pts.x.clone(), pts.y.clone(), pts.inf.clone()
    px[:, 1], py[:, 1] = px[:, 0], py[:, 0]
    pinf[4:12] = True
    digits = torch.from_numpy(rng.integers(-nbuckets, nbuckets + 1, size=(4, m))).to(torch.int32)
    digits[0], digits[1] = 3, 0
    digits[2, :2] = torch.tensor([1, -1])
    digits[3, :2] = 1
    return digits.to(device), px, py, pinf


def accumulate_madds(entries, pinf, nbuckets: int, block: int) -> int:
    """Mixed adds this input needs: live entries that do not start a run of
    their bucket within their block."""
    rounds, m = entries.bucket.shape
    b = entries.bucket.reshape(rounds, m // block, block)
    first = torch.ones_like(b, dtype=torch.bool)
    first[..., 1:] = b[..., 1:] != b[..., :-1]
    live = (entries.bucket < nbuckets) & ~pinf[entries.order]
    return int((live & ~first.reshape(rounds, m)).sum())


def reduce_adds(cd: torch.Tensor, nbuckets: int) -> int:
    """Adds this input needs: the segmented scan's lanes that take a sum, the
    first suffix scan, and the lanes of the second that feed the window."""
    rounds, k = cd.shape
    idx = torch.arange(k, device=cd.device)
    fl = torch.ones_like(cd, dtype=torch.bool)
    fl[:, 1:] = cd[:, 1:] != cd[:, :-1]
    adds = 0
    for i in range(max(1, (k - 1).bit_length())):
        d = 1 << i
        adds += int((~fl & (idx >= d)).sum())
        fl = fl | (torch.roll(fl, d, dims=1) & (idx >= d))
    for i in range(max(1, (nbuckets - 1).bit_length())):
        d = 1 << i
        adds += rounds * (max(0, nbuckets - d) + -(-max(0, nbuckets - d) // (2 * d)))
    return adds


def same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def check_msm_kernels(device, log2n: int, edge_m: int, rng, records: list) -> None:
    """K3a and K3b against their plain versions (exact), on edge rounds
    (also against the host oracle) and at the main path's MSM shape."""
    c = 10
    nb = 1 << (c - 1)
    digits, px, py, pinf = msm_edge_inputs(device, edge_m, nb, rng)
    entries = msm_kernels.sort_rounds(digits, nb)
    got = msm_kernels.bucket_accumulate(entries, px, py, pinf, nb, MSM_BLOCK)
    want = msm_kernels.plain_bucket_accumulate(entries, px, py, pinf, nb, MSM_BLOCK)
    if not (torch.equal(got.bucket, want.bucket) and same(got.points, want.points)):
        fail("kernels", "bucket_accumulate disagrees with its plain version on the edge rounds")
    win = msm_kernels.bucket_reduce(got, nb)
    if not same(win, msm_kernels.plain_bucket_reduce(got, nb)):
        fail("kernels", "bucket_reduce disagrees with its plain version on the edge rounds")
    host_pts = points_to_host(AffinePoints(px, py, pinf))
    oracle = [host_curve.g1_msm(host_pts, [int(d) % FR_MODULUS for d in row]) for row in digits.tolist()]
    if jacobian_to_host(win) != oracle:
        fail("kernels", "bucket_reduce window sums disagree with the host oracle on the edge rounds")

    # the main path's shape: one 2^log2n-point MSM, all rounds
    n = 1 << log2n
    c = optimal_window(n)
    nb = 1 << (c - 1)
    curve, fr = get_g1(device), get_fr(device)
    pts = curve.batch_normalize(fixed_base_mul(rand_values(n, FR_MODULUS, rng), device))
    digits, px, py, pinf = glv_entries(fr.encode(rand_values(n, FR_MODULUS, rng)), pts, c, MSM_BLOCK)
    rounds, m = digits.shape
    entries = msm_kernels.sort_rounds(digits, nb)
    got = msm_kernels.bucket_accumulate(entries, px, py, pinf, nb, MSM_BLOCK)
    want = msm_kernels.plain_bucket_accumulate(entries, px, py, pinf, nb, MSM_BLOCK)
    acc_err = max(int((got.bucket - want.bucket).abs().max()), max_abs_err(got.points, want.points))
    if acc_err:
        fail("kernels", f"bucket_accumulate disagrees with its plain version at {rounds} x {m} entries")
    win = msm_kernels.bucket_reduce(got, nb)
    red_err = max_abs_err(win, msm_kernels.plain_bucket_reduce(got, nb))
    if red_err:
        fail("kernels", f"bucket_reduce disagrees with its plain version at {rounds} rounds")
    k = got.bucket.shape[1]
    partial_bytes = rounds * k * (JAC_BYTES + 4)
    b_ms, b_by = bound(rounds * m * 4 + m * (2 * ELEM_BYTES + 1) + partial_bytes,
                       accumulate_madds(entries, pinf, nb, MSM_BLOCK) * POINT_MULS["mixed_add"] * IMAD_PER_FIELD_MUL)
    records.append({
        "name": "bucket_accumulate", "module": "msm", "op": "bucket_accumulate", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/msm_kernels.cu", "replaces": REPLACES["bucket_accumulate"],
        "shape": [rounds, m, MSM_BLOCK], "max_abs_err": acc_err,
        "ms": time_ms(lambda: msm_kernels.bucket_accumulate(entries, px, py, pinf, nb, MSM_BLOCK), device, 10),
        "plain_ms": time_ms(lambda: msm_kernels.plain_bucket_accumulate(entries, px, py, pinf, nb, MSM_BLOCK), device, 1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    b_ms, b_by = bound(partial_bytes + rounds * JAC_BYTES,
                       reduce_adds(got.bucket, nb) * POINT_MULS["add"] * IMAD_PER_FIELD_MUL)
    records.append({
        "name": "bucket_reduce", "module": "msm", "op": "bucket_reduce", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/msm_kernels.cu", "replaces": REPLACES["bucket_reduce"],
        "shape": [rounds, k, nb], "max_abs_err": red_err,
        "ms": time_ms(lambda: msm_kernels.bucket_reduce(got, nb), device, 10),
        "plain_ms": time_ms(lambda: msm_kernels.plain_bucket_reduce(got, nb), device, 1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })


# ---------------------------------------------------------------------------
COUNTED = {"field": field_kernels, "butterfly": butterfly, "point": point_kernels, "msm": msm_kernels}


def reset_counts() -> None:
    for mod in COUNTED.values():
        mod.reset_counts()


def read_counts() -> dict:
    return {name: dict(mod.launch_counts) for name, mod in COUNTED.items()}


def prove_and_verify(n: int, seed: int, device, timings=None):
    srs = test_srs(n, device=device)
    wires, selectors, sigmas = fixture_arrays(n, seed)
    prover = convert.prover_from_arrays(n, srs, wires, selectors, sigmas)
    verifier = preprocess(convert.prover_from_arrays(n, srs, wires, selectors, sigmas))
    proof = prover.construct_proof(timings)
    accepted = verifier.verify_proof(proof)
    tampered = copy.deepcopy(proof)
    tampered.w_l_eval = (tampered.w_l_eval + 1) % FR_MODULUS
    return proof, accepted, verifier.verify_proof(tampered)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-n", type=int, default=16, help="gates of the main-path circuit")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="toy sizes on the CPU, plain versions only; never reports success")
    args = ap.parse_args()

    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = torch.device("cpu") if rehearsal else torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    log2n = 4 if rehearsal else args.log2_n
    t_start = time.perf_counter()

    # ---- phase 1: device + build -----------------------------------------
    smi = "cpu rehearsal"
    if not rehearsal:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        build_s = build.build_all(force=True)
        usage = {
            name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            for name, log in build.build_log.items()
        }
        emit({"phase": "device", "ok": True, "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_seconds": round(build_s, 2), "ptxas": usage})

    # ---- phase 2: kernels -------------------------------------------------
    records: list = []
    lanes = 256 if rehearsal else 1 << 16
    wide = 512 if rehearsal else 4 << log2n
    check_field_kernels(device, lanes, wide, rng, records)
    check_butterfly(device, 8 if rehearsal else 16, 6 if rehearsal else log2n + 2, rng, records)
    # lanes per launch on the main path: SRS generation's fixed-base mixed
    # adds run over all n lanes; the MSM's window combine (the Horner chain)
    # doubles and adds single lanes
    point_shapes = {"dbl": 1, "add": 1, "mixed_add": min(lanes, 1 << log2n)}
    check_point_kernels(device, lanes, point_shapes, rng, records)
    check_msm_kernels(device, log2n, 8 * MSM_BLOCK if rehearsal else 16 * MSM_BLOCK, rng, records)
    emit({"phase": "kernels", "ok": True, "lanes_checked": lanes, "kernels": [
        {k: r[k] for k in ("name", "shape", "max_abs_err", "ms", "plain_ms")} | {"ok": True} for r in records]})

    # ---- phase 3: golden digest ------------------------------------------
    proof, accepted, tampered_accepted = prove_and_verify(16, 7, device)
    blob = proof.serialize()
    digest = keccak256(blob).hex()
    if len(blob) != 800 or digest != GOLDEN_DIGEST or not accepted or tampered_accepted:
        fail("golden", f"bytes={len(blob)} digest={digest} accepted={accepted} tampered_accepted={tampered_accepted}")
    emit({"phase": "golden", "ok": True, "bytes": len(blob), "digest": digest})

    # ---- phase 4: MSM against the host oracle ----------------------------
    m = 64 if rehearsal else 1 << 12
    curve, fr = get_g1(device), get_fr(device)
    pts = curve.batch_normalize(fixed_base_mul(rand_values(m, FR_MODULUS, rng), device))
    scalars = rand_values(m, FR_MODULUS, rng)
    t0 = time.perf_counter()
    got = jacobian_to_host(pippenger(fr.encode(scalars), pts, c=4 if rehearsal else None))
    t_dev = time.perf_counter() - t0
    if got != [host_curve.g1_msm(points_to_host(pts), scalars)]:
        fail("msm_oracle", "pippenger disagrees with host_curve.g1_msm")
    emit({"phase": "msm_oracle", "ok": True, "n": m, "pippenger_seconds": round(t_dev, 3)})

    # ---- phase 5: the slice at a real size --------------------------------
    # the main path is SRS generation + preprocess + prove + verify; the
    # launch counts cover both windows, so that every kernel must run on it
    n = 1 << log2n
    reset_counts()
    t0 = time.perf_counter()
    test_srs(n, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    srs_s = time.perf_counter() - t0
    srs_counts = read_counts()
    timings: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    proof, accepted, tampered_accepted = prove_and_verify(n, args.seed, device, timings)
    total_s = time.perf_counter() - t0
    counts = read_counts()
    main_counts = {mod: {op: v + srs_counts[mod][op] for op, v in c.items()} for mod, c in counts.items()}
    if not accepted or tampered_accepted:
        fail("prove", f"n={n} accepted={accepted} tampered_accepted={tampered_accepted}")
    if not rehearsal:
        idle = [f"{mod}.{op}" for mod, c in main_counts.items() for op, v in c.items() if v == 0]
        if idle:
            fail("prove", f"kernels never launched on the main path (SRS generation + prove): {idle}")
    emit({"phase": "prove", "ok": True, "n": n, "srs_seconds": round(srs_s, 3),
          "prove_seconds": round(sum(timings.values()), 3), "phase_seconds": timings,
          "preprocess_prove_verify_seconds": round(total_s, 3), "launches": counts,
          "srs_launches": srs_counts,
          "peak_device_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None})

    # ---- results ----------------------------------------------------------
    for r in records:
        r["launches"] = main_counts[r.pop("module")][r.pop("op")]
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 1)})
    emit({"kernels": records})
    print(smi, flush=True)
    if rehearsal:
        emit({"ok": False, "rehearsal": "cpu"})
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
