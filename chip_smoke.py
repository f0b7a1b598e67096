#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

builds the CUDA kernels from barretenberg_tpu_torch/csrc with nvcc (one
process per source, all at once), holds each against its plain PyTorch
version on the card (exact equality: every value is a canonical field
element) - K1 scan (prefix and suffix products and the affine recurrence,
at ragged sizes, around a warp's 32 and a CTA's 1,024 elements and at
every size the prove scans, each scan 3 times back to back), K1 dot and lincomb (1 row or term, the prove's 5 rows and 9
terms and one more than a launch takes, at 1, 3, 2^11, n and 3n lanes,
with zero, p - 1, broadcast and strided operands), the MSM bucket kernels, the window combine and the lane-wise
point chains (K3d scalar_mul_bits at 16, 3 x 16, 3 x 2048 and 5 x 2048
lanes, K3e fixed_base at 16 and 2^16 lanes) also on edge cases against the
host oracle, the field power also against Python's pow, the precomputed
table's kernels (K3f table_rows, K3a over the table's rows at block 128
and at the block a commit call picks, K3b-wide bucket_reduce_wide with its
default and forced small bucket ranges) at the table shapes of both proves
and at c = 13, K3b-wide also on one-bucket sets
and at the small shape on a sparse set against the host oracle, the main
MSM through pippenger() and pippenger_precomputed(), and K4 glv_digits (the
GLV split and signed digits) on edge scalars, also against the host oracle,
and on 3 x 2^16 scalars at c = 8, 10 and 13, the rounds-batched MSM of
the 2^20 prove (c = 13): K3b-wide over its rounds as bucket sets and K3b
over 1 and 3 vectors' rounds at 2^16 and 2^20 points (both timed there,
K3b-wide the faster, on the path), K3c over 1, 2 and 3 chains, also
against the host oracle, and over 1, 2, 3 and 33 chains of edge windows at
c = 8, 10 and 13 -
holds K2b fft_pass (every FFT's passes) against its plain version for all
seven public transforms at n = 2^4, 2^10 and each size the prove runs (2^16,
2^17, 2^18) with the default and a small tile, and the whole 2^18 transform
against the K2 stage-by-stage path, and at 2^19-2^22 (4-pass plans), K1
scan at 2^20,
reproduces the pinned n = 16 proof digest on the card (every commitment a
naive MSM), proves and verifies n = 2^11 gates, checks a Pippenger MSM
against the host oracle, and then drives the main path at n = 2^16 gates:
SRS generation, verifier-key preprocessing, `Prover.construct_proof`, host
`verify_proof`. From 2^10 gates every commitment goes through the SRS's
precomputed Pippenger table (built by one K3f launch at the first
commitment), one K4, one K3a and one K3b-wide launch per commitment call. Launches
are counted in four windows - the n = 16 golden proof, the n = 2^11 SRS
generation + proof ("small"), SRS generation at 2^16 (one K3e launch), and
the 2^16 preprocess + prove + verify - and the run fails if any kernel of
the path was never launched in them (the lane-wise point dbl and
mixed_add, which K3d and K3e replace, K2's stage kernel, which K2b
replaces, and K3b, whose function K3b-wide computes on the path, are
exempt; checked after the last window), if any window runs a lane-wise
dbl or mixed_add, a K3d launch other than one per naive MSM, a K3e launch
other than one per SRS generation, K4 / K3a / K3b-wide other than once per
commitment call through the table, any per-round K3b, Horner combine,
limb product of the eager GLV split on a CUDA tensor or (without naive
MSMs) lane-wise add, K1 scan launches other than one per scan of the
window, K1 dot launches other than one per batch of evaluations, K1
lincomb launches other than one per linear combination, K1 mul or add
launches above the window's ceilings, or if the 2^16 windows
run the
single-lane chains that K1 pow replaces or the K2 stage launches. Last, the
circuits phase (counted window "circuits") drives the circuit front end
the way a user does - a composer, stdlib gadgets, `composer.preprocess()`,
`plonk.preprocess`, `construct_proof`, `verify_proof` - for the reference's
bench circuits: SHA-256 of "abc" (65,167 gates, n = 2^16, on the prove
phase's SRS and table), Bool 1,100 pairs, MiMC 32 blocks and the Extended
chain of 5,000 (n = 2^12, their proof digests pinned to the JAX
prover's), each verified and a tampered proof rejected, then proves the
cross-implementation fixture bool_n256 to CROSSCHECK.json's SHA-256; it
fails if a circuit's launches are not one K4, K3a and K3b-wide per commit
call, one K1 scan per scan, pow per batch inversion, dot per batch of
evaluations, lincomb per linear combination, or exceed the mul / add
ceilings of its widgets' chains. Then phase "large" (counted window
"large") proves at the reference's own size: test_srs(2^20) generated on
the card, the crosscheck fixture at n = 2^20 gates and its verifier key;
the proof's SHA-256 must be CROSSCHECK.json's arithmetic_2e20 (the
reference C++ prover's bytes), it must verify and a tampered copy must
not, and each of the 6 commit calls must be one rounds-batched Pippenger
launch set (one K4, K3a, K3b-wide and K3c; no K3b, K3f, K3d) with the
pass plans' K2b launches; it prints the seconds of each step and the
peak device memory. Last, phase "g1" (counted window "g1", each call's
launches counted alone) drives the G1 library surface: msm at 2^12 points
and batched_msm of 3 vectors at 2^15 (the fused Pippenger schedule's two
ends: one K4, sort, K3a, K3b-wide over per-round segments and K3c a call),
the windowed and GLV scalar multiplications at c = 5 (one K3g each, GLV
with one K4) and scalar_mul (one K3d) on 2^12 lanes, hash_to_curve of 2^12
points (one K1 pow) and random_points_device (one K3d); it fails on any
other launch count, a lane-wise point op, a result off the host oracle or
off the curve. Its kernels are held in the kernels phase: K3g against its
plain walk (exact) on 2^12 lanes with edge lanes and on 16 against the
host, timed at 2^16; the fused MSM at 2^12 (c = 8) and 2^15 (c = 10)
exactly against its plain stages and, in affine form, against the
rounds-batched route and the host oracle, 3 vectors as one launch set
against single calls, K3a and K3b-wide timed at the fused shapes. Phase
"pairing" (counted window "pairing", after "large", on its test_srs(2^20))
drives the pairing's entry points: e(7G, 11G2) against the host tower,
the bilinearity groups, and the reference's SRS gate at its own size -
srs_on_curve_all over all 2^20 monomials, validate_srs_rlc (two MSMs at
2^20 and one two-pairing product) and validate_srs_device over bench.py's
2,048 sampled indices (4,096 pairings in groups of 2), all True - then the
device and RLC checks on a copy with one sampled monomial replaced by
[999]G and the on-curve sweep on one off the curve, all False; it fails
unless each pairing call is one K5a miller_loop and one K5b final_exp
launch with no chain of lane-wise K1 launches. The phase also runs the
lane-wise tower and G2 on the card (check_tower_g2: G2 add / dbl /
mixed_add / scalar_mul_bits, Fq12 mul / sqr / frobenius 1-3 /
cyclotomic_sqr / sparse_mul / invert on 256 lanes), each exactly equal to
the same call on the CPU and to the host oracle, with as many K1 launches
as the CPU call runs Fq ops. K5a and K5b are held in the
kernels phase exactly against their plain versions on 4,096 lanes (P and
-P against the G2 generator, [tau]G2, a random Q and an all-identity line
list; K5b over groups of 2 and of 1), their first lanes against the host
tower. Each phase prints one JSON line and any failing phase exits
non-zero. Without a
CUDA device the script exits non-zero and prints no result.

`--cpu-rehearsal` walks the same control flow at toy sizes on the CPU (plain
versions only) to find wrong paths and shapes without a card; it never
reports success.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from barretenberg_tpu_torch import convert
from barretenberg_tpu_torch.composer import StandardComposer
from barretenberg_tpu_torch.fixtures import (
    BENCH_DIGESTS,
    CROSSCHECK_2E20_SHA256,
    CROSSCHECK_SHA256,
    bench_circuit,
    crosscheck_prover,
)
from barretenberg_tpu_torch.fields import fq as get_fq, fr as get_fr
from barretenberg_tpu_torch.fields.glv import split_into_endomorphism_scalars
from barretenberg_tpu_torch.fields.limbs import ints_to_limbs
from barretenberg_tpu_torch.fields.params import FQ_PARAMS, FR_MODULUS, FR_PARAMS, R_INTERNAL
from barretenberg_tpu_torch.fields.quadratic import QuadraticField
from barretenberg_tpu_torch.fields.tower import SexticField, TwelfthField
from barretenberg_tpu_torch.groups import AffinePoints, JacobianPoints
from barretenberg_tpu_torch.groups.g2 import g2 as g2_curve, g2_host_to_affine, g2_jacobian_to_host
from barretenberg_tpu_torch.groups.g1 import (
    fixed_base_digits,
    fixed_base_mul,
    fixed_base_table,
    g1 as get_g1,
    hash_to_curve,
    host_to_affine_points,
    jacobian_to_host,
    points_to_host,
    random_points_device,
    scalar_mul,
    scalar_mul_glv,
)
from barretenberg_tpu_torch.kernels import build, butterfly, field_kernels, msm_kernels, pairing_kernels, point_kernels
from barretenberg_tpu_torch.msm import (
    batched_msm,
    generate_pippenger_point_table,
    msm,
    optimal_window,
    pippenger,
    pippenger_batch,
    pippenger_precomputed,
)
from barretenberg_tpu_torch.msm.naive import MSM_PIPPENGER_THRESHOLD, scalar_bits
from barretenberg_tpu_torch.msm import wnaf
from barretenberg_tpu_torch.msm.pippenger import endo_points, glv_entries, precomputed_digits
from barretenberg_tpu_torch.pairing import tower as host_tower
from barretenberg_tpu_torch.pairing.device import (
    _prepare_lines,
    fq12 as fq12_field,
    pairing_check_groups,
    reduced_ate_pairing,
    srs_on_curve_all,
    validate_srs_device,
    validate_srs_rlc,
)
from barretenberg_tpu_torch.plonk import preprocess
from barretenberg_tpu_torch.plonk.prover import Prover
from barretenberg_tpu_torch.polynomials import EvaluationDomain, fft, get_domain
from barretenberg_tpu_torch.srs import reference_string as srs_cache, test_srs
from barretenberg_tpu_torch.stdlib import Uint32, witness_t
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
ROW_WORDS = point_kernels.ROW_WORDS  # one point-table row (K3a, K3e)
MSM_BLOCK = 128  # pippenger's default block
# The reference's own size: its SRS holds 2^20 points and CROSSCHECK.json
# pins its prover's proof of the crosscheck fixture at 2^20 gates. There the
# prover commits through the rounds-batched Pippenger at c = 13 (11 rounds a
# vector), and the quotient runs transforms up to 4n = 2^22.
LARGE_LOG2N = 20
LARGE_C = 13
# K2b's 4-pass plans: the sizes held on the card, and the transform the
# 2^20 prove runs most at each (iFFTs at n, coset FFTs with the alpha
# constant at 2n, coset FFTs at 4n)
LARGE_FFT = {19: "ifft", 20: "ifft", 21: "coset_fft_with_constant", 22: "coset_fft"}

REPLACES = {
    "field": "barretenberg_tpu/kernels/field_kernels.py:64",
    "butterfly": "barretenberg_tpu/kernels/butterfly.py:79",
    "fft_pass": "barretenberg_tpu/kernels/butterfly.py:79 (log2(n) stages) and the bit-reverse gather (barretenberg_tpu/polynomials/fft.py:95) and scale multiplies (:130-151)",
    "point": "barretenberg_tpu/kernels/point_kernels.py:179",
    "bucket_accumulate": "barretenberg_tpu/kernels/point_kernels.py:179 (mixed_add) in the lax.scan of barretenberg_tpu/msm/pippenger.py:178",
    "bucket_reduce": "barretenberg_tpu/kernels/point_kernels.py:179 (add) in barretenberg_tpu/msm/pippenger.py:82 and :107",
    "field_pow": "barretenberg_tpu/kernels/field_kernels.py:64 (sqr, mont_mul) in the lax.scan of barretenberg_tpu/fields/montgomery.py:548",
    "window_combine": "barretenberg_tpu/kernels/point_kernels.py:179 (dbl, add) in the fori_loop of barretenberg_tpu/msm/pippenger.py:287-305",
    "scalar_mul_bits": "barretenberg_tpu/kernels/point_kernels.py:179 (dbl, mixed_add) in the lax.scan of barretenberg_tpu/groups/group.py:298-311",
    "fixed_base": "barretenberg_tpu/kernels/point_kernels.py:179 (mixed_add) and the jnp.take gathers in the fori_loop of barretenberg_tpu/groups/g1.py:198-210",
    "table_rows": "barretenberg_tpu/kernels/point_kernels.py:179 (dbl) in the fori_loop of barretenberg_tpu/msm/pippenger.py:457-458",
    "bucket_reduce_wide": "barretenberg_tpu/kernels/point_kernels.py:179 (add) in barretenberg_tpu/msm/pippenger.py:82-104 and :107, over the one bucket set of :517",
    "glv_digits": "barretenberg_tpu/kernels/field_kernels.py:64 (to_plain, sub, mont_mul, add) with the limb products and windows of barretenberg_tpu/msm/wnaf.py:73-97, :136",
    "field_scan": "barretenberg_tpu/kernels/field_kernels.py:64 (mont_mul, add) in the fori_loops of barretenberg_tpu/utils/scans.py:19-62 (hillis_scan, affine_scan)",
    "field_dot": "barretenberg_tpu/kernels/field_kernels.py:64 (mont_mul, add) in barretenberg_tpu/plonk/prover.py:259-271 (_multi_eval_jit) and barretenberg_tpu/polynomials/arithmetic.py:19-28, :55-58, :69-71 (_tree_sum, _evaluate_jit, evaluate_device)",
    "field_lincomb": "barretenberg_tpu/kernels/field_kernels.py:64 (mont_mul, add) in barretenberg_tpu/plonk/prover.py:274-282 (_linear_combo_jit)",
    "windowed_walk": "barretenberg_tpu/kernels/point_kernels.py:179 (mixed_add, dbl, add) in the lax.scans of barretenberg_tpu/groups/group.py:331 and :373 (_build_mul_table, _windowed_walk)",
    "bucket_accumulate_fused": "barretenberg_tpu/kernels/point_kernels.py:179 (mixed_add) in the lax.scan of barretenberg_tpu/msm/pippenger.py:191, over the fused schedule's one bucket set (:380)",
    "bucket_reduce_wide_fused": "barretenberg_tpu/kernels/point_kernels.py:179 (add) in barretenberg_tpu/msm/pippenger.py:82 and :124 (_suffix_scan_points_seg), over the fused schedule's one bucket set (:380-383)",
    "miller_loop": "barretenberg_tpu/kernels/field_kernels.py:64 (mont_mul, add, sub) in the lax.scan of fq12 sqr / sparse_mul of barretenberg_tpu/pairing/device.py:132-152 (_miller_jit)",
    "final_exp": "barretenberg_tpu/kernels/field_kernels.py:64 (mont_mul, add, sub) in the fori_loop + lax.switch of fq12 ops of barretenberg_tpu/pairing/device.py:193-243 (_final_exp_jit), with the group product of :259-261 (_group_product_jit, the tree of :107-129 _tree_mul_last_axis)",
}
# K4's 32-bit multiply-adds per scalar: its four limb products at the
# widths it is compiled with (9 x 3, 9 x 5, 3 x 5 and 5 x 3 wide multiplies
# of two multiply-adds each: k by g2 and g1, the quotients by -b1 and b2)
# and two Montgomery products
GLV_IMADS_PER_SCALAR = (9 * 3 + 9 * 5 + 3 * 5 + 5 * 3) * 2 + 2 * IMAD_PER_FIELD_MUL


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, why: str) -> None:
    emit({"phase": phase, "ok": False, "error": why})
    print(f"chip_smoke: phase {phase} failed: {why}", file=sys.stderr, flush=True)
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


def timed_once(fn, device):
    """One call's result and its milliseconds (device-synchronised)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def device_ms(fn, device, kernel: str, reps: int = 20, sessions: int = 3):
    """Mean device milliseconds per launch of the CUDA kernel whose profiler
    name contains `kernel`, over `reps` calls of fn after one warm-up
    (torch.profiler); None on the CPU rehearsal. A profiler session on the
    H100 now and then records no device activity at all, so up to
    `sessions` are tried; if none sees the kernel, the device operations the
    last one saw are printed and None is returned (the CUDA-event time `ms`
    and every exactness check stand regardless)."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        rows = [e for e in events if kernel in e.key]
        calls, total_us = sum(e.count for e in rows), sum(e.self_device_time_total for e in rows)
        if calls and total_us > 0:
            return total_us / calls / 1e3
    emit({"phase": "kernels", "note": f"the profiler saw no device time for {kernel} in {sessions} sessions",
          "seen": sorted({e.key[:80] for e in events})})
    return None


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


def check_field_kernels(device, lanes_check: int, lanes_time: int, dot_sizes: tuple, rng, records: list) -> None:
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
    # timing at the main path's widest shape, the 4n = 2^18 quotient domain,
    # and at one lane (batch_normalize, the Lagrange and grand-product
    # denominators)
    field = get_fr(device)
    a, b = field.random_elements(lanes_time, rng), field.random_elements(lanes_time, rng)
    a1, b1 = a[:, :1].contiguous(), b[:, :1].contiguous()
    for op in ("mul", "sqr", "add", "sub"):
        y = None if op == "sqr" else b
        y1 = None if op == "sqr" else b1
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
            "single_lane_ms": time_ms(lambda: field_op(FR_PARAMS, op, a1, y1), device, 50),
        })
    check_field_dot(device, dot_sizes, rng, records)
    check_field_lincomb(device, dot_sizes, rng, records)


def dot_bound(rows: int, n: int):
    """K1 dot's bound: each row and the table read once (72 bytes an
    element), the sums written once, and rows x n products."""
    return bound(ELEM_BYTES * ((rows + 1) * n + rows), rows * n * IMAD_PER_FIELD_MUL)


def lincomb_bound(terms: int, n: int):
    """K1 lincomb's bound: each term read once, the result written once,
    terms x n products (the scalars arrive by value)."""
    return bound(ELEM_BYTES * (terms + 1) * n, terms * n * IMAD_PER_FIELD_MUL)


def edge_rows(field, count: int, n: int, rng) -> list:
    """`count` (18, n) rows of seeded values; the first all zero and the
    second all p - 1 (once there are three), the last a lane-stride-2 view
    and, from four rows, the third a broadcast (18, 1) column."""
    rows = [rand_lanes((n,), device=field.device, rng=rng) for _ in range(count)]
    if count >= 3:
        rows[0] = torch.zeros_like(rows[0])
        rows[1] = field.encode([field.p - 1]).expand(18, n).contiguous()
    if count >= 4:
        rows[2] = field.encode(rand_values(1, field.p, rng)).expand(18, n)
    if count >= 2:
        rows[-1] = rand_lanes((2 * n,), device=field.device, rng=rng)[:, ::2]
    return rows


def check_field_dot(device, sizes: tuple, rng, records: list) -> None:
    """K1 dot against its plain version (a product and the halving tree of
    sums) over Fr at each of `sizes` lanes and over Fq at the smallest
    three, for 1 row, the prove's 5 and DOT_MAX_ROWS + 1 (two launches);
    the table the first n columns of a 3n table (the prove's strided view)
    and, at 1 row, also a lane-stride-2 view; rows with zeros, p - 1, a
    broadcast column and a strided view (edge_rows). Timed over Fr at the
    prove's shapes: 5 rows x n (the evaluations at z, the first record's
    shape), 1 row x 3n (t) and 1 row x n (r, the Kate values)."""
    counts = (1, 5, field_kernels.DOT_MAX_ROWS + 1)
    for params, get, ns in ((FR_PARAMS, get_fr, sizes), (FQ_PARAMS, get_fq, sizes[:3])):
        field = get(device)
        for n in ns:
            table3 = rand_lanes((3 * n,), device, rng)
            tables = [table3[:, :n]] + [rand_lanes((2 * n,), device, rng)[:, ::2]]
            for b in counts:
                rows = edge_rows(field, b, n, rng)
                for table in tables if b == 1 else tables[:1]:
                    got = field_kernels.dot(params, rows, table)
                    if not torch.equal(got, field_kernels.plain_dot(params, rows, table)):
                        fail("kernels", f"field dot over {params.name}, {b} rows x {n} lanes, disagrees with its plain version")
    fr, n = get_fr(device), sizes[-2]
    shapes = {"5 x n": (5, n, 3 * n), "1 x 3n": (1, 3 * n, 3 * n), "1 x n": (1, n, 3 * n)}
    by_shape = {}
    for label, (b, m, width) in shapes.items():
        rows = [rand_lanes((m,), device, rng) for _ in range(b)]
        table = rand_lanes((width,), device, rng)[:, :m]
        b_ms, b_by = dot_bound(b, m)
        by_shape[label] = {
            "rows": b, "lanes": m,
            "max_abs_err": max_abs_err([fr.dot(rows, table)], [field_kernels.plain_dot(FR_PARAMS, rows, table)]),
            "ms": time_ms(lambda: fr.dot(rows, table), device, 50),
            "device_ms": device_ms(lambda: fr.dot(rows, table), device, "field_dot_kernel"),
            "plain_ms": time_ms(lambda: field_kernels.plain_dot(FR_PARAMS, rows, table), device, 3),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    main = by_shape["5 x n"]
    records.append({
        "name": "field_dot", "module": "field", "op": "dot", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/field_kernels.cu", "replaces": REPLACES["field_dot"],
        "shape": [18, 5, n], "max_abs_err": max(v["max_abs_err"] for v in by_shape.values()),
        **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "by_shape": by_shape,
    })


def check_field_lincomb(device, sizes: tuple, rng, records: list) -> None:
    """K1 lincomb against its plain version (a product and a sum per term)
    over Fr at each of `sizes` lanes and over Fq at the smallest three, for
    1 term, the prove's 9 and LINCOMB_MAX_TERMS + 1 (two launches and one
    K1 add), scalars 0, 1 and p - 1 first; terms with zeros, p - 1, a
    broadcast column, a strided view (edge_rows) and a slice of a 3n array
    (the opening's quotient thirds). Timed over Fr at the prove's shapes:
    9 terms x n (the opening, the record's shape), 6 (r with the widget's
    terms) and 1 (the shifted opening)."""
    counts = (1, 9, field_kernels.LINCOMB_MAX_TERMS + 1)
    for params, get, ns in ((FR_PARAMS, get_fr, sizes), (FQ_PARAMS, get_fq, sizes[:3])):
        field = get(device)
        for n in ns:
            for j in counts:
                polys = edge_rows(field, j, n, rng)
                if j > 4:
                    polys[3] = rand_lanes((3 * n,), device, rng)[:, n : 2 * n]
                scalars = ([0, 1, field.p - 1] + rand_values(j, field.p, rng))[:j] if j > 1 else rand_values(1, field.p, rng)
                got = field_kernels.linear_combination(params, polys, scalars)
                if not torch.equal(got, field_kernels.plain_linear_combination(params, polys, scalars)):
                    fail("kernels", f"field lincomb over {params.name}, {j} terms x {n} lanes, disagrees with its plain version")
    fr, n = get_fr(device), sizes[-2]
    by_terms = {}
    for j in (9, 6, 1):
        polys = [rand_lanes((n,), device, rng) for _ in range(j)]
        scalars = rand_values(j, fr.p, rng)
        b_ms, b_by = lincomb_bound(j, n)
        by_terms[j] = {
            "max_abs_err": max_abs_err([fr.linear_combination(polys, scalars)],
                                       [field_kernels.plain_linear_combination(FR_PARAMS, polys, scalars)]),
            "ms": time_ms(lambda: fr.linear_combination(polys, scalars), device, 50),
            "device_ms": device_ms(lambda: fr.linear_combination(polys, scalars), device, "field_lincomb_kernel"),
            "plain_ms": time_ms(lambda: field_kernels.plain_linear_combination(FR_PARAMS, polys, scalars), device, 3),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    main = by_terms[9]
    records.append({
        "name": "field_lincomb", "module": "field", "op": "lincomb", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/field_kernels.cu", "replaces": REPLACES["field_lincomb"],
        "shape": [18, 9, n], "max_abs_err": max(v["max_abs_err"] for v in by_terms.values()),
        **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "by_terms": by_terms,
    })


def rand_lanes(shape: tuple, device, rng) -> torch.Tensor:
    """Seeded field elements below 2^253 (canonical in Fr and Fq) as (18,
    *shape) limbs, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 62)))
    t = torch.randint(0, 1 << 15, (18, *shape), generator=gen, device=device, dtype=torch.int32)
    t[16] &= (1 << 13) - 1
    t[17] = 0
    return t


def scan_bound(n: int, affine: bool):
    """K1 scan's bound over n lanes: each input and the output once (72
    bytes an element; the affine recurrence's m is one broadcast element),
    and the n - 1 products of 342 multiply-adds that the function needs in
    either mode (the affine recurrence's n - 1 additions count no
    multiply-adds, as K1 add's bound counts none)."""
    nbytes = ELEM_BYTES * (2 * n + affine)
    return bound(nbytes, max(n - 1, 0) * IMAD_PER_FIELD_MUL)


def check_field_scan(device, sizes: tuple, time_sizes: tuple, rng, records: list) -> None:
    """K1 scan against its plain version (the Hillis-Steele loops) over Fr
    and Fq at each of `sizes` lanes, each plan scan_plan picks (one warp,
    one CTA, chained tiles of 512 or 1,024): the prefix and suffix products
    of random lanes with a zero in the middle, the affine recurrence with a
    broadcast and with a full m, each run 3 times back to back on one stream
    (a look-back state the kernel failed to leave zero shows as a mismatch
    of the second or third), a 4-D batch scanned along a middle dim and
    strided views; Fr's batch inversion also against Python's pow. Timed
    over Fr at `time_sizes` (the first is the record's shape), with the
    profiler's device ms at the first."""

    def thrice(fn, want, what: str) -> None:
        outs = [fn() for _ in range(3)]
        for k, got in enumerate(outs):
            if not torch.equal(got, want):
                fail("kernels", f"field scan ({what}) disagrees with its plain version on launch {k + 1} of 3")

    for params, get in ((FR_PARAMS, get_fr), (FQ_PARAMS, get_fq)):
        field = get(device)
        for n in sizes:
            a = rand_lanes((n,), device, rng)
            if n > 2:
                a[:, n // 2] = 0
            for rev in (False, True):
                for x in (a, a[:, ::2]):
                    thrice(lambda: field.prefix_product(x, 1, rev),
                           field_kernels.plain_prefix_product(params, x, 1, rev),
                           f"product, reverse={rev}, over {params.name} at {x.shape[1]} lanes")
            b = rand_lanes((n,), device, rng)
            for m in (rand_lanes((1,), device, rng), rand_lanes((n,), device, rng)):
                thrice(lambda: field.affine_scan(m, b, 1),
                       field_kernels.plain_affine_scan(params, *torch.broadcast_tensors(m, b), 1),
                       f"affine, m of {m.shape[1]} lanes, over {params.name} at {n} lanes")
        rows = rand_lanes((5, 3, 7), device, rng)  # (18, 5, 3, 7) scanned along dim 2: 35 rows of 3
        for rev in (False, True):
            if not torch.equal(field.prefix_product(rows, 2, rev),
                               field_kernels.plain_prefix_product(params, rows, 2, rev)):
                fail("kernels", f"field scan over {params.name} along a middle dim disagrees with its plain version")
    fr = get_fr(device)
    vals = rand_values(256, fr.p, rng)
    if fr.decode(fr.batch_invert(fr.encode(vals))) != [pow(v, -1, fr.p) for v in vals]:
        fail("kernels", "batch_invert through the field scan disagrees with Python's pow")

    sms = torch.cuda.get_device_properties(device).multi_processor_count if device.type == "cuda" else 132
    for affine in (False, True):
        by_n = {}
        for n in time_sizes:
            b = rand_lanes((n,), device, rng)
            m = rand_lanes((1,), device, rng)
            if affine:
                run, plain = (lambda: fr.affine_scan(m, b, 1)), (
                    lambda: field_kernels.plain_affine_scan(FR_PARAMS, *torch.broadcast_tensors(m, b), 1))
            else:
                run, plain = (lambda: fr.prefix_product(b, 1)), (
                    lambda: field_kernels.plain_prefix_product(FR_PARAMS, b, 1))
            b_ms, b_by = scan_bound(n, affine)
            by_n[n] = {"max_abs_err": max_abs_err([run()], [plain()]), "ms": time_ms(run, device, 20),
                       "plain_ms": time_ms(plain, device, 2), "bound_ms": b_ms, "bound_by": b_by,
                       "plan": list(field_kernels.scan_plan(1, n, sms))}
            if n == time_sizes[0]:
                by_n[n]["device_ms"] = device_ms(run, device, "field_scan_kernel")
        main = by_n[time_sizes[0]]
        records.append({
            "name": "field_scan_affine" if affine else "field_scan", "module": "field", "op": "scan",
            "route": "cuda", "source": "barretenberg_tpu_torch/csrc/field_kernels.cu",
            "replaces": REPLACES["field_scan"], "shape": [18, time_sizes[0]],
            "mode": "affine recurrence, broadcast m" if affine else "prefix product",
            "max_abs_err": max(v["max_abs_err"] for v in by_n.values()),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "plan")},
            "library_ms": None, "by_lanes": by_n,
        })


def pow_steps(exponent: int) -> int:
    """Montgomery products in K1 pow's chain: one squaring per bit after the
    first, one multiplication per set bit after the first."""
    return max(0, exponent.bit_length() - 1) + max(0, bin(exponent).count("1") - 1)


def check_field_pow(device, lanes_wide: int, rng, records: list) -> None:
    """K1 pow against its plain version over Fr and Fq, at one lane (each of
    the lanes 0, 1, p-1 and a random one, as strided views) and at
    `lanes_wide` lanes, for the exponents p-2, r-2, 0, 1, 2 and a random
    254-bit one; the field's own inverse also against Python's pow."""
    exponents = [FQ_PARAMS.modulus - 2, FR_MODULUS - 2, 0, 1, 2,
                 int.from_bytes(rng.bytes(32), "little") >> 2 | 1 << 253]
    for params, get in ((FR_PARAMS, get_fr), (FQ_PARAMS, get_fq)):
        field = get(device)
        a = edge_elements(field, lanes_wide, rng)
        for e in exponents:
            want = field_kernels.plain_pow(params, a, e)  # lane-wise: lane i is lane i's own
            for lo, hi in [(0, lanes_wide)] + [(i, i + 1) for i in range(4)]:
                got = field_kernels.pow_static(params, a[:, lo:hi], e)
                if not torch.equal(got, want[:, lo:hi]):
                    fail("kernels", f"field pow over {params.name} at {hi - lo} lanes, e={e:#x}, disagrees with its plain version")
        m = 256
        inv = field.decode(field.invert(a[:, :m]))
        if inv != [pow(v, field.p - 2, field.p) for v in field.decode(a[:, :m])]:
            fail("kernels", f"field invert over {params.name} disagrees with Python's pow")
    # timing at the main path's shape: one Fermat inversion of one Fq lane
    # (batch_normalize), and beside it the same chain over lanes_wide lanes
    field, e = get_fq(device), FQ_PARAMS.modulus - 2
    steps = pow_steps(e)
    one, wide = field.random_elements(1, rng), field.random_elements(lanes_wide, rng)
    err = max_abs_err([field_kernels.pow_static(FQ_PARAMS, one, e)], [field_kernels.plain_pow(FQ_PARAMS, one, e)])
    b_ms, b_by = bound(2 * ELEM_BYTES, steps * IMAD_PER_FIELD_MUL)
    ms = time_ms(lambda: field_kernels.pow_static(FQ_PARAMS, one, e), device, 50)
    wide_bound, _ = bound(2 * ELEM_BYTES * lanes_wide, steps * IMAD_PER_FIELD_MUL * lanes_wide)
    records.append({
        "name": "field_pow", "module": "field", "op": "pow", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/field_kernels.cu",
        "replaces": REPLACES["field_pow"], "shape": [18, 1], "exponent": "p-2 (Fq)", "steps": steps,
        "max_abs_err": err, "ms": ms, "ms_per_step": ms / steps,
        "plain_ms": time_ms(lambda: field_kernels.plain_pow(FQ_PARAMS, one, e), device, 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "wide_shape": [18, lanes_wide],
        "wide_ms": time_ms(lambda: field_kernels.pow_static(FQ_PARAMS, wide, e), device, 10),
        "wide_bound_ms": wide_bound,
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
    # timing: the mean over all stages of one 4n = 2^18 transform, in a
    # fresh domain (so the prove still builds and counts its own tables)
    n = 1 << log2n_time
    domain = EvaluationDomain(n, device)
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


# (inverse, coset, constant) of the seven public transforms
FFT_VARIANTS = {
    "fft": (False, False, None), "ifft": (True, False, None),
    "coset_fft": (False, True, None), "coset_ifft": (True, True, None),
    "fft_with_constant": (False, False, 0xBEEF), "ifft_with_constant": (True, False, 0xBEEF),
    "coset_fft_with_constant": (False, True, 0xBEEF),
}
# the transform each domain size of the 2^16 prove runs most (log2 of n / 2^16
# -> variant): 12 wire / Z / sigma / selector iFFTs, 5 coset FFTs with the
# alpha constant, 7 quotient coset FFTs
TIMED_VARIANTS = {0: "ifft", 1: "coset_fft_with_constant", 2: "coset_fft"}


def stage_path(x, domain, inverse: bool, coset: bool, value):
    """A transform as the port ran it on the card before K2b: K1 scale
    multiplies, the bit-reverse gather and one K2 launch per stage."""
    fr, n = domain.fr, domain.size
    scale = (value if value is not None else 1) % fr.p
    if inverse:
        scale = domain.domain_inverse * scale % fr.p
    if not inverse:
        if coset:
            x = fr.mont_mul(x, domain.coset_scale)
        if scale != 1:
            x = fr.mul_by_constant(x, scale)
    x = x.index_select(1, domain.bit_reverse_indices)
    table = domain.inverse_twiddles if inverse else domain.twiddles
    for s in range(domain.log2_size):
        h = 1 << s
        x5 = x.reshape(18, n // (2 * h), 2, h, 1)
        x = butterfly.butterfly_stage(FR_PARAMS, x5, table[:, :: n // (2 * h)][:, :h]).reshape(18, n)
    if inverse:
        if scale != 1:
            x = fr.mul_by_constant(x, scale)
        if coset:
            x = fr.mont_mul(x, domain.coset_scale_inverse)
    return x


def fft_bound(log2n: int, inverse: bool, coset: bool, value):
    """The least time of one whole transform: the array in and out, the
    twiddles and the coset table read once; log2(n) * n / 2 butterfly
    products plus one product per element for each scale."""
    n = 1 << log2n
    scales = int(coset) + int(inverse or value is not None)
    nbytes = ELEM_BYTES * (2 * n + n // 2 + (n if coset else 0))
    return bound(nbytes, IMAD_PER_FIELD_MUL * (log2n * n // 2 + scales * n))


def check_fft_pass(device, log2n_check, log2n_time, small_tile, rng, records: list) -> None:
    """K2b against its plain version (exact) for every public transform,
    with the default pass plan and a small-tile one, on edge elements, at
    each size of `log2n_check` and of `log2n_time` (the sizes the main path
    runs); the whole transform at the largest timed size also against the K2
    stage-by-stage path; one timing record per timed size, held to
    max_abs_err 0 as well. The domains are built here and dropped, so the
    tables the main path's prove uses are built inside its counted window,
    as they were before K2b."""
    field = get_fr(device)
    domains = {k: EvaluationDomain(1 << k, device) for k in (*log2n_check, *log2n_time)}
    for k, d in domains.items():
        x = edge_elements(field, 1 << k, rng)
        for plan in (fft.fft_plan(k), fft.fft_plan(k, *small_tile)):
            for name, (inv, coset, val) in FFT_VARIANTS.items():
                got = fft.transform(x, d, inv, coset, val, plan)
                want = fft.transform(x, d, inv, coset, val, plan, butterfly.plain_fft_pass)
                if not torch.equal(got, want):
                    fail("kernels", f"fft_pass {name} at n=2^{k}, plan {plan}, disagrees with its plain version")
    k = log2n_time[-1]
    d = domains[k]
    x = edge_elements(field, 1 << k, rng)
    for name, (inv, coset, val) in FFT_VARIANTS.items():
        if not torch.equal(fft.transform(x, d, inv, coset, val), stage_path(x, d, inv, coset, val)):
            fail("kernels", f"fft_pass {name} at n=2^{k} disagrees with the K2 stage-by-stage path")
    for i, k in enumerate(log2n_time):
        name = TIMED_VARIANTS[i]
        inv, coset, val = FFT_VARIANTS[name]
        d = domains[k]
        x = field.random_elements(1 << k, rng)
        plan = fft.fft_plan(k)
        got = fft.transform(x, d, inv, coset, val)
        want = fft.transform(x, d, inv, coset, val, plan, butterfly.plain_fft_pass)
        err = max_abs_err([got], [want])
        if err:
            fail("kernels", f"fft_pass {name} at n=2^{k} disagrees with its plain version (max_abs_err {err})")
        b_ms, b_by = fft_bound(k, inv, coset, val)
        records.append({
            "name": "fft_pass", "module": "butterfly", "op": "pass", "route": "cuda",
            "source": "barretenberg_tpu_torch/csrc/butterfly.cu", "replaces": REPLACES["fft_pass"],
            "shape": [18, 1 << k], "transform": name, "passes": plan, "max_abs_err": err,
            "ms": time_ms(lambda: fft.transform(x, d, inv, coset, val), device, 20),
            "plain_ms": time_ms(lambda: fft.transform(x, d, inv, coset, val, plan, butterfly.plain_fft_pass), device, 1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "stage_path_ms": time_ms(lambda: stage_path(x, d, inv, coset, val), device, 20),
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


def chain_scalars(n: int, rng) -> list:
    """Seeded random Fr scalars with the edge values 0, 1, r-1 and 2^253 in
    front."""
    vals = rand_values(n, FR_MODULUS, rng)
    vals[:4] = [0, 1, FR_MODULUS - 1, 1 << 253]
    return vals


def chain_points(device, n: int, rng) -> AffinePoints:
    """n affine points with edge lanes: lane 1 repeats lane 0's point, lane
    2 is the point at infinity."""
    pts = get_g1(device).batch_normalize(fixed_base_mul(rand_values(n, FR_MODULUS, rng), device))
    x, y, inf = pts.x.clone(), pts.y.clone(), pts.inf.clone()
    x[:, 1], y[:, 1] = x[:, 0], y[:, 0]
    inf[2] = True
    return AffinePoints(x, y, inf)


def double_and_add_work(bits: torch.Tensor, pinf: torch.Tensor):
    """What K3d's input needs per lane: the doublings after the lane's top
    set bit and the mixed adds of its later set bits (the add at the top
    bit starts from infinity and needs no product); a lane whose point is at
    infinity needs none. Returns (products over all lanes, products of the
    longest lane)."""
    lanes = bits.shape[1]
    live = bits.ne(0) & ~pinf.repeat(lanes // pinf.shape[0]).unsqueeze(0)
    any_bit = live.any(0)
    top = live.to(torch.int32).argmax(0)
    dbls = torch.where(any_bit, bits.shape[0] - 1 - top, 0)
    adds = torch.where(any_bit, live.sum(0) - 1, 0)
    per_lane = POINT_MULS["dbl"] * dbls + POINT_MULS["mixed_add"] * adds
    return int(per_lane.sum()), int(per_lane.max())


def check_point_chains(device, smb_shapes, fb_lanes: tuple, rng, records: list) -> None:
    """K3d scalar_mul_bits and K3e fixed_base against their plain versions
    (exact) on edge lanes, at the main path's shapes: K3d at (points,
    batches) per shape (lane l reads point l % n, as batched_msm calls it),
    K3e at each lane count of `fb_lanes`; the first lanes of each also
    against the host oracle. Timed at the widest shape; K3d also at the
    narrowest, and with its chain: the products of the longest lane and the
    time per product of that chain."""
    fr = get_fr(device)
    smb = {}
    for n, b in smb_shapes:
        pts = chain_points(device, n, rng)
        ks = chain_scalars(n * b, rng)
        bits = scalar_bits(fr.encode(ks))
        got = point_kernels.scalar_mul_bits(pts, bits)
        want, plain_ms = timed_once(lambda: point_kernels.plain_scalar_mul_bits(pts, bits), device)
        err = max(max_abs_err(got[:3], want[:3]), int(got.inf.ne(want.inf).any()))
        if err:
            fail("kernels", f"scalar_mul_bits disagrees with its plain version at {n} points x {b}")
        m = 8
        host_pts = points_to_host(pts)
        head = JacobianPoints(*(t[..., :m] for t in got))
        if jacobian_to_host(head) != [host_curve.g1_mul(host_pts[i % n], ks[i]) for i in range(m)]:
            fail("kernels", f"scalar_mul_bits disagrees with the host oracle at {n} points x {b}")
        smb[n * b] = (pts, bits, err, plain_ms)
    lanes = max(smb)
    pts, bits, err, plain_ms = smb[lanes]
    n = pts.x.shape[1]
    products, chain = double_and_add_work(bits, pts.inf)
    b_ms, b_by = bound(n * (2 * ELEM_BYTES + 1) + bits.numel() + lanes * JAC_BYTES, products * IMAD_PER_FIELD_MUL)
    ms = time_ms(lambda: point_kernels.scalar_mul_bits(pts, bits), device, 5)
    small_pts, small_bits = smb[min(smb)][:2]
    records.append({
        "name": "scalar_mul_bits", "module": "point", "op": "scalar_mul_bits", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/point_chains.cu", "replaces": REPLACES["scalar_mul_bits"],
        "shape": [18, lanes], "points": n, "bits": bits.shape[0], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "chain_products": chain, "us_per_chain_product": ms * 1e3 / chain,
        "small_shape": [18, min(smb)],
        "small_ms": time_ms(lambda: point_kernels.scalar_mul_bits(small_pts, small_bits), device, 5),
    })

    table = fixed_base_table(device)
    fb = {}
    for n in fb_lanes:
        ks = chain_scalars(n, rng)
        ks[4:8] = [255, 256, 1 << 248, ks[8]]  # top digit of a window, next window, top window, repeat
        digits = fixed_base_digits(ks, device)
        got = point_kernels.fixed_base(digits, table)
        want, plain_ms = timed_once(lambda: point_kernels.plain_fixed_base(digits, table), device)
        err = max(max_abs_err(got[:3], want[:3]), int(got.inf.ne(want.inf).any()))
        if err:
            fail("kernels", f"fixed_base disagrees with its plain version at {n} lanes")
        m = 16
        head = JacobianPoints(*(t[..., :m] for t in got))
        if jacobian_to_host(head) != [host_curve.g1_mul(host_curve.G1_GENERATOR, k) for k in ks[:m]]:
            fail("kernels", f"fixed_base disagrees with the host oracle at {n} lanes")
        fb[n] = (digits, err, plain_ms)
    n = max(fb)
    digits, err, plain_ms = fb[n]
    live = digits.ne(0)  # table entry 0 of every window is the point at infinity
    adds = int((live.sum(0) - 1).clamp(min=0).sum())  # the first live window's add is free
    entries = table.shape[0]
    b_ms, b_by = bound(digits.numel() + entries * 4 * ROW_WORDS + n * JAC_BYTES,
                       adds * POINT_MULS["mixed_add"] * IMAD_PER_FIELD_MUL)
    records.append({
        "name": "fixed_base", "module": "point", "op": "fixed_base", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/point_chains.cu", "replaces": REPLACES["fixed_base"],
        "shape": [18, n], "windows": digits.shape[0], "table_entries": entries, "max_abs_err": err,
        "ms": time_ms(lambda: point_kernels.fixed_base(digits, table), device, 20),
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
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


def horner_oracle(host_windows: list, c: int):
    """sum_r 2^(c r) W_r on the host (None = infinity)."""
    acc = None
    for r, w in enumerate(host_windows):
        acc = host_curve.g1_add(acc, host_curve.g1_mul(w, 1 << (c * r)))
    return acc


def edge_windows(device, rounds: int, c: int, rng) -> dict:
    """Window batches (18, rounds) for K3c's edge cases, with the host
    windows they stand for (None = infinity): every window at infinity; only
    the lowest live; window 1 equal to 2^c times the running sum (the add
    takes its doubling branch); window 1 its negation (the sum cancels to
    infinity). Windows at infinity keep the coordinates of live points."""
    curve = get_g1(device)
    base = fixed_base_mul(rand_values(rounds, FR_MODULUS, rng), device)
    host = jacobian_to_host(base)
    above = horner_oracle(host[2:], c)  # running sum before window 1's doublings
    cases = {}
    for case in ("all_infinity", "lowest_only", "doubling", "cancel"):
        w = JacobianPoints(*(t.clone() for t in base))
        hw = list(host)
        if case == "all_infinity":
            w.inf[:] = True
            hw = [None] * rounds
        elif case == "lowest_only":
            w.inf[1:] = True
            hw[1:] = [None] * (rounds - 1)
        else:
            target = host_curve.g1_mul(above, 1 << c)
            hw[1] = target if case == "doubling" else host_curve.g1_neg(target)
            p = curve.to_jacobian(host_to_affine_points([hw[1]], device))
            w.x[:, 1], w.y[:, 1], w.z[:, 1] = p.x[:, 0], p.y[:, 0], p.z[:, 0]
        cases[case] = (w, hw)
    return cases


def combine_record(win: JacobianPoints, c: int, sets: int, device, err: int, **extra) -> dict:
    """K3c's timing record over `sets` chains of win's rounds: ms per call
    (CUDA events) and per point operation, the profiler's device ms, its
    plain version's ms and its bound (one chain's products)."""
    rounds = win.inf.shape[0] // sets
    steps = rounds * (c + 1)
    b_ms, b_by = bound((sets * rounds + sets) * JAC_BYTES,
                       sets * rounds * (c * POINT_MULS["dbl"] + POINT_MULS["add"]) * IMAD_PER_FIELD_MUL)
    run = lambda: msm_kernels.window_combine(win, c, sets)  # noqa: E731
    ms = time_ms(run, device, 20)
    return {
        "name": "window_combine", "module": "msm", "op": "window_combine", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/msm_kernels.cu", "replaces": REPLACES["window_combine"],
        "shape": [18, sets * rounds], "sets": sets, "c": c, "steps": steps, "max_abs_err": err,
        "ms": ms, "ms_per_point_op": ms / steps, "device_ms": device_ms(run, device, "window_combine_kernel"),
        "plain_ms": time_ms(lambda: msm_kernels.plain_window_combine(win, c, sets), device, 1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **extra,
    }


def check_window_combine(device, win: JacobianPoints, c: int, records: list) -> None:
    """K3c against its plain version (exact) and the host oracle sum_r 2^(c
    r) W_r on the main path's MSM windows, timed there (its edge cases:
    check_combine_chains)."""
    got, want = msm_kernels.window_combine(win, c), msm_kernels.plain_window_combine(win, c)
    err = max(max_abs_err(got[:3], want[:3]), int(got.inf.ne(want.inf).any()))
    if err:
        fail("kernels", "window_combine disagrees with its plain version on the MSM's windows")
    if jacobian_to_host(got) != [horner_oracle(jacobian_to_host(win), c)]:
        fail("kernels", "window_combine disagrees with the host oracle on the MSM's windows")
    records.append(combine_record(win, c, 1, device, err))


def check_combine_chains(device, windows: tuple, chains: tuple, rng) -> None:
    """K3c over B chains in one launch (B in `chains`; 33 is nine one-warp
    CTAs of four groups of 8 lanes) at each c of `windows`, chain s taking
    edge case s % 5 - edge_windows' four (every window at infinity, only the
    lowest live, a window equal to the running sum, its negation) and
    random windows - exactly against its plain version (one call over the
    widest B) and each chain against the host oracle."""
    for c in windows:
        rounds = msm_kernels.digit_rounds(c)
        cases = list(edge_windows(device, rounds, c, rng).values())
        base = fixed_base_mul(rand_values(rounds, FR_MODULUS, rng), device)
        cases.append((base, jacobian_to_host(base)))
        # chains are lanes of the plain version: the widest call's chains
        # hold every narrower call's, which are its first ones
        picks = [cases[s % len(cases)] for s in range(max(chains))]
        w_all = JacobianPoints(*(torch.cat([p[0][i] for p in picks], dim=-1).contiguous() for i in range(4)))
        want_all = msm_kernels.plain_window_combine(w_all, c, len(picks))
        host = [horner_oracle(p[1], c) for p in picks]
        for sets in chains:
            w = JacobianPoints(*(t[..., : sets * rounds].contiguous() for t in w_all))
            got, want = msm_kernels.window_combine(w, c, sets), JacobianPoints(*(t[..., :sets] for t in want_all))
            if max(max_abs_err(got[:3], want[:3]), int(got.inf.ne(want.inf).any())):
                fail("kernels", f"window_combine over {sets} chains at c = {c} disagrees with its plain version")
            if jacobian_to_host(got) != host[:sets]:
                fail("kernels", f"window_combine over {sets} chains at c = {c} disagrees with the host oracle")


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
    check_window_combine(device, win, c, records)


def table_rows_work(pinf: torch.Tensor, rows: int, c: int) -> int:
    """Field products K3f's input needs: (rows - 1) * c doublings of every
    point not at infinity."""
    return int((~pinf).sum()) * (rows - 1) * c * POINT_MULS["dbl"]


def wide_adds(cd: torch.Tensor, nbuckets: int, segment: int | None = None) -> int:
    """Adds K3b-wide needs for this input: s - 1 per bucket of s partials,
    then per set (per segment of ``segment`` buckets, the fused schedule's
    rounds) the first suffix scan and the lanes of the second that feed the
    window."""
    seg = segment or nbuckets
    scans = cd.shape[0] * (nbuckets // seg)
    live = cd < nbuckets
    starts = torch.ones_like(live)
    starts[:, 1:] = cd[:, 1:] != cd[:, :-1]
    adds = int(live.sum()) - int((live & starts).sum())
    for i in range(max(1, (seg - 1).bit_length())):
        d = 1 << i
        adds += scans * (max(0, seg - d) + -(-max(0, seg - d) // (2 * d)))
    return adds


def one_bucket_digits(m: int, live: int) -> torch.Tensor:
    """(1, m) digits whose first `live` entries are 3, -3, 3, ... (one
    bucket holds every partial), the rest 0."""
    d = torch.zeros((1, m), dtype=torch.int32)
    d[0, :live:2] = 3
    d[0, 1:live:2] = -3
    return d


def host_entry_sum(ent: list, digits: list):
    """sum_e d_e * entry_e on the host (None = infinity): the entries of
    each digit magnitude summed with their signs, then multiplied once."""
    sums: dict = {}
    for p, d in zip(ent, digits):
        if d and p is not None:
            sums[abs(d)] = host_curve.g1_add(sums.get(abs(d)), p if d > 0 else host_curve.g1_neg(p))
    acc = None
    for mag, q in sums.items():
        acc = host_curve.g1_add(acc, host_curve.g1_mul(q, mag))
    return acc


def check_precomputed(device, log2n_small: int, log2n: int, wide_c: tuple, rng, records: list) -> None:
    """The precomputed-table MSM's kernels at the table shapes of the small
    and the main prove (2^log2n_small and 2^log2n points), and at 2^log2n
    points with each window of ``wide_c``: K3f table_rows against its plain
    version; K3a (through the table's rows) and K3b-wide over the prove's
    widest batch, three bucket sets, against their plain versions, K3b-wide
    also with one and three buckets per cluster; K3a and K3b-wide also at
    the block of each commit call the prover makes (COMMIT_SETS sets, the
    block accumulate_block picks) at the two prove shapes; at the small shape
    one-bucket and sparse sets also against the host oracle, at the others
    a one-bucket set of every entry against the plain version; the main MSM
    through pippenger() and pippenger_precomputed() on the same scalars. All
    exact."""
    fr = get_fr(device)
    runs = {}
    capacity = msm_kernels.accumulate_capacity(device)
    for k, c in ((log2n_small, None), (log2n, None), *((log2n, w) for w in wide_c)):
        n = 1 << k
        prove_shape = c is None
        c = c or optimal_window(n)
        rounds, nb = msm_kernels.digit_rounds(c), 1 << (c - 1)
        pts = get_g1(device).batch_normalize(fixed_base_mul(rand_values(n, FR_MODULUS, rng), device))
        pts.inf[2] = True  # a point at infinity
        got = point_kernels.table_rows(pts, rounds, c)
        want, tr_plain_ms = timed_once(lambda: point_kernels.plain_table_rows(pts, rounds, c), device)
        tr_err = max(max_abs_err(got[:3], want[:3]), int(got.inf.ne(want.inf).any()))
        if tr_err:
            fail("kernels", f"table_rows disagrees with its plain version at {n} points")
        table = generate_pippenger_point_table(pts, c)
        rows = table.entries(MSM_BLOCK)
        m = rows.shape[0]
        scalars = [chain_scalars(n, rng) for _ in range(max(COMMIT_SETS) if prove_shape else 3)]
        enc = [fr.encode(v) for v in scalars]
        entries = msm_kernels.sort_rounds(precomputed_digits(enc[:3], c, m), nb)
        partials = msm_kernels.bucket_accumulate_rows(entries, rows, nb, MSM_BLOCK)
        want_p = msm_kernels.plain_bucket_accumulate(entries, *point_kernels.row_points(rows), nb, MSM_BLOCK)
        if not (torch.equal(partials.bucket, want_p.bucket) and same(partials.points, want_p.points)):
            fail("kernels", f"bucket_accumulate over the table's rows disagrees with its plain version at {n} points")
        want_w, rw_plain_ms = timed_once(lambda: msm_kernels.plain_bucket_reduce_wide(partials, nb), device)
        rw_err = 0
        for rb in (None, 1, 3):
            got_w = msm_kernels.bucket_reduce_wide(partials, nb, rb)
            rw_err = max(rw_err, max_abs_err(got_w[:3], want_w[:3]), int(got_w.inf.ne(want_w.inf).any()))
        # the block a commit call of s sets walks (K3a's default,
        # accumulate_block), K3a and K3b-wide at it, both exact: for each s
        # the prover uses at the prove shapes, for three sets at the others
        for s in COMMIT_SETS if prove_shape else (3,):
            ents = entries if s == 3 else msm_kernels.sort_rounds(precomputed_digits(enc[:s], c, m), nb)
            blk = msm_kernels.accumulate_block(ents.order.numel(), capacity)
            got_p = msm_kernels.bucket_accumulate_rows(ents, rows, nb, blk)
            want_c = msm_kernels.plain_bucket_accumulate(ents, *point_kernels.row_points(rows), nb, blk)
            if not (torch.equal(got_p.bucket, want_c.bucket) and same(got_p.points, want_c.points)):
                fail("kernels", f"bucket_accumulate at block {blk} ({s} sets) disagrees with its plain version at {n} points")
            got_w, want_w = msm_kernels.bucket_reduce_wide(got_p, nb), msm_kernels.plain_bucket_reduce_wide(got_p, nb)
            rw_err = max(rw_err, max_abs_err(got_w[:3], want_w[:3]), int(got_w.inf.ne(want_w.inf).any()))
            if s == 3:  # the three-set call's block, timed against 128 in block_turns
                chosen, partials_c = blk, got_p
        if rw_err:
            fail("kernels", f"bucket_reduce_wide disagrees with its plain version at {n} points")
        if k == log2n and c == optimal_window(n) and (
                jacobian_to_host(pippenger_precomputed(enc[0], table)) != jacobian_to_host(pippenger(enc[0], pts))):
            fail("kernels", f"pippenger_precomputed and pippenger disagree at {n} points")
        if k == log2n:  # one bucket holds every partial: one cluster merges them
            heavy = msm_kernels.bucket_accumulate_rows(
                msm_kernels.sort_rounds(one_bucket_digits(m, m).to(device), nb), rows, nb, MSM_BLOCK)
            want_h = msm_kernels.plain_bucket_reduce_wide(heavy, nb)
            for rb in (None, 1):
                got_h = msm_kernels.bucket_reduce_wide(heavy, nb, rb)
                rw_err = max(rw_err, max_abs_err(got_h[:3], want_h[:3]), int(got_h.inf.ne(want_h.inf).any()))
            if rw_err:
                fail("kernels", f"bucket_reduce_wide disagrees with its plain version on a one-bucket set (c = {c})")
        runs[(k, c)] = dict(
            pts=pts, rounds=rounds, c=c, nb=nb, rows=rows, entries=entries, partials=partials,
            chosen=chosen, partials_chosen=partials_c,
            heavy=heavy if k == log2n else None, tr_err=tr_err, tr_plain_ms=tr_plain_ms,
            rw_err=rw_err, rw_plain_ms=rw_plain_ms)

    # edge sets at the small shape, against the host oracle: one bucket holds
    # every partial (a single CTA merges them); a sparse set of random digits
    small_key, main_key = (log2n_small, optimal_window(1 << log2n_small)), (log2n, optimal_window(1 << log2n))
    r = runs[small_key]
    rows, nb = r["rows"], r["nb"]
    m = rows.shape[0]
    sparse = torch.zeros((1, m), dtype=torch.int32)
    idx = torch.from_numpy(rng.choice(m, size=256, replace=False))
    sparse[0, idx] = torch.from_numpy(rng.integers(-nb, nb + 1, size=256)).to(torch.int32)
    ent = points_to_host(point_kernels.row_points(rows))
    for case, digits in (("one_bucket", one_bucket_digits(m, m)), ("sparse", sparse)):
        entries = msm_kernels.sort_rounds(digits.to(device), nb)
        partials = msm_kernels.bucket_accumulate_rows(entries, rows, nb, MSM_BLOCK)
        want = msm_kernels.plain_bucket_reduce_wide(partials, nb)
        for rb in (None, 1):
            if not same(msm_kernels.bucket_reduce_wide(partials, nb, rb), want):
                fail("kernels", f"bucket_reduce_wide disagrees with its plain version ({case}, {rb} buckets per cluster)")
        if jacobian_to_host(want) != [host_entry_sum(ent, digits[0].tolist())]:
            fail("kernels", f"bucket_reduce_wide disagrees with the host oracle ({case})")

    # timing at the main shape: K3f (also at the small one), K3a over the
    # table's rows, K3b-wide (also on one set and on a one-bucket set of
    # every entry)
    r, rs = runs[main_key], runs[small_key]
    pts, rounds, c, nb, partials = r["pts"], r["rounds"], r["c"], r["nb"], r["partials"]
    n = pts.x.shape[1]
    b_ms, b_by = bound(n * (2 * ELEM_BYTES + 1) + (rounds - 1) * n * JAC_BYTES,
                       table_rows_work(pts.inf, rounds, c) * IMAD_PER_FIELD_MUL)
    records.append({
        "name": "table_rows", "module": "point", "op": "table_rows", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/point_chains.cu", "replaces": REPLACES["table_rows"],
        "shape": [18, n], "rows": rounds, "c": c, "max_abs_err": max(r["tr_err"], rs["tr_err"]),
        "ms": time_ms(lambda: point_kernels.table_rows(pts, rounds, c), device, 5),
        "plain_ms": r["tr_plain_ms"], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "small_shape": [18, rs["pts"].x.shape[1]],
        "small_ms": time_ms(lambda: point_kernels.table_rows(rs["pts"], rs["rounds"], rs["c"]), device, 5),
    })
    # K3a at the table's shape beside its rounds-batched record
    entries, rows = r["entries"], r["rows"]
    sets, m = entries.order.shape
    acc = next(rec for rec in records if rec["name"] == "bucket_accumulate")
    acc["table_shape"] = [sets, m, MSM_BLOCK]
    acc["table_ms"] = time_ms(lambda: msm_kernels.bucket_accumulate_rows(entries, rows, nb, MSM_BLOCK), device, 10)
    acc["table_bound_ms"], _ = bound(
        sets * m * 4 + m * 4 * ROW_WORDS + sets * partials.bucket.shape[1] * (JAC_BYTES + 4),
        accumulate_madds(entries, point_kernels.row_points(rows).inf, nb, MSM_BLOCK)
        * POINT_MULS["mixed_add"] * IMAD_PER_FIELD_MUL)
    # K3a + K3b-wide per commit call of three sets at block 128 and at the
    # chosen block, in turns (128, chosen, chosen, 128), at both table shapes
    for prefix, run in (("table", r), ("small_table", rs)):
        acc[f"{prefix}_turns"] = block_turns(run, device)
    sets, k = partials.bucket.shape
    one = msm_kernels.Partials(partials.bucket[:1].contiguous(),
                               JacobianPoints(*(t[..., :k].contiguous() for t in partials.points)))
    heavy = r["heavy"]
    b_ms, b_by = bound(sets * k * (JAC_BYTES + 4) + sets * JAC_BYTES,
                       wide_adds(partials.bucket, nb) * POINT_MULS["add"] * IMAD_PER_FIELD_MUL)
    other = {f"c{run['c']}": run for key, run in runs.items() if key != main_key}
    records.append({
        "name": "bucket_reduce_wide", "module": "msm", "op": "bucket_reduce_wide", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/msm_kernels.cu", "replaces": REPLACES["bucket_reduce_wide"],
        "shape": [sets, k, nb], "c": c,
        "range_buckets": msm_kernels.wide_range_buckets(nb, sets, device) if device.type == "cuda" else None,
        "max_active_clusters": msm_kernels.wide_max_clusters(nb, device) if device.type == "cuda" else None,
        "max_abs_err": max(run["rw_err"] for run in runs.values()),
        "ms": time_ms(lambda: msm_kernels.bucket_reduce_wide(partials, nb), device, 10),
        "plain_ms": r["rw_plain_ms"], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "one_set_ms": time_ms(lambda: msm_kernels.bucket_reduce_wide(one, nb), device, 10),
        "one_bucket_set_ms": time_ms(lambda: msm_kernels.bucket_reduce_wide(heavy, nb), device, 3),
        "one_bucket_set_partials": int((heavy.bucket < nb).sum()),
        **{f"{name}_shape": list(run["partials"].bucket.shape) + [run["nb"]] for name, run in other.items()},
        **{f"{name}_ms": time_ms(lambda run=run: msm_kernels.bucket_reduce_wide(run["partials"], run["nb"]), device, 10)
           for name, run in other.items()},
        **{f"{name}_bound_ms": bound(
            run["partials"].bucket.numel() * (JAC_BYTES + 4) + run["partials"].bucket.shape[0] * JAC_BYTES,
            wide_adds(run["partials"].bucket, run["nb"]) * POINT_MULS["add"] * IMAD_PER_FIELD_MUL)[0]
           for name, run in other.items()},
    })


def block_turns(run: dict, device) -> dict:
    """K3a's and K3b-wide's ms per call over one run's three sets at block
    128 and at the chosen block, timed in turns (the faster of each block's
    two readings), and K3a's bound at each."""
    entries, rows, nb = run["entries"], run["rows"], run["nb"]
    parts = {MSM_BLOCK: run["partials"], run["chosen"]: run["partials_chosen"]}
    reads: dict = {}
    for blk in (MSM_BLOCK, run["chosen"], run["chosen"], MSM_BLOCK):
        a = time_ms(lambda: msm_kernels.bucket_accumulate_rows(entries, rows, nb, blk), device, 10)
        w = time_ms(lambda: msm_kernels.bucket_reduce_wide(parts[blk], nb), device, 10)
        reads.setdefault(blk, []).append((a, w))
    sets, m = entries.order.shape
    pinf = point_kernels.row_points(rows).inf
    out = {}
    for blk, pairs in reads.items():
        k = parts[blk].bucket.shape[1]
        out[str(blk)] = {
            "k3a_ms": min(a for a, _ in pairs), "wide_ms": min(w for _, w in pairs),
            "k3a_bound_ms": bound(sets * m * 4 + m * 4 * ROW_WORDS + sets * k * (JAC_BYTES + 4),
                                  accumulate_madds(entries, pinf, nb, blk) * POINT_MULS["mixed_add"]
                                  * IMAD_PER_FIELD_MUL)[0],
            "partial_slots": k,
        }
        out[str(blk)]["sum_ms"] = out[str(blk)]["k3a_ms"] + out[str(blk)]["wide_ms"]
    out["chosen_block"] = run["chosen"]
    return out


def glv_edge_scalars(n: int, rng) -> list:
    """n seeded Fr scalars with edge values in front: 0, 1, r-1, lambda and
    its neighbours, 2^126 - 1 (k1 all ones, so every window but the top one
    carries), 2^126, and 2^126 - (2^126 - 1) lambda (k2 all ones)."""
    lam, ones = FR_PARAMS.cube_root, (1 << 126) - 1
    edge = [0, 1, FR_MODULUS - 1, lam, lam - 1, lam + 1, ones, 1 << 126, ((1 << 126) - ones * lam) % FR_MODULUS]
    return edge + rand_values(n - len(edge), FR_MODULUS, rng)


def host_signed_digits(half: int, c: int) -> list:
    """Signed c-bit digits of a 128-bit half with the borrow recoding, LSB
    window first, and the final carry, in Python integers."""
    out, carry = [], 0
    for r in range(-(-wnaf.HALF_BITS // c)):
        v = ((half >> (r * c)) & ((1 << c) - 1)) + carry
        carry = int(v >= 1 << (c - 1))
        out.append(v - (carry << c))
    return out + [carry]


def host_glv_digits(scalars: list, c: int) -> list:
    """One set's digits in K4's layout - per round, the digits of every k1,
    then of every k2 - from the host split (fields/glv.py)."""
    halves = [split_into_endomorphism_scalars(k) for k in scalars]
    rows = [host_signed_digits(a, c) for a, _ in halves] + [host_signed_digits(b, c) for _, b in halves]
    return [row[r] for r in range(len(rows[0])) for row in rows]


def check_glv_digits(device, log2n: int, rng, records: list) -> None:
    """K4 against its plain version (the eager split and signed digits, run on
    the card), exactly, for c = 8, 10 and 13: on 64 edge and random scalars
    in one set (also against the host oracle) and on 3 x 2^log2n scalars in
    three sets with the table's padding. Timed at c = 10 (the 2^16 prove's
    window) with its bound; c = 8 and 13 beside it."""
    fr = get_fr(device)
    edge = glv_edge_scalars(64, rng)
    n = 1 << log2n
    wide = torch.cat([fr.encode(rand_values(n, FR_MODULUS, rng)) for _ in range(3)], dim=1)
    err, ms_by_c = 0, {}
    for c in (8, 10, 13):
        rounds = msm_kernels.digit_rounds(c)
        got = msm_kernels.glv_digits(fr.encode(edge), 1, c, rounds * 2 * len(edge))
        if got[0].tolist() != host_glv_digits(edge, c):
            fail("kernels", f"glv_digits disagrees with the host oracle on the edge scalars (c = {c})")
        m = -(-rounds * 2 * n // MSM_BLOCK) * MSM_BLOCK
        for scalars, sets, width in ((fr.encode(edge), 1, rounds * 2 * len(edge)), (wide, 3, m)):
            got = msm_kernels.glv_digits(scalars, sets, c, width)
            want = msm_kernels.plain_glv_digits(scalars, sets, c, width)
            err = max(err, int((got - want).abs().max()))
        if err:
            fail("kernels", f"glv_digits disagrees with its plain version (c = {c})")
        ms_by_c[c] = time_ms(lambda: msm_kernels.glv_digits(wide, 3, c, m), device, 20)
    c = 10
    m = -(-msm_kernels.digit_rounds(c) * 2 * n // MSM_BLOCK) * MSM_BLOCK
    b_ms, b_by = bound(3 * n * ELEM_BYTES + 3 * m * 4, 3 * n * GLV_IMADS_PER_SCALAR)
    records.append({
        "name": "glv_digits", "module": "msm", "op": "glv_digits", "route": "cuda",
        "source": "barretenberg_tpu_torch/csrc/msm_kernels.cu", "replaces": REPLACES["glv_digits"],
        "shape": [18, 3 * n], "sets": 3, "c": c, "m": m, "max_abs_err": err, "ms": ms_by_c[c],
        "ms_by_c": ms_by_c,
        "plain_ms": time_ms(lambda: msm_kernels.plain_glv_digits(wide, 3, c, m), device, 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })


def random_points(device, n: int, rng) -> AffinePoints:
    """n random affine points [k]G, k below 2^248, drawn on the device: one
    K3e launch on random window digits and one batched normalisation."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 62)))
    digits = torch.randint(0, 256, (32, n), generator=gen, device=device, dtype=torch.uint8)
    digits[31] = 0
    return get_g1(device).batch_normalize(point_kernels.fixed_base(digits, fixed_base_table(device)))


def check_rounds_msm(device, log2n_check: int, log2n_path: int, c: int, rng, records: list) -> None:
    """The rounds-batched MSM at the 2^20 prove's shapes (c = 13, 11 rounds
    a vector; commit calls of 1 and 3 vectors), on random points drawn on
    the card: K3a over the 3-vector call's rounds against its plain version
    over 2^log2n_check points, timed there and over the path's
    2^log2n_path points; K3b-wide over the rounds as bucket sets, and K3b,
    against their plain version (exact) over both, both kernels timed over
    the path's points; then K3c over B = 1, 2, 3 chains of the 3-vector
    call's windows against its plain version (exact) and the host oracle."""
    nb = 1 << (c - 1)
    windows = acc = None
    for log2n in (log2n_check, log2n_path):
        pts = random_points(device, 1 << log2n, rng)
        for sets in (1, 3):
            digits, px, py, pinf = glv_entries(rand_lanes((sets << log2n,), device, rng), pts, c, MSM_BLOCK, sets)
            entries = msm_kernels.sort_rounds(digits, nb)
            partials = msm_kernels.bucket_accumulate(entries, px, py, pinf, nb, MSM_BLOCK)
            cd = partials.bucket
            nsets, k = cd.shape
            m = entries.order.shape[1]
            partial_bytes = nsets * k * (JAC_BYTES + 4)
            if sets == 3:
                run = lambda: msm_kernels.bucket_accumulate(entries, px, py, pinf, nb, MSM_BLOCK)
                b_ms, b_by = bound(nsets * m * 4 + m * (2 * ELEM_BYTES + 1) + partial_bytes,
                                   accumulate_madds(entries, pinf, nb, MSM_BLOCK) * POINT_MULS["mixed_add"]
                                   * IMAD_PER_FIELD_MUL)
                if log2n == log2n_check:
                    want, plain_ms = timed_once(
                        lambda: msm_kernels.plain_bucket_accumulate(entries, px, py, pinf, nb, MSM_BLOCK), device)
                    err = max(int((cd - want.bucket).abs().max()), max_abs_err(partials.points, want.points))
                    if err:
                        fail("kernels", f"bucket_accumulate disagrees with its plain version at {nsets} x {m} entries")
                    acc = {"name": "bucket_accumulate", "module": "msm", "op": "bucket_accumulate", "route": "cuda",
                           "source": "barretenberg_tpu_torch/csrc/msm_kernels.cu",
                           "replaces": REPLACES["bucket_accumulate"], "shape": [nsets, m, MSM_BLOCK],
                           "path": f"rounds-batched MSM, 3 x 2^{log2n} points, c = {c}", "max_abs_err": err,
                           "ms": time_ms(run, device, 5), "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": None}
                else:
                    acc.update(path_shape=[nsets, m, MSM_BLOCK], path_ms=time_ms(run, device, 3), path_bound_ms=b_ms)
                    records.append(acc)
            wide = msm_kernels.bucket_reduce_wide(partials, nb)
            k3b = msm_kernels.bucket_reduce(partials, nb)
            want, plain_ms = timed_once(lambda: msm_kernels.plain_bucket_reduce(partials, nb), device)
            errs = {}
            for name, got in (("bucket_reduce_wide", wide), ("bucket_reduce", k3b)):
                errs[name] = max(max_abs_err(got[:3], want[:3]), int(got.inf.ne(want.inf).any()))
                if errs[name]:
                    fail("kernels", f"{name} disagrees with its plain version at {sets} x "
                                    f"{msm_kernels.digit_rounds(c)} rounds over 2^{log2n} points")
            if log2n != log2n_path:
                continue
            nbytes = partial_bytes + nsets * JAC_BYTES
            adds = {"bucket_reduce_wide": wide_adds(cd, nb), "bucket_reduce": reduce_adds(cd, nb)}
            for name, fn in (("bucket_reduce_wide", msm_kernels.bucket_reduce_wide),
                             ("bucket_reduce", msm_kernels.bucket_reduce)):
                b_ms, b_by = bound(nbytes, adds[name] * POINT_MULS["add"] * IMAD_PER_FIELD_MUL)
                records.append({
                    "name": name, "module": "msm", "op": name, "route": "cuda",
                    "source": "barretenberg_tpu_torch/csrc/msm_kernels.cu", "replaces": REPLACES[name],
                    "shape": [nsets, k, nb], "path": f"rounds-batched MSM, {sets} x 2^{log2n} points, c = {c}",
                    "max_abs_err": errs[name], "ms": time_ms(lambda: fn(partials, nb), device, 5),
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                })
            if sets == 3:
                windows = wide
    check_combine_sets(device, windows, c, records)


def check_combine_sets(device, win: JacobianPoints, c: int, records: list) -> None:
    """K3c over B = 1, 2, 3 chains (a group of 8 lanes each, one launch) of a
    commit call's windows (18, B x R) against its plain version (exact),
    and each chain against the host oracle sum_r 2^(c r) W_r."""
    rounds = msm_kernels.digit_rounds(c)
    host = jacobian_to_host(win)
    for sets in (1, 2, 3):
        w = JacobianPoints(*(t[..., : sets * rounds].contiguous() for t in win))
        got, want = msm_kernels.window_combine(w, c, sets), msm_kernels.plain_window_combine(w, c, sets)
        err = max(max_abs_err(got[:3], want[:3]), int(got.inf.ne(want.inf).any()))
        if err:
            fail("kernels", f"window_combine over {sets} chains disagrees with its plain version")
        if jacobian_to_host(got) != [horner_oracle(host[s * rounds : (s + 1) * rounds], c) for s in range(sets)]:
            fail("kernels", f"window_combine over {sets} chains disagrees with the host oracle")
        records.append(combine_record(w, c, sets, device, err))


def check_fft_pass_large(device, sizes: tuple, rng, records: list) -> None:
    """K2b's 4-pass plans (2^19 to 2^22 with the default tile) against its
    plain version (exact), all seven public transforms once each on random
    elements with 0, 1 and p - 1 in front, in fresh domains; one timing
    record per size, of the transform the 2^20 prove runs most there."""
    field = get_fr(device)
    edge = field.encode([0, 1, field.p - 1])
    for k in sizes:
        d = EvaluationDomain(1 << k, device)
        x = rand_lanes((1 << k,), device, rng)
        x[:, :3] = edge
        plan = fft.fft_plan(k)
        timed = LARGE_FFT.get(k, "ifft")
        for name, (inv, coset, val) in FFT_VARIANTS.items():
            got = fft.transform(x, d, inv, coset, val, plan)
            want, plain_ms = timed_once(lambda: fft.transform(x, d, inv, coset, val, plan, butterfly.plain_fft_pass),
                                        device)
            err = max_abs_err([got], [want])
            if err:
                fail("kernels", f"fft_pass {name} at n=2^{k}, plan {plan}, disagrees with its plain version")
            if name != timed:
                continue
            b_ms, b_by = fft_bound(k, inv, coset, val)
            records.append({
                "name": "fft_pass", "module": "butterfly", "op": "pass", "route": "cuda",
                "source": "barretenberg_tpu_torch/csrc/butterfly.cu", "replaces": REPLACES["fft_pass"],
                "shape": [18, 1 << k], "transform": name, "passes": plan, "max_abs_err": err,
                "ms": time_ms(lambda: fft.transform(x, d, inv, coset, val), device, 10),
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            })


def check_scans_large(device, n: int, rng) -> None:
    """K1 scan at the 2^20 prove's width against its plain version (exact):
    the prefix product with a zero in the middle over Fr (the grand
    product) and Fq (the SRS's batch normalisation), and the affine
    recurrence with a broadcast m over Fr (the Kate division)."""
    for params, get in ((FR_PARAMS, get_fr), (FQ_PARAMS, get_fq)):
        field = get(device)
        a = rand_lanes((n,), device, rng)
        a[:, n // 2] = 0
        if not torch.equal(field.prefix_product(a, 1), field_kernels.plain_prefix_product(params, a, 1)):
            fail("kernels", f"field scan (product) over {params.name} at {n} lanes disagrees with its plain version")
    fr = get_fr(device)
    b, m = rand_lanes((n,), device, rng), rand_lanes((1,), device, rng)
    if not torch.equal(fr.affine_scan(m, b, 1),
                       field_kernels.plain_affine_scan(FR_PARAMS, *torch.broadcast_tensors(m, b), 1)):
        fail("kernels", f"field scan (affine) over Fr at {n} lanes disagrees with its plain version")


# ---------------------------------------------------------------------------
# the G1 library surface (kernels phase: K3g, the fused schedule's kernels)
# ---------------------------------------------------------------------------
WALK_C = 5  # the windowed and GLV walks' window (the JAX package's default)
G1_BATCH = 3  # batched_msm's vectors at the fused schedule's top size


def known_points(device, n: int, rng):
    """n affine points [k_i]G and their host scalars k_i (one K3e launch, one
    batched normalisation): lane 1 repeats lane 0's point, lane 2 is at
    infinity (k = 0)."""
    ks = rand_values(n, FR_MODULUS, rng)
    ks[1], ks[2] = ks[0], 0
    return get_g1(device).batch_normalize(fixed_base_mul(ks, device)), ks


def known_msm(ks: list, scalars: list):
    """sum_i s_i [k_i]G = [sum_i s_i k_i]G on the host (None = infinity)."""
    return host_curve.g1_mul(host_curve.G1_GENERATOR, sum(s * k for s, k in zip(scalars, ks)) % FR_MODULUS)


def walk_scalars(n: int, rng) -> list:
    """Random Fr scalars with edges in front: 0, 1, 2, r - 1, 16 and 16 * 33
    (digits of -2^(c-1) at c = 5 in one and in two windows), 2^253."""
    vals = rand_values(n, FR_MODULUS, rng)
    vals[:7] = [0, 1, 2, FR_MODULUS - 1, 16, 16 * 33, 1 << 253]
    return vals


def walk_work(digit_sets: list, pinf: torch.Tensor, c: int, glv: bool):
    """Field products K3g's input needs per lane: the table's 2^(c-1) - 1
    mixed adds (T[1] from infinity is free); from the first round with a
    nonzero digit on, c doublings per later round and one add per later
    nonzero digit (the first add starts from infinity), and in GLV one
    product for psi's beta x per nonzero k2 digit; a lane at infinity needs
    none. Returns (products over all lanes, products of the longest lane)."""
    rounds = digit_sets[0].shape[0]
    nz = [d.ne(0) for d in digit_sets]
    any_add = torch.stack(nz).any(0)
    has = any_add.any(0)
    top = any_add.flip(0).to(torch.int32).argmax(0)  # the first round with an add, MSB first
    dbls = torch.where(has, (rounds - 1 - top) * c, 0)
    adds = torch.where(has, sum(x.sum(0) for x in nz) - 1, 0)
    beta = nz[1].sum(0) if glv else 0
    table = ((1 << (c - 1)) - 1) * POINT_MULS["mixed_add"]
    per_lane = torch.where(pinf, 0, table + POINT_MULS["dbl"] * dbls + POINT_MULS["add"] * adds + beta)
    return int(per_lane.sum()), int(per_lane.max())


def check_windowed_walk(device, lanes_check: int, lanes_time: int, rng, records: list) -> None:
    """K3g windowed_walk, windowed and GLV at c = 5, exactly against its plain
    walk on lanes_check lanes with edge lanes (a point at infinity, a
    repeated point, walk_scalars' edges), the first 16 also against the host
    oracle, then at lanes_time lanes, timed there (the GLV digits from K4)."""
    fr = get_fr(device)
    c = WALK_C
    rounds = msm_kernels.digit_rounds(c)
    for n in (lanes_check, lanes_time):
        pts, ks = known_points(device, n, rng)
        svals = walk_scalars(n, rng)
        s = fr.encode(svals)
        digits = msm_kernels.glv_digits(s, 1, c, rounds * 2 * n).reshape(rounds, 2, n)
        for glv in (False, True):
            if glv:
                run = lambda: point_kernels.glv_walk(pts, digits, c)
                plain = lambda: point_kernels.plain_glv_walk(pts, digits, c)
            else:
                run = lambda: point_kernels.windowed_walk(pts, s, c)
                plain = lambda: point_kernels.plain_windowed_walk(pts, s, c)
            mode = "glv" if glv else "windowed"
            got = run()
            want, plain_ms = timed_once(plain, device)
            err = max(max_abs_err(got[:3], want[:3]), int(got.inf.ne(want.inf).any()))
            if err:
                fail("kernels", f"windowed_walk ({mode}) disagrees with its plain version at {n} lanes")
            if n == lanes_check:
                head = JacobianPoints(*(t[..., :16] for t in got))
                host = [host_curve.g1_mul(host_curve.G1_GENERATOR, k * v) for k, v in zip(ks[:16], svals[:16])]
                if jacobian_to_host(head) != host:
                    fail("kernels", f"windowed_walk ({mode}) disagrees with the host oracle")
                continue
            dsets = [digits[:, 0], digits[:, 1]] if glv else [wnaf.signed_digits_full(fr.to_plain(s), c)]
            products, chain = walk_work(dsets, pts.inf, c, glv)
            nbytes = n * (2 * ELEM_BYTES + 1) + (digits.numel() * 4 if glv else n * ELEM_BYTES) + n * JAC_BYTES
            b_ms, b_by = bound(nbytes, products * IMAD_PER_FIELD_MUL)
            ms = time_ms(run, device, 5)
            records.append({
                "name": f"windowed_walk_{mode}", "module": "point", "op": "windowed_walk", "route": "cuda",
                "source": "barretenberg_tpu_torch/csrc/point_chains.cu", "replaces": REPLACES["windowed_walk"],
                "shape": [18, n], "c": c, "rounds": rounds if glv else point_kernels.walk_rounds(c, False),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "chain_products": chain, "us_per_chain_product": ms * 1e3 / chain,
            })


def fused_plain(scalars: torch.Tensor, sets: int, pts: AffinePoints, c: int, block: int) -> JacobianPoints:
    """The fused schedule (msm/pippenger.py::_pippenger_fused_impl) through
    the plain versions of its five stages."""
    n = pts.x.shape[1]
    rounds, nb = msm_kernels.digit_rounds(c), 1 << (c - 1)
    m = -(-rounds * 2 * n // block) * block
    digits = msm_kernels.plain_glv_digits(scalars, sets, c, m, nb)
    entries = msm_kernels.sort_rounds(digits, rounds * nb)
    entries = entries._replace(order=entries.order % (2 * n))
    partials = msm_kernels.plain_bucket_accumulate(entries, *endo_points(pts), rounds * nb, block)
    windows = msm_kernels.plain_bucket_reduce_wide(partials, rounds * nb, None, nb)
    return msm_kernels.plain_window_combine(windows, c, sets)


def check_fused_msm(device, sizes: tuple, rng, records: list) -> None:
    """The fused Pippenger schedule at 2^k points for each k of ``sizes``
    (c = optimal_window: 8 at 2^12, 10 at 2^15), scalars with the edges 0, 1,
    r - 1 and 2^253, points with a repeated one and one at infinity: the
    kernels' result exactly against the plain stages' (fused_plain) and, in
    affine form, against the rounds-batched route and the host oracle
    (known_msm); at the largest, also G1_BATCH vectors as one fused launch
    set (pippenger_batch, what batched_msm runs there) against single calls
    and the oracle, and K3a and K3b-wide timed at their fused shapes."""
    curve, fr = get_g1(device), get_fr(device)
    for log2n in sizes:
        n = 1 << log2n
        c = optimal_window(n)
        nb, rounds = 1 << (c - 1), msm_kernels.digit_rounds(c)
        block = min(MSM_BLOCK, max(16, 2 * n))
        pts, ks = known_points(device, n, rng)
        vecs = [chain_scalars(n, rng) for _ in range(G1_BATCH)]
        enc = [fr.encode(v) for v in vecs]
        got = pippenger(enc[0], pts, fused=True)
        want = fused_plain(enc[0], 1, pts, c, block)
        err = max(max_abs_err(got[:3], want[:3]), int(got.inf.ne(want.inf).any()))
        if err:
            fail("kernels", f"the fused MSM disagrees with its plain stages at 2^{log2n} points")
        other = pippenger(enc[0], pts, fused=False)
        oracle = [known_msm(ks, vecs[0])]
        if not jacobian_to_host(got) == jacobian_to_host(other) == oracle:
            fail("kernels", f"the fused MSM disagrees with the rounds-batched route or the host at 2^{log2n} points")
        if log2n != max(sizes):
            continue
        batch = pippenger_batch(enc, pts, fused=True)  # what batched_msm runs there
        for b in range(G1_BATCH):
            single = pippenger(enc[b], pts, fused=True)
            if not same(JacobianPoints(*(t[..., b : b + 1] for t in batch)), single):
                fail("kernels", f"the fused batch's vector {b} disagrees with its single fused call at 2^{log2n} points")
        if jacobian_to_host(batch) != [known_msm(ks, v) for v in vecs]:
            fail("kernels", f"the fused batch disagrees with the host oracle at 2^{log2n} points")
        # K3a and K3b-wide at the fused shape of one vector (the msm path) and of the batch
        m = -(-rounds * 2 * n // block) * block
        px, py, pinf = endo_points(pts)
        for sets in (1, G1_BATCH):
            scal = enc[0] if sets == 1 else torch.cat(enc, dim=1)
            entries = msm_kernels.sort_rounds(msm_kernels.glv_digits(scal, sets, c, m, nb), rounds * nb)
            entries = entries._replace(order=entries.order % (2 * n))
            run_acc = lambda: msm_kernels.bucket_accumulate(entries, px, py, pinf, rounds * nb, block)
            partials = run_acc()
            want_p, acc_plain_ms = timed_once(
                lambda: msm_kernels.plain_bucket_accumulate(entries, px, py, pinf, rounds * nb, block), device)
            acc_err = max(int((partials.bucket - want_p.bucket).abs().max()), max_abs_err(partials.points, want_p.points))
            run_red = lambda: msm_kernels.bucket_reduce_wide(partials, rounds * nb, segment=nb)
            win = run_red()
            want_w, red_plain_ms = timed_once(
                lambda: msm_kernels.plain_bucket_reduce_wide(partials, rounds * nb, None, nb), device)
            red_err = max(max_abs_err(win[:3], want_w[:3]), int(win.inf.ne(want_w.inf).any()))
            if acc_err or red_err:
                fail("kernels", f"the fused K3a / K3b-wide disagree with their plain versions at {sets} x 2^{log2n}")
            k = partials.bucket.shape[1]
            partial_bytes = sets * k * (JAC_BYTES + 4)
            path = f"fused MSM, {sets} x 2^{log2n} points, c = {c}, block {block}"
            acc_b = bound(sets * m * 8 + 2 * n * (2 * ELEM_BYTES + 1) + partial_bytes,
                          accumulate_madds(entries, pinf, rounds * nb, block) * POINT_MULS["mixed_add"]
                          * IMAD_PER_FIELD_MUL)
            red_b = bound(partial_bytes + sets * rounds * JAC_BYTES,
                          wide_adds(partials.bucket, rounds * nb, nb) * POINT_MULS["add"] * IMAD_PER_FIELD_MUL)
            range_buckets = (msm_kernels.wide_range_buckets(rounds * nb, sets, device, nb)
                             if device.type == "cuda" else None)
            for name, op, err, run, plain_ms, (b_ms, b_by), shape in (
                    ("bucket_accumulate_fused", "bucket_accumulate", acc_err, run_acc, acc_plain_ms, acc_b,
                     [sets, m, block]),
                    ("bucket_reduce_wide_fused", "bucket_reduce_wide", red_err, run_red, red_plain_ms, red_b,
                     [sets, k, rounds * nb, nb])):
                records.append({
                    "name": name, "module": "msm", "op": op, "route": "cuda",
                    "source": "barretenberg_tpu_torch/csrc/msm_kernels.cu", "replaces": REPLACES[name],
                    "shape": shape, "path": path, "max_abs_err": err, "ms": time_ms(run, device, 5),
                    "device_ms": device_ms(run, device, f"{op}_kernel", 5), "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    **({"range_buckets": range_buckets} if op == "bucket_reduce_wide" else {}),
                })


# ---------------------------------------------------------------------------
# the pairing's chain kernels (K5a miller_loop, K5b final_exp)
# ---------------------------------------------------------------------------
SRS_SECRET = 0xA11CE  # test_srs's default secret: [tau]G2 of its SRS is one of K5a's Q
PAIR_LANES = 4096  # the sampled SRS check's lanes: 2,048 groups of 2
PAIR_SAMPLE = 2048  # bench.py's bench_srs_check sample (np.random.default_rng(99))
IDENTITY_LINES = [((1, 0), (0, 0), (0, 0))] * (len(pairing_kernels.NAF) + 2
                                               + sum(d != 0 for d in pairing_kernels.NAF))


def pairing_inputs(device, lanes: int, rng):
    """K5a's inputs as ``_prepare_lines`` makes them, ``lanes`` / 2 groups of
    two: group j pairs P_j and -P_j with one Q - the G2 generator,
    test_srs's [tau]G2, a random [k]G2, or a line list of identity rows
    (o = 1, vw = vv = 0), in turn - so every group's product is one. P_j
    cycles over 64 random points [k]G. Returns (inputs, step indices, host
    groups)."""
    ks = rand_values(64, FR_MODULUS, rng)
    pts = [host_curve.g1_mul(host_curve.G1_GENERATOR, k or 1) for k in ks]
    qs = [host_curve.G2_GENERATOR, host_curve.g2_mul(host_curve.G2_GENERATOR, SRS_SECRET % FR_MODULUS),
          host_curve.g2_mul(host_curve.G2_GENERATOR, rand_values(1, FR_MODULUS, rng)[0] or 1)]
    lists = [host_tower.precompute_miller_lines(q) for q in qs] + [IDENTITY_LINES]
    groups = []
    for j in range(lanes // 2):
        p, slot = pts[j % len(pts)], j % 4
        q = qs[slot] if slot < 3 else None
        groups.append([(p, q, lists[slot]), (host_curve.g1_neg(p), q, lists[slot])])
    prepared, steps, _ = _prepare_lines(groups, device)
    return prepared, steps, groups


def miller_bound(lanes: int, real_lanes: int, nq: int, n_lines: int):
    """K5a's bound: the line table read once, each lane's Q index, P and f
    moved once; MILLER_PRODUCTS a lane that pairs with a real Q (a lane
    whose lines are all the identity row needs none: its f stays one)."""
    return bound(nq * n_lines * pairing_kernels.LINE_WORDS * 4 + lanes * (4 + 2 * ELEM_BYTES + 12 * ELEM_BYTES),
                 real_lanes * pairing_kernels.MILLER_PRODUCTS * IMAD_PER_FIELD_MUL)


def final_exp_bound(lanes: int, gsize: int, real_groups: int):
    """K5b's bound: each lane's Miller value read once, each group's result
    written once; per group the fold's g - 1 Fq12 products and
    FINAL_EXP_PRODUCTS, in the groups whose Miller values are not all one
    (the final exponentiation of one needs no work)."""
    groups = lanes // gsize
    products = real_groups * (pairing_kernels.FINAL_EXP_PRODUCTS + (gsize - 1) * pairing_kernels.F12_MUL)
    return bound((lanes + groups) * 12 * ELEM_BYTES, products * IMAD_PER_FIELD_MUL)


def check_pairing_kernels(device, lanes: int, lanes_single: int, rng, records: list) -> None:
    """K5a miller_loop and K5b final_exp against their plain versions on the
    card (exact) on `lanes` lanes (pairing_inputs: P and -P against the same
    Q, the generator and [tau]G2 among the Q, lanes whose lines are all the
    identity row), K5b over groups of 2 and, on the first `lanes_single`
    lanes, of 1; the identity lanes' Miller value must be one, every group
    of two's pairing product one, and the first lanes equal the host tower's
    Miller loop and final exponentiation. Both timed at `lanes` lanes (K5b
    as the sampled SRS check runs it, groups of 2)."""
    (table, q_idx, px, py), (i1, i2), groups = pairing_inputs(device, lanes, rng)
    one = host_tower.FQ12_ONE
    run_ml = lambda: pairing_kernels.miller_loop(table, q_idx, px, py, i1, i2)
    f = run_ml()
    want_f, ml_plain_ms = timed_once(lambda: pairing_kernels.plain_miller_loop(table, q_idx, px, py, i1, i2), device)
    ml_err = max_abs_err([f], [want_f])
    tower = TwelfthField(SexticField(QuadraticField(get_fq("cpu"))))
    f_host = tower.decode(f.cpu())
    if ml_err:
        fail("kernels", f"miller_loop disagrees with its plain version at {lanes} lanes")
    if any(f_host[lane] != one for lane in range(lanes) if (lane // 2) % 4 == 3):
        fail("kernels", "miller_loop moved f off one on lanes whose lines are all the identity row")
    for lane in range(6):
        p, _, lines = groups[lane // 2][lane % 2]
        if f_host[lane] != host_tower.miller_loop_precomputed([p], [lines]):
            fail("kernels", f"miller_loop disagrees with the host tower on lane {lane}")
    run_fe = lambda: pairing_kernels.final_exp(f, 2)
    e = run_fe()
    want_e, fe_plain_ms = timed_once(lambda: pairing_kernels.plain_final_exp(f, 2), device)
    fe_err = max_abs_err([e], [want_e])
    head = f[..., :lanes_single].contiguous()
    e1 = pairing_kernels.final_exp(head, 1)
    fe_err = max(fe_err, max_abs_err([e1], [pairing_kernels.plain_final_exp(head, 1)]))
    if fe_err:
        fail("kernels", f"final_exp disagrees with its plain version ({lanes} lanes in pairs, {lanes_single} single)")
    if any(v != one for v in tower.decode(e.cpu())):
        fail("kernels", "final_exp gave a group of P and -P against one Q a product other than one")
    e1_host = tower.decode(e1.cpu())
    for lane in range(4):
        if e1_host[lane] != host_tower.final_exponentiation(f_host[lane]):
            fail("kernels", f"final_exp disagrees with the host tower on lane {lane}")
    path = "the sampled SRS check's shape: 2,048 groups of 2 lanes, one thread a lane (a group in K5b)"
    real_groups = sum(grp[0][1] is not None for grp in groups)
    for name, err, run, plain_ms, (b_ms, b_by), work, shape in (
            ("miller_loop", ml_err, run_ml, ml_plain_ms,
             miller_bound(lanes, 2 * real_groups, table.shape[0], table.shape[1]),
             pairing_kernels.MILLER_CHAIN_PRODUCTS, [lanes]),
            ("final_exp", fe_err, run_fe, fe_plain_ms, final_exp_bound(lanes, 2, real_groups),
             pairing_kernels.FINAL_EXP_CHAIN_PRODUCTS + pairing_kernels.F12_MUL, [lanes // 2, 2])):
        ms = time_ms(run, device, 3)
        records.append({
            "name": name, "module": "pairing", "op": name, "route": "cuda",
            "source": "barretenberg_tpu_torch/csrc/pairing.cu", "replaces": REPLACES[name], "shape": shape,
            "path": path, "max_abs_err": err, "ms": ms, "device_ms": device_ms(run, device, f"{name}_kernel", 3),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "real_lanes": 2 * real_groups, "chain_products": work, "us_per_chain_product": ms * 1e3 / work,
        })


# ---------------------------------------------------------------------------
COUNTED = {"field": field_kernels, "butterfly": butterfly, "point": point_kernels, "msm": msm_kernels,
           "pairing": pairing_kernels}


WINDOWS = ("golden", "small", "srs", "prove")  # the counted windows, in the order they run

# Commitment calls of one preprocess + prove: the sigma and selector
# batches of preprocess, then the wire batch, Z, the quotient batch and the
# opening batch. Below 2^10 gates (golden) each is a naive MSM, one K3d
# launch; from 2^10 to 2^18 (small, prove) each goes through the SRS's
# precomputed table, one K3a and one K3b-wide launch, after one K3f launch
# that builds the table.
COMMIT_CALLS = 6
# Their bucket sets per call: Z; the opening; sigmas, wires and quotient;
# the five selectors.
COMMIT_SETS = (1, 2, 3, 5)
# Lane-wise point kernels that run on no main path since K3d and K3e, K2's
# stage kernel, off the path since K2b, and K3b, one CTA a round, whose
# function K3b-wide computes on the rounds-batched Pippenger's path (the
# kernels phase still holds each against its plain version).
OFF_PATH = {("point", "dbl"), ("point", "mixed_add"), ("butterfly", "stage"), ("msm", "bucket_reduce")}
# K1 scan launches per window, one per scan the window runs: two per batch
# inversion (each batch normalisation of SRS generation, of the precomputed
# table and of the six commit calls' results; the grand product's
# denominators; the Lagrange denominators), the grand product's two
# products, the two powers tables of the evaluations (z^k over 3n, (z w)^k
# over n), the domains' power tables and the two Kate divisions. K1 dot
# launches: one per batch of evaluations (the five at z, the shifted one,
# t, r's value and the two Kate values); K1 lincomb launches: one per
# linear combination (r's two terms, the widget's terms with r, the two
# openings). And the most K1 mul and add launches each window may run (the
# counts measured on the card, PERF.md): a scan run as Hillis-Steele levels
# again would add one to two mul launches per level, an evaluation's
# halving tree of sums one add per level, a combination run term by term
# one mul and one add per term.
WINDOW_SCANS = {"golden": 36, "small": 38, "srs": 2, "prove": 36}
WINDOW_DOTS = {"golden": 6, "small": 6, "srs": 0, "prove": 6}
WINDOW_LINCOMBS = {"golden": 4, "small": 4, "srs": 0, "prove": 4}
WINDOW_MUL_MAX = {"golden": 95, "small": 95, "srs": 5, "prove": 90}
WINDOW_ADD_MAX = {"golden": 32, "small": 32, "srs": 0, "prove": 32}


def reset_counts() -> None:
    for mod in COUNTED.values():
        mod.reset_counts()
    wnaf.reset_counts()


def read_counts() -> dict:
    """The kernel wrappers' launches, and the eager GLV split's limb products
    on CUDA tensors (which K4 replaces) under "eager"."""
    counts = {name: dict(mod.launch_counts) for name, mod in COUNTED.items()}
    counts["eager"] = dict(wnaf.cuda_counts)
    return counts


def read_single_lane() -> dict:
    return {name: dict(mod.single_lane_counts) for name, mod in COUNTED.items() if hasattr(mod, "single_lane_counts")}


def add_counts(parts) -> dict:
    return {mod: {op: sum(p[mod][op] for p in parts) for op in ops} for mod, ops in parts[0].items()}


# transforms of the preprocess + prove window by domain size (log2 of size / n):
# 8 + 12 iFFTs at n, 5 coset FFTs with a constant and one coset iFFT at 2n,
# 7 coset FFTs and one coset iFFT at 4n
PROVE_TRANSFORMS = {0: 20, 1: 6, 2: 8}


def window_faults(window: str, counts: dict, naive_calls: int, srs_generations: int, table_calls: int) -> list:
    """What every counted window must show now that K3d, K3e and K3f carry
    the lane-wise chains and the prover commits through the precomputed
    table from 2^10 gates: no lane-wise point doubling or mixed add, one K3d
    launch per naive MSM, one K3e launch per SRS generation, and per
    commitment call through the table one K4, one K3a and one K3b-wide
    launch (one K3f for the table), with no per-round K3b, no Horner
    combine, no limb product of the eager GLV split on the card and, where
    no MSM is naive, no lane-wise add (the naive MSM's tree sums); one K1
    scan per scan of the window, one K1 dot per batch of evaluations, one
    K1 lincomb per linear combination, and no more K1 mul and add launches
    than the window's ceilings (a scan's level chain or an evaluation's
    tree of sums would add 4 to 18 each)."""
    want = {("field", "scan"): WINDOW_SCANS[window], ("field", "dot"): WINDOW_DOTS[window],
            ("field", "lincomb"): WINDOW_LINCOMBS[window], ("point", "dbl"): 0, ("point", "mixed_add"): 0,
            ("point", "scalar_mul_bits"): naive_calls, ("point", "fixed_base"): srs_generations,
            ("point", "table_rows"): min(1, table_calls), ("msm", "bucket_accumulate"): table_calls,
            ("msm", "bucket_reduce_wide"): table_calls, ("msm", "glv_digits"): table_calls,
            ("msm", "bucket_reduce"): 0, ("msm", "window_combine"): 0, ("eager", "mul_full_const"): 0}
    if not naive_calls:
        want[("point", "add")] = 0
    faults = [f"{mod}.{op}={counts[mod][op]} (want {v})" for (mod, op), v in want.items() if counts[mod][op] != v]
    for op, ceiling in (("mul", WINDOW_MUL_MAX[window]), ("add", WINDOW_ADD_MAX[window])):
        if counts["field"][op] > ceiling:
            faults.append(f"field.{op}={counts['field'][op]} (want at most {ceiling})")
    return faults


def chain_faults(counts: dict, log2n: int) -> list:
    """What the 2^16 windows (SRS generation + prove) must show now that
    K1 pow carries the Fermat chain and K2b the FFTs: one pow per inversion
    (8 batch normalisations - SRS generation, the precomputed table, six
    commitment calls - the grand product, the Lagrange denominators), only
    the squarings of batch_normalize's zinv^2, no K2 stage launch and
    exactly the pass plans' K2b launches (at most three per transform)."""
    passes = sum(t * len(fft.fft_plan(log2n + i)) for i, t in PROVE_TRANSFORMS.items())
    if passes > 3 * sum(PROVE_TRANSFORMS.values()):
        return [f"the pass plans take {passes} launches for {sum(PROVE_TRANSFORMS.values())} transforms"]
    want = {("field", "pow"): (10, 10), ("field", "sqr"): (0, 20),
            ("butterfly", "stage"): (0, 0), ("butterfly", "pass"): (passes, passes)}
    return [f"{mod}.{op}={counts[mod][op]} (want {lo}..{hi})"
            for (mod, op), (lo, hi) in want.items() if not lo <= counts[mod][op] <= hi]


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


# ---------------------------------------------------------------------------
# the circuit front end (phase "circuits", counted window "circuits")
CIRCUITS = ("sha256", "bool", "mimc", "extended")
# the domain tables a prove builds on first use, one K1 scan each, by
# domain (log2 of size / n): the iFFT's inverse twiddles and the grand
# product's roots at n; the coset FFTs' and iFFTs' twiddles and scales and
# the coset roots (boundary terms, vanishing division) at 2n and 4n
DOMAIN_TABLES = {0: ("inverse_twiddles", "_root_vector"),
                 1: ("twiddles", "inverse_twiddles", "coset_scale", "coset_scale_inverse", "_root_vector"),
                 2: ("twiddles", "inverse_twiddles", "coset_scale", "coset_scale_inverse", "_root_vector")}
# K1 mul and add launches of each widget's quotient chain (the arithmetic
# widget's are inside the prove window's ceilings): Bool (w^2 - w).q_b per
# wire; Sequential w_o(X.omega).q_oo; MiMC t0^3, t0.w_r^2, the alpha scale
# and the selector, t0 = w_o + w_l + q_mimc_c
WIDGET_MULS = {"ProverBoolWidget": 6, "ProverSequentialWidget": 1, "ProverMiMCWidget": 6}
WIDGET_ADDS = {"ProverBoolWidget": 3, "ProverSequentialWidget": 1, "ProverMiMCWidget": 4}
NORMALIZE_MULS = 5  # K1 mul launches of one batch normalisation of points


def srs_generations() -> int:
    return srs_cache._test_srs.cache_info().misses


def circuit_builds(prover, generations_before: int) -> dict:
    """What a prove builds that the run did not hold before it, read before
    its first commitment: the SRS (generated by test_srs since
    `generations_before`), the SRS's precomputed Pippenger table and the
    domain tables of DOMAIN_TABLES."""
    n = prover.n
    table = Prover._PRECOMP_MIN_N <= n <= Prover._PRECOMP_MAX_N
    return {"srs": srs_generations() - generations_before,
            "table": int(table and n not in prover.reference_string._pip_tables),
            "domain_tables": sum(name not in vars(get_domain(n << k, prover.device))
                                 for k, names in DOMAIN_TABLES.items() for name in names)}


def commit_route(n: int) -> str:
    """The prover's commitment schedule at n gates, the JAX prover's: the
    SRS's precomputed table from 2^10 to 2^18 gates ("table"), else the
    rounds-batched Pippenger from MSM_PIPPENGER_THRESHOLD points ("rounds")
    and the naive double-and-add below ("naive")."""
    if Prover._PRECOMP_MIN_N <= n <= Prover._PRECOMP_MAX_N:
        return "table"
    return "rounds" if n >= MSM_PIPPENGER_THRESHOLD else "naive"


def circuit_faults(counts: dict, widgets: list, commit_calls: int, n: int, builds: dict) -> list:
    """A circuit's launches: per commit call one K4, K3a and K3b-wide
    through the table (2^10 to 2^18 gates) and also one K3c on the
    rounds-batched Pippenger (above), one K3d below 2^10; one K3f per table
    and one K3e per SRS built; one K1 scan per scan (two per batch
    inversion - each batch normalisation of points, the grand product's
    denominators, the Lagrange denominators - the grand product's two
    products, the two powers tables, the two Kate divisions, each domain
    table built), one K1 pow per batch inversion, one K1 dot per batch of
    evaluations (the widgets' own rows ride the batch at z), one K1 lincomb
    per linear combination (r's first terms, one per widget, the two
    openings), no K3b, no lane-wise point doubling or mixed add, and K1 mul
    / add launches no more than the prove window's ceilings plus the
    widgets' chains, the commit calls' normalisations beyond the prove
    window's and, on the rounds route, each call's endomorphism x."""
    route = commit_route(n)
    inversions = commit_calls + builds["table"] + builds["srs"] + 2
    want = {("field", "scan"): 2 * inversions + 6 + builds["domain_tables"], ("field", "pow"): inversions,
            ("field", "dot"): 6, ("field", "lincomb"): 3 + len(widgets),
            ("point", "dbl"): 0, ("point", "mixed_add"): 0,
            ("point", "scalar_mul_bits"): commit_calls if route == "naive" else 0,
            ("point", "fixed_base"): builds["srs"], ("point", "table_rows"): builds["table"],
            ("msm", "bucket_reduce"): 0, ("msm", "window_combine"): commit_calls if route == "rounds" else 0,
            ("eager", "mul_full_const"): 0, ("butterfly", "stage"): 0}
    for op in ("glv_digits", "bucket_accumulate", "bucket_reduce_wide"):
        want[("msm", op)] = 0 if route == "naive" else commit_calls
    if route != "naive":
        want[("point", "add")] = 0
    faults = [f"{mod}.{op}={counts[mod][op]} (want {v})" for (mod, op), v in want.items() if counts[mod][op] != v]
    kinds = [type(w).__name__ for w in widgets]
    mul_max = (WINDOW_MUL_MAX["prove"] + NORMALIZE_MULS * (commit_calls - COMMIT_CALLS + builds["srs"])
               + sum(WIDGET_MULS.get(k, 0) for k in kinds) + (commit_calls if route == "rounds" else 0))
    add_max = WINDOW_ADD_MAX["prove"] + sum(WIDGET_ADDS.get(k, 0) for k in kinds)
    for op, ceiling in (("mul", mul_max), ("add", add_max)):
        if counts["field"][op] > ceiling:
            faults.append(f"field.{op}={counts['field'][op]} (want at most {ceiling})")
    return faults


def sub_counts(after: dict, before: dict) -> dict:
    return {mod: {op: v - before[mod][op] for op, v in ops.items()} for mod, ops in after.items()}


def rehearsal_uint32():
    """A small uint32 circuit (a witness word range-checked by its bits, and
    a normalised sum) in place of SHA-256 at toy size."""
    ctx = StandardComposer()
    a = Uint32.from_witness(witness_t(ctx, 0xAABBCCDD))
    (a + Uint32(ctx, value=0x11223344)).normalize()
    ctx.create_dummy_gates()
    return ctx


def circuit_record(name: str, gates: int, prover, proof, timings: dict, before: dict, builds: dict,
                   commit_calls: int, **extra) -> dict:
    launches = sub_counts(read_counts(), before)
    return {"circuit": name, "gates": gates, "n": prover.n, "widgets": [type(w).__name__ for w in prover.widgets],
            **extra, "prove_seconds": round(sum(timings.values()), 4), "phase_seconds": timings,
            "digest": hashlib.sha256(proof.serialize()).hexdigest(), "commit_calls": commit_calls,
            "builds": builds, "launches": launches,
            "faults": circuit_faults(launches, prover.widgets, commit_calls, prover.n, builds)}


def prove_circuit(name: str, device, rehearsal: bool) -> dict:
    """Build a bench circuit, preprocess it through its composer (the SRS
    from test_srs, on `device`), prove, verify, and reject a tampered proof.
    Returns the circuit's record, with the launches it took."""
    before, generations = read_counts(), srs_generations()
    t0 = time.perf_counter()
    if rehearsal:
        ctx = {"sha256": rehearsal_uint32,
               "bool": lambda: bench_circuit("bool", pairs=4), "mimc": lambda: bench_circuit("mimc", blocks=1),
               "extended": lambda: bench_circuit("extended", length=6)}[name]()
    else:
        ctx = bench_circuit(name)
    build_s = time.perf_counter() - t0
    gates = ctx.n
    t0 = time.perf_counter()
    prover = ctx.preprocess(device=device)
    builds = circuit_builds(prover, generations)
    verifier = preprocess(prover)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    preprocess_s = time.perf_counter() - t0
    timings: dict = {}
    proof = prover.construct_proof(timings)
    t0 = time.perf_counter()
    accepted = verifier.verify_proof(proof)
    verify_s = time.perf_counter() - t0
    tampered = copy.deepcopy(proof)
    tampered.w_l_eval = (tampered.w_l_eval + 1) % FR_MODULUS
    # the prove's four commit calls, the sigmas' and one per widget's selectors
    return circuit_record(name, gates, prover, proof, timings, before, builds, 4 + 1 + len(prover.widgets),
                          build_seconds=round(build_s, 3), preprocess_seconds=round(preprocess_s, 3),
                          verify_seconds=round(verify_s, 3), accepted=accepted,
                          tampered_accepted=verifier.verify_proof(tampered))


def prove_crosscheck(device, rehearsal: bool) -> dict:
    """The crosscheck fixture (bool_n256 on the card, arithmetic_n16 in the
    rehearsal) against test_srs(256): its proof's SHA-256 must be the
    reference C++ prover's. Its Bool selectors sit on rows whose wires are
    not boolean, so it is proved but not verified."""
    n, with_bool = (16, False) if rehearsal else (256, True)
    before, generations = read_counts(), srs_generations()
    prover = crosscheck_prover(test_srs(256, device=device), n, with_bool)
    builds = circuit_builds(prover, generations)
    timings: dict = {}
    proof = prover.construct_proof(timings)
    record = circuit_record(f"crosscheck_n{n}", n, prover, proof, timings, before, builds, 4)
    record["want_digest"] = CROSSCHECK_SHA256[(n, with_bool)]
    return record


def prove_large(device, n: int) -> dict:
    """The crosscheck fixture at n gates (arithmetic widget only) as a user
    proves it at the reference's size: test_srs(n) generated on the card,
    the fixture's prover (host), its verifier key, construct_proof, verify,
    and a tampered copy rejected. Returns the circuit record (launches,
    faults, digest) with the seconds of each step, the pass plans' K2b
    launches and faults beside circuit_faults': every K2b launch one pass
    of a plan of the window's transforms, the squarings only
    batch_normalize's."""
    before, generations = read_counts(), srs_generations()
    wall = time.perf_counter()
    srs, srs_s = timed_once(lambda: test_srs(n, device=device), device)
    prover, fixture_ms = timed_once(lambda: crosscheck_prover(srs, n), device)
    builds = circuit_builds(prover, generations)
    verifier, preprocess_ms = timed_once(lambda: preprocess(prover), device)
    timings: dict = {}
    proof = prover.construct_proof(timings)
    accepted, verify_ms = timed_once(lambda: verifier.verify_proof(proof), device)
    tampered = copy.deepcopy(proof)
    tampered.w_l_eval = (tampered.w_l_eval + 1) % FR_MODULUS
    record = circuit_record(f"crosscheck_n{n}", n, prover, proof, timings, before, builds, 4 + 1 + 1,
                            srs_seconds=round(srs_s / 1e3, 3), build_seconds=round(fixture_ms / 1e3, 3),
                            preprocess_seconds=round(preprocess_ms / 1e3, 3),
                            verify_seconds=round(verify_ms / 1e3, 3), accepted=accepted,
                            tampered_accepted=verifier.verify_proof(tampered))
    record["wall_seconds"] = round(time.perf_counter() - wall, 3)
    record["want_digest"] = CROSSCHECK_2E20_SHA256 if n == 1 << 20 else CROSSCHECK_SHA256[(n, False)]
    log2n = n.bit_length() - 1
    passes = sum(t * len(fft.fft_plan(log2n + i)) for i, t in PROVE_TRANSFORMS.items())
    launches = record["launches"]
    if launches["butterfly"]["pass"] != passes:
        record["faults"].append(f"butterfly.pass={launches['butterfly']['pass']} (want {passes})")
    if launches["field"]["sqr"] > 4 + 1 + 1 + builds["srs"]:
        record["faults"].append(f"field.sqr={launches['field']['sqr']} (want at most one per normalisation)")
    return record


# The G1 library surface as a user calls it (window "g1"): per call, the
# launches it must show beside no lane-wise dbl / add / mixed_add, no K3b,
# no K3f and no eager GLV limb product. A fused MSM is one K4, one sort,
# one K3a, one K3b-wide and one K3c; a windowed walk one K3g; a GLV walk one
# K4 and one K3g; hash_to_curve one K1 pow; scalar_mul one K3d;
# random_points_device one K3d and one batched normalisation (one pow).
FUSED_CALL = {("msm", "glv_digits"): 1, ("msm", "sort"): 1, ("msm", "bucket_accumulate"): 1,
              ("msm", "bucket_reduce_wide"): 1, ("msm", "window_combine"): 1}
G1_CALLS = {
    "msm_fused": FUSED_CALL,
    "batched_msm_fused": FUSED_CALL,
    "scalar_mul_windowed": {("point", "windowed_walk"): 1},
    "scalar_mul_glv": {("point", "windowed_walk"): 1, ("msm", "glv_digits"): 1},
    "scalar_mul": {("point", "scalar_mul_bits"): 1},
    "hash_to_curve": {("field", "pow"): 1},
    "random_points_device": {("point", "scalar_mul_bits"): 1, ("field", "pow"): 1},
}
G1_NONE = (("point", "dbl"), ("point", "add"), ("point", "mixed_add"), ("point", "table_rows"),
           ("point", "fixed_base"), ("msm", "bucket_reduce"), ("eager", "mul_full_const"))
G1_KERNELS = (("point", "windowed_walk"), ("point", "scalar_mul_bits"), ("field", "pow"), ("msm", "glv_digits"),
              ("msm", "bucket_accumulate"), ("msm", "bucket_reduce_wide"), ("msm", "window_combine"))


def g1_faults(name: str, counts: dict, sorts: int) -> list:
    want = dict.fromkeys(G1_KERNELS, 0)
    want.update(dict.fromkeys(G1_NONE, 0))
    want[("msm", "sort")] = 0
    want.update(G1_CALLS[name])
    got = {k: sorts if k == ("msm", "sort") else counts[k[0]][k[1]] for k in want}
    return [f"{name}: {mod}.{op}={got[(mod, op)]} (want {v})" for (mod, op), v in want.items() if got[(mod, op)] != v]


def run_g1_surface(device, rehearsal: bool, rng):
    """The G1 surface's entry points, each call with the counts set to 0 just
    before it and read just after: msm at 2^12 points and batched_msm of
    three vectors at 2^15 (the fused schedule's two ends), the windowed and
    GLV scalar multiplications and scalar_mul on 2^12 lanes, hash_to_curve
    and random_points_device for 2^12 points; then every result checked
    (host oracle, the curve equation, the plain path on the first lanes).
    Returns (record, the window's summed counts, faults)."""
    curve, fr = get_g1(device), get_fr(device)
    small, large = (64, 128) if rehearsal else (1 << 12, 1 << 15)
    pts, ks = known_points(device, small, rng)
    big, big_ks = known_points(device, large, rng)
    svals = walk_scalars(small, rng)
    s = fr.encode(svals)
    vecs = [chain_scalars(large, rng) for _ in range(G1_BATCH)]
    enc = [fr.encode(v) for v in vecs]
    k = rand_values(1, FR_MODULUS, rng)[0]
    seed = rng.bytes(32)
    draw = np.random.default_rng(int(rng.integers(1 << 62)))
    draw_state = copy.deepcopy(draw)
    calls = {
        "msm_fused": lambda: msm(s, pts),
        "batched_msm_fused": lambda: batched_msm(enc, big),
        "scalar_mul_windowed": lambda: curve.scalar_mul_windowed(pts, s, WALK_C),
        "scalar_mul_glv": lambda: scalar_mul_glv(pts, s, WALK_C),
        "scalar_mul": lambda: scalar_mul(pts, k),
        "hash_to_curve": lambda: hash_to_curve(seed, small, device=device),
        "random_points_device": lambda: random_points_device(small, draw, device=device),
    }
    sorts = [0]
    sort_rounds = msm_kernels.sort_rounds

    def counted_sort(*a, **kw):
        sorts[0] += 1
        return sort_rounds(*a, **kw)

    out, ms, parts, singles, faults = {}, {}, [], [], []
    msm_kernels.sort_rounds = counted_sort
    try:
        for name, fn in calls.items():
            reset_counts()
            sorts[0] = 0
            out[name], ms[name] = timed_once(fn, device)
            parts.append(read_counts())
            singles.append(read_single_lane())
            faults += g1_faults(name, parts[-1], sorts[0])
    finally:
        msm_kernels.sort_rounds = sort_rounds
    window, single = add_counts(parts), add_counts(singles)

    bad = []
    host_pts = [host_curve.g1_mul(host_curve.G1_GENERATOR, kk) for kk in ks[:16]]
    if jacobian_to_host(out["msm_fused"]) != [known_msm(ks, svals)]:
        bad.append("msm disagrees with the host oracle")
    if jacobian_to_host(out["batched_msm_fused"]) != [known_msm(big_ks, v) for v in vecs]:
        bad.append("batched_msm disagrees with the host oracle")
    win, glv = (curve.batch_normalize(out[n]) for n in ("scalar_mul_windowed", "scalar_mul_glv"))
    if not same(win, glv):
        bad.append("the windowed and GLV walks disagree in affine form")
    for name in ("scalar_mul_windowed", "scalar_mul_glv"):
        head = JacobianPoints(*(t[..., :16] for t in out[name]))
        if jacobian_to_host(head) != [host_curve.g1_mul(p, v) for p, v in zip(host_pts, svals[:16])]:
            bad.append(f"{name} disagrees with the host oracle")
    head = JacobianPoints(*(t[..., :16] for t in out["scalar_mul"]))
    if jacobian_to_host(head) != [host_curve.g1_mul(p, k) for p in host_pts]:
        bad.append("scalar_mul disagrees with the host oracle")
    h2c = out["hash_to_curve"]
    sample = points_to_host(AffinePoints(*(t[..., :64] for t in h2c)))
    if not bool(curve.on_curve_affine(h2c).all()) or h2c.inf.any() or not all(map(host_curve.g1_is_on_curve, sample)):
        bad.append("hash_to_curve gave a point off the curve")
    if not same(AffinePoints(*(t[..., :8].cpu() for t in h2c)), hash_to_curve(seed, 8, device="cpu")):
        bad.append("hash_to_curve's first lanes differ from the plain path's")
    rp = out["random_points_device"]
    want_rp = [host_curve.g1_mul(host_curve.G1_GENERATOR, int.from_bytes(draw_state.bytes(32), "little") % FR_MODULUS or 1)
               for _ in range(16)]
    if points_to_host(AffinePoints(*(t[..., :16] for t in rp))) != want_rp:
        bad.append("random_points_device disagrees with the host oracle")
    record = {"phase": "g1", "ok": True, "sizes": {"small": small, "large": large}, "walk_c": WALK_C,
              "call_ms": ms, "launches": window}
    return record, window, single, faults, bad


# The pairing and the SRS checks as a user calls them (window "pairing"):
# per call the pairing kernels' launches - one K5a and one K5b per pairing
# call - and at most PAIRING_FIELD_MAX lane-wise K1 launches (an Fq12 op run
# as K1 launches would take 54 products alone); the on-curve sweep is four
# K1 launches, each RLC check two Pippenger MSMs (one K4, sort, K3a,
# K3b-wide and K3c each at 2^20 points).
PAIRING_CALL = {("pairing", "miller_loop"): 1, ("pairing", "final_exp"): 1}
MSM_PAIR = {("msm", "glv_digits"): 2, ("msm", "bucket_accumulate"): 2, ("msm", "bucket_reduce_wide"): 2,
            ("msm", "window_combine"): 2}
ON_CURVE = {("pairing", "miller_loop"): 0, ("pairing", "final_exp"): 0, ("field", "sqr"): 2, ("field", "mul"): 1,
            ("field", "add"): 1}
PAIRING_CALLS = {
    "known_answer": PAIRING_CALL,
    "bilinearity": PAIRING_CALL,
    "srs_on_curve_all": ON_CURVE,
    "validate_srs_rlc": {**PAIRING_CALL, **MSM_PAIR},
    "validate_srs_device": PAIRING_CALL,
    "corrupted_device": PAIRING_CALL,
    "corrupted_rlc": {**PAIRING_CALL, **MSM_PAIR},
    "corrupted_on_curve": ON_CURVE,
}
PAIRING_FIELD_MAX = 32
CORRUPT_K = 999  # the corrupted SRS holds [999]G at one sampled index


def pairing_faults(name: str, counts: dict, large: bool) -> list:
    want = dict(PAIRING_CALLS[name])
    if not large:  # below 4096 points the RLC's MSMs are naive (K3d), not Pippenger
        want = {k: v for k, v in want.items() if k[0] != "msm"}
    faults = [f"{name}: {mod}.{op}={counts[mod][op]} (want {v})" for (mod, op), v in want.items()
              if counts[mod][op] != v]
    lanewise = sum(counts["field"][op] for op in ("mul", "sqr", "add", "sub"))
    if lanewise > PAIRING_FIELD_MAX:
        faults.append(f"{name}: {lanewise} lane-wise K1 launches (want at most {PAIRING_FIELD_MAX})")
    return faults


def corrupted_srs(srs, index: int, off_curve: bool):
    """A copy of `srs` with monomial `index` replaced by [CORRUPT_K]G, or
    (off_curve) by that point with y + 1."""
    x, y = host_curve.g1_mul(host_curve.G1_GENERATOR, CORRUPT_K)
    fq = get_fq(srs.monomials.x.device)
    mono = AffinePoints(srs.monomials.x.clone(), srs.monomials.y.clone(), srs.monomials.inf.clone())
    mono.x[:, index] = fq.encode([x])[:, 0]
    mono.y[:, index] = fq.encode([y + 1 if off_curve else y])[:, 0]
    return srs_cache.ReferenceString(mono, srs.g2_x, srs.degree)


def run_pairing(device, n: int, rng):
    """The pairing's entry points on test_srs(n) (the large phase's SRS),
    each call with the counts set to 0 just before it and read just after:
    the host oracle's known answer e(7G, 11G2), the bilinearity groups,
    srs_on_curve_all, validate_srs_rlc and validate_srs_device over
    bench.py's sample of PAIR_SAMPLE indices (np.random.default_rng(99)),
    then the three checks on a corrupted copy. Returns (record, the window's
    summed counts and single-lane counts, faults, wrong answers)."""
    srs = test_srs(n, device=device)
    idx = sorted(np.random.default_rng(99).choice(n - 1, size=min(PAIR_SAMPLE, n - 1), replace=False).tolist())
    bad_index = idx[len(idx) // 2]
    bad = corrupted_srs(srs, bad_index, False)
    off = corrupted_srs(srs, bad_index, True)
    p7 = host_curve.g1_mul(host_curve.G1_GENERATOR, 7)
    q11 = host_curve.g2_mul(host_curve.G2_GENERATOR, 11)
    pa, qb = host_curve.g1_mul(host_curve.G1_GENERATOR, 6), host_curve.g2_mul(host_curve.G2_GENERATOR, 13)
    pab = host_curve.g1_mul(host_curve.G1_GENERATOR, 6 * 13)
    bil = [[(pa, qb), (host_curve.g1_neg(pab), host_curve.G2_GENERATOR)], [(pa, qb), (pab, host_curve.G2_GENERATOR)]]
    calls = {
        "known_answer": (lambda: reduced_ate_pairing(p7, q11, device), host_tower.reduced_ate_pairing_batch([(p7, q11)])),
        "bilinearity": (lambda: pairing_check_groups(bil, device), [True, False]),
        "srs_on_curve_all": (lambda: srs_on_curve_all(srs), True),
        "validate_srs_rlc": (lambda: validate_srs_rlc(srs), True),
        "validate_srs_device": (lambda: validate_srs_device(srs, idx), True),
        "corrupted_device": (lambda: validate_srs_device(bad, idx), False),
        "corrupted_rlc": (lambda: validate_srs_rlc(bad), False),
        "corrupted_on_curve": (lambda: srs_on_curve_all(off), False),
    }
    out, ms, parts, singles, faults, wrong = {}, {}, [], [], [], []
    for name, (fn, want) in calls.items():
        reset_counts()
        out[name], ms[name] = timed_once(fn, device)
        parts.append(read_counts())
        singles.append(read_single_lane())
        faults += pairing_faults(name, parts[-1], n >= MSM_PIPPENGER_THRESHOLD)
        if out[name] != want:
            wrong.append(f"{name} gave {out[name] if isinstance(out[name], (bool, list)) else 'another value'}"
                         f" (want {want if isinstance(want, (bool, list)) else 'the host oracle'})")
    record = {"phase": "pairing", "ok": True, "n": n, "sampled_indices": len(idx), "corrupted_index": bad_index,
              "call_ms": ms, "on_curve_seconds": round(ms["srs_on_curve_all"] / 1e3, 4),
              "rlc_seconds": round(ms["validate_srs_rlc"] / 1e3, 4),
              "sampled_seconds": round(ms["validate_srs_device"] / 1e3, 4),
              "results": {k: v for k, v in out.items() if isinstance(v, (bool, list))}}
    return record, add_counts(parts), add_counts(singles), faults, wrong


# The lane-wise tower and G2 (fields/quadratic.py, fields/tower.py,
# groups/g2.py) on the card: each op below runs on TOWER_LANES lanes on
# the card and on the CPU, exactly equal, its lanes equal to the host
# oracle, and it launches as many K1 kernels of each kind as the CPU call
# runs plain Fq ops - one K1 launch an Fq op - and no other kernel.
TOWER_LANES = 256
G2_SCALAR_BITS = 32


def count_plain_fq_ops(fn):
    """fn()'s result and the Fq ops, by K1 op, that it ran through K1's
    plain versions (a CPU call)."""
    calls = dict.fromkeys(("mul", "sqr", "add", "sub", "pow"), 0)
    plain, plain_pow = field_kernels.plain, field_kernels.plain_pow

    def counted(params, op, a, b=None):
        calls[op] += 1
        return plain(params, op, a, b)

    def counted_pow(params, a, exponent):
        calls["pow"] += 1
        return plain_pow(params, a, exponent)

    field_kernels.plain, field_kernels.plain_pow = counted, counted_pow
    try:
        return fn(), calls
    finally:
        field_kernels.plain, field_kernels.plain_pow = plain, plain_pow


def tower_g2_inputs(lanes: int, bits: int, rng):
    """Host values: G2 points P, Q over 32 random multiples of the generator
    with edge lanes (Q = P, Q = -P, P, Q or both at infinity), `bits`-bit
    scalars (0 and 1 in front), random Fq12 values a, b, cyclotomic values
    and sparse lines (o, vw, vv)."""
    pts = [host_curve.g2_mul(host_curve.G2_GENERATOR, k or 1) for k in rand_values(32, FR_MODULUS, rng)]
    ps = [pts[lane % 32] for lane in range(lanes)]
    qs = [pts[(lane * 7 + 3) % 32] for lane in range(lanes)]
    qs[0], qs[1] = ps[0], host_curve.g2_neg(ps[1])
    ps[2], qs[3], ps[4], qs[4] = None, None, None, None
    ks = [v % (1 << bits) for v in rand_values(lanes, FR_MODULUS, rng)]
    ks[:2] = [0, 1]
    q = host_tower.P

    def f2s(n):
        vals = rand_values(2 * n, q, rng)
        return [tuple(vals[2 * i:2 * i + 2]) for i in range(n)]

    def f12s(n):
        vals = f2s(6 * n)
        return [(tuple(vals[6 * i:6 * i + 3]), tuple(vals[6 * i + 3:6 * i + 6])) for i in range(n)]

    a, b = f12s(lanes), f12s(lanes)
    cyc = []
    for x in a:
        e = host_tower.fq12_mul(host_tower.fq12_conj(x), host_tower.fq12_inv(x))
        cyc.append(host_tower.fq12_mul(e, host_tower.fq12_frobenius(e, 2)))
    return ps, qs, ks, a, b, cyc, (f2s(lanes), f2s(lanes), f2s(lanes))


def check_tower_g2(device, lanes: int, bits: int, rng):
    """The tower and G2 ops on `device` against the same calls on the CPU
    and the host oracle, each call counted alone. Returns (record, launch
    faults, wrong answers)."""
    ps, qs, ks, a, b, cyc, (o, vw, vv) = tower_g2_inputs(lanes, bits, rng)
    ht, hc = host_tower, host_curve
    zero2 = (0, 0)
    want = {
        "g2_add": [hc.g2_add(p, q) for p, q in zip(ps, qs)],
        "g2_dbl": [hc.g2_add(p, p) for p in ps],
        "g2_mixed_add": [hc.g2_add(p, q) for p, q in zip(ps, qs)],
        "g2_scalar_mul_bits": [hc.g2_mul(p, k) if p is not None else None for p, k in zip(ps, ks)],
        "fq12_mul": [ht.fq12_mul(x, y) for x, y in zip(a, b)],
        "fq12_sqr": [ht.fq12_sqr(x) for x in a],
        **{f"fq12_frobenius_{k}": [ht.fq12_frobenius(x, k) for x in a] for k in (1, 2, 3)},
        "fq12_cyclotomic_sqr": [ht.fq12_cyclotomic_sqr(x) for x in cyc],
        "fq12_sparse_mul": [ht.fq12_mul(x, ((u, zero2, w), (zero2, v, zero2))) for x, u, v, w in zip(a, o, vw, vv)],
        "fq12_invert": [ht.fq12_inv(x) for x in a],
    }

    def setup(dev):
        g2c, f12 = g2_curve(dev), fq12_field(dev)
        f2 = f12.fq2
        pa, qa = g2_host_to_affine(ps, dev), g2_host_to_affine(qs, dev)
        bit_rows = torch.tensor([[(k >> (bits - 1 - i)) & 1 for k in ks] for i in range(bits)], dtype=torch.int32,
                                device=dev)
        ta, tb, tc = f12.encode(a), f12.encode(b), f12.encode(cyc)
        lo, lw, lv = f2.encode(o), f2.encode(vw), f2.encode(vv)
        pj, qj = g2c.to_jacobian(pa), g2c.to_jacobian(qa)
        return {
            "g2_add": lambda: g2c.add(pj, qj),
            "g2_dbl": lambda: g2c.dbl(pj),
            "g2_mixed_add": lambda: g2c.mixed_add(pj, qa),
            "g2_scalar_mul_bits": lambda: g2c.scalar_mul_bits(pa, bit_rows),
            "fq12_mul": lambda: f12.mul(ta, tb),
            "fq12_sqr": lambda: f12.sqr(ta),
            **{f"fq12_frobenius_{k}": (lambda k=k: f12.frobenius(ta, k)) for k in (1, 2, 3)},
            "fq12_cyclotomic_sqr": lambda: f12.cyclotomic_sqr(tc),
            "fq12_sparse_mul": lambda: f12.sparse_mul(ta, lo, lw, lv),
            "fq12_invert": lambda: f12.invert(ta),
        }

    on_card, on_cpu = setup(device), setup(torch.device("cpu"))
    f12_cpu = fq12_field("cpu")
    record, faults, wrong = {}, [], []
    for name, run in on_card.items():
        run()  # warm-up, uncounted
        reset_counts()
        got, ms = timed_once(run, device)
        counts = read_counts()
        ref, calls = count_plain_fq_ops(on_cpu[name])
        if name.startswith("g2_"):
            got_t, ref_t = [got.x.cpu(), got.y.cpu(), got.z.cpu()], [ref.x, ref.y, ref.z]
            same = max_abs_err(got_t, ref_t) == 0 and torch.equal(got.inf.cpu(), ref.inf)
            host = g2_jacobian_to_host(ref)
        else:
            same = max_abs_err([got.cpu()], [ref]) == 0
            host = f12_cpu.decode(ref)
        if not same:
            wrong.append(f"{name} on the card differs from the same call on the CPU")
        if host != want[name]:
            wrong.append(f"{name} disagrees with the host oracle")
        k1 = {op: counts["field"][op] for op in calls}
        others = {f"{mod}.{op}": v for mod, ops in counts.items() for op, v in ops.items()
                  if v and not (mod == "field" and op in calls)}
        if k1 != calls or others:
            faults.append(f"{name}: K1 launches {k1}, the CPU call's Fq ops {calls}, other launches {others}")
        record[name] = {"call_ms": ms, "k1_launches": sum(k1.values())}
    return {"lanes": lanes, "scalar_bits": bits, "ops": record}, faults, wrong


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
    # K1 dot and lincomb at one lane, a few, 2^11, the prove's n and 3n
    # (the timed shapes are at the second last, n)
    dot_sizes = (1, 3, 17, 64, 192) if rehearsal else (1, 3, 1 << 11, 1 << log2n, 3 << log2n)
    check_field_kernels(device, lanes, wide, dot_sizes, rng, records)
    check_field_pow(device, lanes, rng, records)
    # K1 scan: ragged sizes and tile edges (1,024 elements a CTA), every
    # size the prove scans (the batch normalisations of a commit call's 1-5
    # results, the 2^11 and 2^16 tables' 16 x 2^11 and 13 x 2^16 points,
    # the grand product, powers tables, Kate divisions and domain tables at
    # n / 2 to 4n), timed at 2^16 and beside it
    scan_sizes = (1, 2, 3, 5, 17, 31, 32, 33, 64, 1023, 1024, 1025, 2048 + 7)
    if not rehearsal:
        scan_sizes += (1 << 11, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 16 << 11, 13 << 16)
    check_field_scan(device, scan_sizes, (64, 1025) if rehearsal else
                     (1 << log2n, 3, 1 << 11, 1 << (log2n + 1), 1 << (log2n + 2), 13 << log2n), rng, records)
    check_butterfly(device, 8 if rehearsal else 16, 6 if rehearsal else log2n + 2, rng, records)
    check_fft_pass(device, (4, 6) if rehearsal else (4, 10),
                   (6, 7, 8) if rehearsal else (log2n, log2n + 1, log2n + 2), (4, 1), rng, records)
    # lanes per launch of the lane-wise kernels as the path ran them before
    # K3d and K3e: SRS generation's fixed-base mixed adds over all n lanes,
    # the golden proof's naive MSMs over 16 lanes (its tree sums still add
    # 16 lanes)
    point_shapes = {"dbl": 16, "add": 16, "mixed_add": min(lanes, 1 << log2n)}
    check_point_kernels(device, lanes, point_shapes, rng, records)
    # K3d at the golden proof's 16 and 3 x 16 lanes and the 2^11 prove's 3 x
    # 2048 and 5 x 2048 (its widest batch, preprocess's selectors); K3e at
    # 16 lanes and SRS generation's n
    small = 32 if rehearsal else 2048
    smb_shapes = ((16, 1), (16, 3), (small, 3), (small, 5))
    check_point_chains(device, smb_shapes, (16, min(lanes, 1 << log2n)), rng, records)
    check_msm_kernels(device, log2n, 8 * MSM_BLOCK if rehearsal else 16 * MSM_BLOCK, rng, records)
    # K3c's groups: 1-3 chains (one warp) and 33 (nine CTAs) at c = 8, 10, 13
    check_combine_chains(device, (4,) if rehearsal else (8, 10, 13), (1, 2, 5) if rehearsal else (1, 2, 3, 33), rng)
    check_precomputed(device, 5 if rehearsal else 11, log2n, () if rehearsal else (13,), rng, records)
    check_glv_digits(device, 6 if rehearsal else log2n, rng, records)
    # the 2^20 prove's rounds-batched MSM (c = 13; K3b-wide and K3b, K3c at
    # 1-3 chains), K2b's 4-pass plans and K1 scan at its width
    check_rounds_msm(device, 6 if rehearsal else 16, 7 if rehearsal else LARGE_LOG2N, 5 if rehearsal else LARGE_C,
                     rng, records)
    check_fft_pass_large(device, (9, 10) if rehearsal else tuple(LARGE_FFT), rng, records)
    check_scans_large(device, 1 << (11 if rehearsal else LARGE_LOG2N), rng)
    # the G1 surface's kernels: K3g (windowed and GLV at c = 5) on 2^12 lanes
    # with edge lanes, timed at 2^16; the fused schedule at 2^12 and 2^15
    # points (K3a and K3b-wide timed at the 2^15 shapes)
    check_windowed_walk(device, 16 if rehearsal else 1 << 12, 32 if rehearsal else 1 << 16, rng, records)
    check_fused_msm(device, (6, 7) if rehearsal else (12, 15), rng, records)
    # the pairing's chain kernels at the sampled SRS check's 4,096 lanes
    check_pairing_kernels(device, 16 if rehearsal else PAIR_LANES, 8 if rehearsal else 256, rng, records)
    wrong = [r["name"] for r in records if r["max_abs_err"] != 0]
    if wrong:
        fail("kernels", f"timed kernels disagree with their plain versions: {wrong}")
    emit({"phase": "kernels", "ok": True, "lanes_checked": lanes, "kernels": [
        {k: r[k] for k in ("name", "shape", "max_abs_err", "ms", "plain_ms")} for r in records]})

    # ---- phase 3: golden digest (counted window "golden") ----------------
    counts: dict = {}
    single: dict = {}
    reset_counts()
    proof, accepted, tampered_accepted = prove_and_verify(16, 7, device)
    counts["golden"], single["golden"] = read_counts(), read_single_lane()
    blob = proof.serialize()
    digest = keccak256(blob).hex()
    if len(blob) != 800 or digest != GOLDEN_DIGEST or not accepted or tampered_accepted:
        fail("golden", f"bytes={len(blob)} digest={digest} accepted={accepted} tampered_accepted={tampered_accepted}")
    faults = [] if rehearsal else window_faults("golden", counts["golden"], COMMIT_CALLS, 1, 0)
    if faults:
        fail("golden", f"launches over the n = 16 SRS generation + prove: {faults}")
    emit({"phase": "golden", "ok": True, "bytes": len(blob), "digest": digest})

    # ---- phase 4: a small circuit (window "small") --------------------------
    # 2^11 gates: SRS generation + preprocess + prove + verify, every
    # commitment through the SRS's precomputed table (c = 8, 17 rows)
    small_n = 1 << (5 if rehearsal else 11)
    reset_counts()
    t0 = time.perf_counter()
    test_srs(small_n, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    small_srs_s = time.perf_counter() - t0
    small_timings: dict = {}
    t0 = time.perf_counter()
    proof, accepted, tampered_accepted = prove_and_verify(small_n, args.seed, device, small_timings)
    small_total_s = time.perf_counter() - t0
    counts["small"], single["small"] = read_counts(), read_single_lane()
    if not accepted or tampered_accepted:
        fail("small_prove", f"n={small_n} accepted={accepted} tampered_accepted={tampered_accepted}")
    faults = [] if rehearsal else window_faults("small", counts["small"], 0, 1, COMMIT_CALLS)
    if faults:
        fail("small_prove", f"launches over the n = {small_n} SRS generation + prove: {faults}")
    emit({"phase": "small_prove", "ok": True, "n": small_n, "srs_seconds": small_srs_s,
          "prove_seconds": sum(small_timings.values()), "phase_seconds": small_timings,
          "preprocess_prove_verify_seconds": small_total_s, "launches": counts["small"]})

    # ---- phase 5: MSM against the host oracle ----------------------------
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

    # ---- phase 6: the slice at a real size --------------------------------
    # the main path is SRS generation + preprocess + prove + verify (counted
    # windows "srs" and "prove"); with the golden and small windows, every
    # kernel of the path must have launched
    n = 1 << log2n
    reset_counts()
    t0 = time.perf_counter()
    test_srs(n, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    srs_s = time.perf_counter() - t0
    counts["srs"], single["srs"] = read_counts(), read_single_lane()
    timings: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    proof, accepted, tampered_accepted = prove_and_verify(n, args.seed, device, timings)
    total_s = time.perf_counter() - t0
    counts["prove"], single["prove"] = read_counts(), read_single_lane()
    main_counts = add_counts([counts["srs"], counts["prove"]])
    if not accepted or tampered_accepted:
        fail("prove", f"n={n} accepted={accepted} tampered_accepted={tampered_accepted}")
    if not rehearsal:
        faults = [f"srs: {f}" for f in window_faults("srs", counts["srs"], 0, 1, 0)]
        if Prover._PRECOMP_MIN_N <= n <= Prover._PRECOMP_MAX_N:
            faults += [f"prove: {f}" for f in window_faults("prove", counts["prove"], 0, 0, COMMIT_CALLS)]
            faults += chain_faults(main_counts, log2n)
        if faults:
            fail("prove", f"launches over SRS generation + prove: {faults}")
    emit({"phase": "prove", "ok": True, "n": n, "srs_seconds": round(srs_s, 3),
          "prove_seconds": round(sum(timings.values()), 3), "phase_seconds": timings,
          "preprocess_prove_verify_seconds": round(total_s, 3),
          "launches": counts, "single_lane_launches": single, "srs_prove_launches": main_counts,
          "peak_device_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None})

    # ---- phase 7: the circuit front end (window "circuits") ---------------
    # the reference's bench circuits built with the composers and stdlib
    # gadgets - SHA-256 of "abc" at n = 2^16 on the prove phase's SRS and
    # table, Bool, MiMC and Extended at 2^12 - then the crosscheck fixture
    reset_counts()
    t0 = time.perf_counter()
    circuits = [prove_circuit(name, device, rehearsal) for name in CIRCUITS]
    cross = prove_crosscheck(device, rehearsal)
    circuits_s = time.perf_counter() - t0
    counts["circuits"], single["circuits"] = read_counts(), read_single_lane()
    bad = [f"{c['circuit']}: accepted={c['accepted']} tampered_accepted={c['tampered_accepted']}"
           for c in circuits if not c["accepted"] or c["tampered_accepted"]]
    bad += [f"{c['circuit']}: digest {c['digest']} (pinned {BENCH_DIGESTS[c['circuit']]})"
            for c in circuits if not rehearsal and c["circuit"] in BENCH_DIGESTS
            and c["digest"] != BENCH_DIGESTS[c["circuit"]]]
    if cross["digest"] != cross["want_digest"]:
        bad.append(f"{cross['circuit']}: sha256 {cross['digest']} (CROSSCHECK.json {cross['want_digest']})")
    if not rehearsal:
        bad += [f"{c['circuit']} launches: {c['faults']}" for c in circuits + [cross] if c["faults"]]
    if bad:
        fail("circuits", "; ".join(bad))
    for c in circuits + [cross]:
        emit({"phase": "circuit", **{k: v for k, v in c.items() if k != "faults"}})
    emit({"phase": "circuits", "ok": True, "seconds": round(circuits_s, 3), "launches": counts["circuits"]})

    # ---- phase 8: the reference's size (window "large") --------------------
    # the crosscheck fixture at n = 2^20 gates against test_srs(2^20) made on
    # the card: the proof must be the reference C++ prover's bytes
    # (CROSSCHECK.json arithmetic_2e20) and verify; every commit call of
    # preprocess and prove is one rounds-batched Pippenger launch set (K4,
    # K3a, K3b-wide, K3c)
    reset_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    large = prove_large(device, 1 << (4 if rehearsal else LARGE_LOG2N))
    counts["large"], single["large"] = read_counts(), read_single_lane()
    bad = []
    if not large["accepted"] or large["tampered_accepted"]:
        bad.append(f"accepted={large['accepted']} tampered_accepted={large['tampered_accepted']}")
    if large["digest"] != large["want_digest"]:
        bad.append(f"sha256 {large['digest']} (CROSSCHECK.json {large['want_digest']})")
    if not rehearsal and large["faults"]:
        bad.append(f"launches: {large['faults']}")
    if bad:
        fail("large", f"n={large['n']}: " + "; ".join(bad))
    emit({"phase": "large", "ok": True, **{k: v for k, v in large.items() if k != "faults"},
          "peak_device_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None})

    # ---- phase 9: the pairing and the SRS checks (window "pairing") ---------
    # on the large phase's test_srs(2^20): the known answer, the bilinearity
    # groups, the on-curve sweep, the RLC check and the sampled per-index
    # check (one K5a and one K5b a pairing call), then a corrupted copy
    t0 = time.perf_counter()
    pair_record, counts["pairing"], single["pairing"], faults, bad = run_pairing(device, 1 << (4 if rehearsal else LARGE_LOG2N), rng)
    tower_record, faults_tg, bad_tg = check_tower_g2(device, 8 if rehearsal else TOWER_LANES,
                                                      8 if rehearsal else G2_SCALAR_BITS, rng)
    bad += bad_tg + ([] if rehearsal else faults + faults_tg)
    if bad:
        fail("pairing", "; ".join(bad))
    emit({**pair_record, "seconds": round(time.perf_counter() - t0, 3), "launches": counts["pairing"],
          "tower_g2": tower_record})

    # ---- phase 10: the G1 library surface (window "g1") --------------------
    # the fused Pippenger schedule through msm (2^12) and batched_msm (3 x
    # 2^15), the windowed and GLV scalar multiplications (K3g), scalar_mul,
    # hash_to_curve and random_points_device, each call counted alone
    t0 = time.perf_counter()
    g1_record, counts["g1"], single["g1"], faults, bad = run_g1_surface(device, rehearsal, rng)
    bad += [] if rehearsal else faults
    if bad:
        fail("g1", "; ".join(bad))
    emit({**g1_record, "seconds": round(time.perf_counter() - t0, 3)})

    # ---- results ----------------------------------------------------------
    windows = WINDOWS + ("circuits", "large", "pairing", "g1")
    all_counts = add_counts([counts[w] for w in windows])
    if not rehearsal:
        idle = [f"{mod}.{op}" for mod in COUNTED for op, v in all_counts[mod].items()
                if v == 0 and (mod, op) not in OFF_PATH]
        if idle:
            fail("done", f"kernels never launched in the counted windows {windows}: {idle}")
    for r in records:
        mod, op = r.pop("module"), r.pop("op")
        r["launches"] = all_counts[mod][op]
        r["launches_by_window"] = {w: counts[w][mod][op] for w in windows}
        if op in single["prove"].get(mod, {}):
            r["single_lane_launches"] = sum(single[w][mod][op] for w in windows)
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
