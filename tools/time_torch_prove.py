#!/usr/bin/env python3
"""Seconds of SRS generation and preprocess + prove + verify of the
PyTorch/CUDA port, in a fresh process.

    python3 tools/time_torch_prove.py [--log2-n 11 [16 ...]] [--seed 7]
    python3 tools/time_torch_prove.py --fixture crosscheck --log2-n 20

Proves a fixture circuit at each size in turn, in one process, after one
untimed n = 16 prove that builds and loads the kernels, and prints one JSON
line per size with the card's name and power limit. `--fixture random`
(the default) is the arithmetic-gate circuit that chip_smoke.py proves
(`chip_smoke.prove_and_verify`: verifier-key preprocessing,
`Prover.construct_proof` with its phase timings, `verify_proof` of the proof
and of a tampered copy). `--fixture crosscheck` is the splitmix fixture
that the reference C++ prover proves (`fixtures.crosscheck_prover`, against
`test_srs(n)`): its host build is timed apart (`fixture_seconds`), and the
proof's SHA-256 is printed beside CROSSCHECK.json's for that size, which it
must equal where the file has one.
Where the reference string has a precomputed Pippenger table and the prover
commits through it (2^10 <= n <= 2^18), the table is built after SRS
generation and timed on its own (`table_seconds`, `table_bytes` on the
card), so `preprocess_prove_verify_seconds` excludes it; without one (an
earlier commit, or n outside that range) both are null.
It uses only what chip_smoke.py and fixtures.py have offered since the
circuit front end was ported, so the same file, copied into a checkout of
an earlier commit, times that commit the same way (compare two commits only
in turns within one call on one card).
Needs one CUDA device; fails if the proof is rejected, the tampered one
accepted or a pinned digest missed.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from barretenberg_tpu_torch.fixtures import crosscheck_prover  # noqa: E402
from barretenberg_tpu_torch.fields.params import FR_MODULUS  # noqa: E402
from barretenberg_tpu_torch.plonk import preprocess  # noqa: E402
from barretenberg_tpu_torch.srs import test_srs  # noqa: E402
from chip_smoke import prove_and_verify  # noqa: E402


def pinned_digest(n: int):
    """CROSSCHECK.json's SHA-256 of the reference C++ prover's proof of the
    crosscheck fixture at n gates without the Bool widget, or None."""
    with open(os.path.join(ROOT, "CROSSCHECK.json")) as f:
        cases = json.load(f)["cases"]
    return next((c["proof_sha256"] for c in cases if c["n"] == n and not c["with_bool"]), None)


def prove_crosscheck(n: int, device, timings: dict):
    """The crosscheck fixture's prover (host build, timed), its verifier key,
    the proof and its verification, and a tampered copy's."""
    srs = test_srs(n, device=device)
    t0 = time.perf_counter()
    prover = crosscheck_prover(srs, n)
    fixture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verifier = preprocess(prover)
    proof = prover.construct_proof(timings)
    accepted = verifier.verify_proof(proof)
    total_s = time.perf_counter() - t0
    tampered = copy.deepcopy(proof)
    tampered.w_l_eval = (tampered.w_l_eval + 1) % FR_MODULUS
    return proof, accepted, verifier.verify_proof(tampered), fixture_s, total_s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-n", type=int, nargs="+", default=[11])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--fixture", choices=("random", "crosscheck"), default="random")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if 4 in args.log2_n or len(set(args.log2_n)) != len(args.log2_n):
        print("each size once, and not 2^4, the warm-up's own size: its SRS would be cached", file=sys.stderr)
        return 1
    prove_and_verify(16, 7, device)  # warm-up: builds and loads the kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for log2n in args.log2_n:
        n = 1 << log2n
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        srs = test_srs(n, device=device)
        torch.cuda.synchronize(device)
        srs_s = time.perf_counter() - t0
        table_s = table_bytes = None
        if hasattr(srs, "pippenger_table") and 1 << 10 <= n <= 1 << 18:
            t0 = time.perf_counter()
            table = srs.pippenger_table(n)
            torch.cuda.synchronize(device)
            table_s = time.perf_counter() - t0
            table_bytes = table.rows.numel() * table.rows.element_size()
        timings: dict = {}
        fixture_s = digest = want = None
        if args.fixture == "crosscheck":
            proof, accepted, tampered_accepted, fixture_s, total_s = prove_crosscheck(n, device, timings)
            digest, want = hashlib.sha256(proof.serialize()).hexdigest(), pinned_digest(n)
        else:
            t0 = time.perf_counter()
            _, accepted, tampered_accepted = prove_and_verify(n, args.seed, device, timings)
            total_s = time.perf_counter() - t0
        print(json.dumps({
            "n": n, "fixture": args.fixture, "card": smi, "srs_seconds": srs_s, "table_seconds": table_s,
            "table_bytes": table_bytes, "fixture_seconds": fixture_s, "prove_seconds": sum(timings.values()),
            "phase_seconds": timings, "preprocess_prove_verify_seconds": total_s,
            "peak_device_bytes": torch.cuda.max_memory_allocated(device), "sha256": digest, "pinned_sha256": want,
        }), flush=True)
        if not accepted or tampered_accepted or (want is not None and digest != want):
            print(f"n={n} accepted={accepted} tampered_accepted={tampered_accepted} sha256={digest} (pinned {want})",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
