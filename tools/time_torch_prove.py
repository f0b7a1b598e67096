#!/usr/bin/env python3
"""Seconds of SRS generation and preprocess + prove + verify of the
PyTorch/CUDA port, in a fresh process.

    python3 tools/time_torch_prove.py [--log2-n 11 [16 ...]] [--seed 7]

Proves the arithmetic-gate fixture circuit that chip_smoke.py proves
(`chip_smoke.prove_and_verify`: verifier-key preprocessing,
`Prover.construct_proof` with its phase timings, `verify_proof` of the proof
and of a tampered copy) at each size in turn, in one process, after one
untimed n = 16 prove that builds and loads the kernels, and prints one JSON
line per size with the card's name and power limit.
Where the reference string has a precomputed Pippenger table and the prover
commits through it (2^10 <= n <= 2^18), the table is built after SRS
generation and timed on its own (`table_seconds`, `table_bytes` on the
card), so `preprocess_prove_verify_seconds` excludes it; without one (an
earlier commit) both are null.
It uses only what chip_smoke.py has offered since the port began, so the same
file, copied into a checkout of an earlier commit, times that commit the
same way (compare two commits only in turns within one call on one card).
Needs one CUDA device; fails if the proof is rejected or the tampered one
accepted.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from barretenberg_tpu_torch.srs import test_srs  # noqa: E402
from chip_smoke import prove_and_verify  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-n", type=int, nargs="+", default=[11])
    ap.add_argument("--seed", type=int, default=7)
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
        t0 = time.perf_counter()
        _, accepted, tampered_accepted = prove_and_verify(n, args.seed, device, timings)
        total_s = time.perf_counter() - t0
        if not accepted or tampered_accepted:
            print(f"n={n} accepted={accepted} tampered_accepted={tampered_accepted}", file=sys.stderr)
            return 1
        print(json.dumps({
            "n": n, "card": smi, "srs_seconds": srs_s, "table_seconds": table_s, "table_bytes": table_bytes,
            "prove_seconds": sum(timings.values()),
            "phase_seconds": timings, "preprocess_prove_verify_seconds": total_s,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
