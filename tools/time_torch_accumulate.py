#!/usr/bin/env python3
"""K3a ``bucket_accumulate``'s walk length, measured.

    python3 tools/time_torch_accumulate.py [--reps 5]

Builds the bucket entries the prover's commitments hand K3a - the SRS
table's rows at 2^11 points (c = 8) and 2^16 points (c = 10), with 1 and 3
sets of seeded scalars, as chip_smoke.py builds them - and for each block of
8 to 128 times K3a (CUDA events) and K3b-wide ``bucket_reduce_wide`` on its
partials, so that their sum per call can be read beside the block
``msm_kernels.accumulate_block`` picks from the occupancy query. K3a is
first held against its plain version at 2^11 points. Prints one JSON line
per case, and one with what ptxas reported for K3a (empty when the library
was built by an earlier process). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from barretenberg_tpu_torch.fields import fr as get_fr  # noqa: E402
from barretenberg_tpu_torch.fields.params import FR_MODULUS  # noqa: E402
from barretenberg_tpu_torch.groups.g1 import fixed_base_mul, g1 as get_g1  # noqa: E402
from barretenberg_tpu_torch.kernels import build, msm_kernels, point_kernels  # noqa: E402
from barretenberg_tpu_torch.msm import generate_pippenger_point_table  # noqa: E402
from barretenberg_tpu_torch.msm.pippenger import precomputed_digits  # noqa: E402
from chip_smoke import rand_values, same, time_ms  # noqa: E402

def table_cases(device, rng) -> dict:
    """(rows, sorted entries of 1 and of 3 sets, nbuckets) at the 2^11 and
    2^16 table shapes."""
    fr = get_fr(device)
    cases = {}
    for log2n, c in ((11, 8), (16, 10)):
        n = 1 << log2n
        pts = get_g1(device).batch_normalize(fixed_base_mul(rand_values(n, FR_MODULUS, rng), device))
        table = generate_pippenger_point_table(pts, c)
        rows = table.entries(128)  # a multiple of every block <= 128
        nb = 1 << (c - 1)
        enc = [fr.encode(rand_values(n, FR_MODULUS, rng)) for _ in range(3)]
        for sets in (1, 3):
            digits = precomputed_digits(enc[:sets], c, rows.shape[0])
            cases[f"2^{log2n}_{sets}set"] = (rows, msm_kernels.sort_rounds(digits, nb), nb)
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_accumulate: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(args.seed)
    cases = table_cases(device, rng)

    rows, entries, nb = cases["2^11_1set"]
    for block in (8, 128):
        got = msm_kernels.bucket_accumulate_rows(entries, rows, nb, block)
        want = msm_kernels.plain_bucket_accumulate(entries, *point_kernels.row_points(rows), nb, block)
        if not (torch.equal(got.bucket, want.bucket) and same(got.points, want.points)):
            print(f"time_torch_accumulate: K3a disagrees with its plain version at block {block}", file=sys.stderr)
            return 1

    capacity = msm_kernels.accumulate_capacity(device)
    for case, (rows, entries, nb) in cases.items():
        sets, m = entries.order.shape
        k3a, wide, slots = {}, {}, {}
        for block in msm_kernels.ACC_BLOCKS:
            partials = msm_kernels.bucket_accumulate_rows(entries, rows, nb, block)
            k3a[block] = time_ms(lambda: msm_kernels.bucket_accumulate_rows(entries, rows, nb, block),
                                 device, args.reps)
            wide[block] = time_ms(lambda: msm_kernels.bucket_reduce_wide(partials, nb), device, args.reps)
            slots[block] = partials.bucket.shape[1]
        total = {b: k3a[b] + wide[b] for b in wide}
        print(json.dumps({
            "case": case, "sets": sets, "entries": sets * m, "nbuckets": nb,
            "capacity": capacity, "chosen_block": msm_kernels.accumulate_block(sets * m, capacity),
            "fastest_block": min(total, key=total.get), "k3a_ms": k3a, "wide_ms": wide,
            "k3a_plus_wide_ms": total, "partial_slots": slots, "device": smi,
        }), flush=True)
    print(json.dumps({"ptxas": kernel_usage(build.build_log.get("msm_kernels", ""), "bucket_accumulate_kernel")}),
          flush=True)
    return 0


def kernel_usage(log: str, kernel: str) -> list:
    """ptxas' lines (stack frame and spills, registers) for one kernel of a
    build's -Xptxas -v report."""
    out, current = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line
        elif kernel in current and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


if __name__ == "__main__":
    sys.exit(main())
