#!/usr/bin/env python3
"""Where K3b-wide ``bucket_reduce_wide``'s time goes.

    python3 tools/time_torch_wide.py [--reps 10]

Builds the bucket sets the precomputed-table MSM hands K3b-wide (K3a over
the SRS table's rows, seeded scalars, as chip_smoke.py builds them) at c = 8
(2^11 points, 3 sets), c = 10 (2^16 points: 3 sets, one set, and one set
whose partials all fall in one bucket) and c = 13 (2^16 points, 3 sets),
times the kernel per call with CUDA events, then runs a debug build of
``csrc/msm_kernels.cu`` (``-DBB_WIDE_STAMPS``) that stamps %globaltimer at
each CTA's start and after its merge levels, its bucket scatter and the
suffix scans, and prints one JSON line per case: the milliseconds per call
and, per set (mean over the sets and the runs), the time from the first
CTA's start to the last merge's end, from there to the last scatter's end,
and from there to the end of the scans. A last line times the one set at
c = 10 cut into 8 to 18 clusters, beside the most clusters CUDA's
occupancy query says the card holds at once. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from barretenberg_tpu_torch.fields import fr as get_fr  # noqa: E402
from barretenberg_tpu_torch.fields.params import FR_MODULUS  # noqa: E402
from barretenberg_tpu_torch.groups import JacobianPoints  # noqa: E402
from barretenberg_tpu_torch.groups.g1 import fixed_base_mul, g1 as get_g1  # noqa: E402
from barretenberg_tpu_torch.kernels import build, msm_kernels  # noqa: E402
from barretenberg_tpu_torch.msm import generate_pippenger_point_table  # noqa: E402
from barretenberg_tpu_torch.msm.pippenger import precomputed_digits  # noqa: E402
from chip_smoke import MSM_BLOCK, one_bucket_digits, rand_values, time_ms  # noqa: E402

PHASES = ("merge_ms", "scatter_ms", "scans_ms")


def bucket_sets(device, log2n: int, c: int, rng) -> dict:
    """The cases at one table shape: 3 sets, and at c = 10 also one set and
    the one-bucket set of every entry."""
    n = 1 << log2n
    pts = get_g1(device).batch_normalize(fixed_base_mul(rand_values(n, FR_MODULUS, rng), device))
    table = generate_pippenger_point_table(pts, c)
    rows = table.entries(MSM_BLOCK)
    nb = 1 << (c - 1)
    fr = get_fr(device)
    enc = [fr.encode(rand_values(n, FR_MODULUS, rng)) for _ in range(3)]

    def partials(digits):
        return msm_kernels.bucket_accumulate_rows(msm_kernels.sort_rounds(digits, nb), rows, nb, MSM_BLOCK)

    p3 = partials(precomputed_digits(enc, c, rows.shape[0]))
    cases = {f"c{c}_3sets": p3}
    if c == 10:
        k = p3.bucket.shape[1]
        cases[f"c{c}_1set"] = msm_kernels.Partials(
            p3.bucket[:1].contiguous(), JacobianPoints(*(t[..., :k].contiguous() for t in p3.points)))
        cases[f"c{c}_one_bucket"] = partials(one_bucket_digits(rows.shape[0], rows.shape[0]).to(device))
    return {name: (p, nb) for name, p in cases.items()}


def stamped_phases(partials, nb: int, lib, reps: int) -> tuple:
    """The stamped build's result and its per-set phase milliseconds, mean
    over the sets and ``reps`` runs."""
    sets = partials.bucket.shape[0]
    rb = msm_kernels.wide_range_buckets(nb, sets, partials.bucket.device)
    host = (ctypes.c_uint64 * (4 * sets))()
    lib.bb_wide_stamps(ctypes.addressof(host), sets)  # reset
    sums = np.zeros(3)
    for _ in range(reps):
        got = msm_kernels._launch_reduce_wide(partials, nb, rb, lib=lib)
        torch.cuda.synchronize()
        err = lib.bb_wide_stamps(ctypes.addressof(host), sets)
        if err:
            raise RuntimeError(f"bb_wide_stamps failed: cudaError {err}")
        st = np.array(host, dtype=np.int64).reshape(sets, 4)  # ns since the epoch: keep integers
        sums += np.diff(st, axis=1).mean(axis=0) / 1e6
    return got, dict(zip(PHASES, (sums / reps).tolist()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_wide: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(args.seed)
    cases = {}
    for log2n, c in ((11, 8), (16, 10), (16, 13)):
        cases.update(bucket_sets(device, log2n, c, rng))
    prod = msm_kernels.bucket_reduce_wide
    times = {name: time_ms(lambda: prod(p, nb), device, args.reps) for name, (p, nb) in cases.items()}
    wants = {name: prod(p, nb) for name, (p, nb) in cases.items()}
    stamped = build.load_variant("msm_kernels", ("BB_WIDE_STAMPS",),
                                 {"bb_wide_stamps": [ctypes.c_void_p, ctypes.c_int]})
    for name, (p, nb) in cases.items():
        got, phases = stamped_phases(p, nb, stamped, args.reps)
        same = all(torch.equal(a, b) for a, b in zip(got, wants[name]))
        print(json.dumps({"case": name, "sets": p.bucket.shape[0], "slots": p.bucket.shape[1],
                          "live_partials": int((p.bucket < nb).sum()), "nbuckets": nb,
                          "ms": times[name], **phases, "stamped_equal": same, "device": smi}), flush=True)
    p, nb = cases["c10_1set"]
    print(json.dumps({"case": "c10_1set_by_clusters", "max_active_clusters": msm_kernels.wide_max_clusters(nb, device),
                      "ms_by_clusters": {k: time_ms(lambda k=k: prod(p, nb, -(-nb // k)), device, args.reps)
                                         for k in range(8, 19)},
                      "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
