#!/usr/bin/env python3
"""Times the port's FFT over Fr on one CUDA device, per pass plan.

    python3 tools/time_torch_fft.py [--log2n 16 17 18] [--tiles 9:3 10:3 ...]

For each size, the transform the 2^16 prove runs most at that size (2^16:
ifft, 2^17: coset_fft_with_constant, 2^18: coset_fft) runs through K2b
``fft_pass`` with the pass plan of each tile (``fft_plan(log2n, tile_log,
col_log)``, given as tile_log:col_log) and, beside it, through the K2
stage-by-stage path the port ran before K2b (``chip_smoke.stage_path``).
Every result is first checked against the stage path (exact). Prints one
JSON line per (size, path): mean ms per transform (CUDA events over
back-to-back calls), device ms per transform (``torch.profiler``, one
session per path: the summed time of every device operation it records;
the tool fails if that is zero), launches per transform, and the
transform's bound (``chip_smoke.fft_bound``); then the card's name and
power limit.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from barretenberg_tpu_torch.fields import fr as get_fr  # noqa: E402
from barretenberg_tpu_torch.kernels import butterfly, field_kernels  # noqa: E402
from barretenberg_tpu_torch.polynomials import fft, get_domain  # noqa: E402
from chip_smoke import FFT_VARIANTS, TIMED_VARIANTS, fft_bound, stage_path, time_ms  # noqa: E402

TILES = ("8:2", "9:3", "10:3", "11:3", "12:3")


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of `fn`: one profiler session of its own
    around `reps` calls (after a warm-up), so that every device operation the
    session records is fn's; the sum of their device times over `reps`.
    Raises if the profiler recorded no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / 1e3 / reps


def launches(fn) -> dict:
    for mod in (butterfly, field_kernels):
        mod.reset_counts()
    fn()
    return {"butterfly.pass": butterfly.launch_counts["pass"], "butterfly.stage": butterfly.launch_counts["stage"],
            "field.mul": field_kernels.launch_counts["mul"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, nargs="+", default=[16, 17, 18])
    ap.add_argument("--tiles", nargs="+", default=list(TILES))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    field = get_fr(device)
    rng = np.random.default_rng(5)
    for log2n in args.log2n:
        name = TIMED_VARIANTS[min(2, max(0, log2n - 16))]
        inv, coset, val = FFT_VARIANTS[name]
        d = get_domain(1 << log2n, device)
        x = field.random_elements(1 << log2n, rng)
        want = stage_path(x, d, inv, coset, val)
        b_ms, b_by = fft_bound(log2n, inv, coset, val)
        paths = {"stage_path": lambda: stage_path(x, d, inv, coset, val)}
        plans = {"stage_path": None}
        for tile in args.tiles:
            tile_log, col_log = (int(v) for v in tile.split(":"))
            plan = fft.fft_plan(log2n, tile_log, col_log)
            if not torch.equal(fft.transform(x, d, inv, coset, val, plan), want):
                print(json.dumps({"log2n": log2n, "tile": tile, "ok": False}), flush=True)
                return 1
            paths[f"fft_pass {tile}"] = lambda plan=plan: fft.transform(x, d, inv, coset, val, plan)
            plans[f"fft_pass {tile}"] = plan
        for path, fn in paths.items():
            print(json.dumps({
                "log2n": log2n, "transform": name, "path": path, "plan": plans[path],
                "default_plan": plans[path] == fft.fft_plan(log2n),
                "ms": time_ms(fn, device, args.reps), "device_ms": device_ms(fn, 5),
                "launches": launches(fn), "bound_ms": b_ms, "bound_by": b_by,
            }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
