#!/usr/bin/env python3
"""Where the device time of one port prove goes.

    python3 tools/profile_torch_prove.py [--log2-n 16] [--top 12] [--fixture random]
    python3 tools/profile_torch_prove.py --fixture crosscheck --log2-n 20

Runs `Prover.construct_proof` of the PyTorch/CUDA port on a fixture circuit
- the arithmetic-gate circuit chip_smoke.py proves (`random`, the default)
or the splitmix fixture the reference C++ prover proves (`crosscheck`,
`fixtures.crosscheck_prover`) - under `torch.profiler`, after one untraced
warm-up prove, and prints one JSON line: wall seconds, summed
device seconds of all kernels, the device's busy share of the wall, the
number of device operations (kernels and copies) the prove ran, its
``index_select`` calls (gathers), its ``torch.roll`` kernels, the top
kernels by device time, and for each of the port's kernel wrappers its
launches in the traced prove (from the wrappers' counters; single-lane
launches apart) beside the profiler's calls and device time for the CUDA
kernel it launches, so that launches x (device time per call - bound) can
be read from one run. A second traced prove runs each prover phase (the
methods `construct_proof` calls) inside a profiler range fenced by device
synchronisations and gives, per phase, its wall seconds, device
operations, ``roll`` kernels and device milliseconds (the sigma bases,
computed inline, fall under "other"); the phase methods are looked up by
name, so the tool also runs in a checkout of the port's parent commit.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from barretenberg_tpu_torch import convert  # noqa: E402
from barretenberg_tpu_torch.fixtures import crosscheck_prover  # noqa: E402
from barretenberg_tpu_torch.kernels import butterfly, field_kernels, msm_kernels, point_kernels  # noqa: E402
from barretenberg_tpu_torch.srs import test_srs  # noqa: E402
from chip_smoke import fixture_arrays  # noqa: E402


COUNTED = {"field": field_kernels, "butterfly": butterfly, "point": point_kernels, "msm": msm_kernels}
# The CUDA kernel (as the profiler names it) each wrapper's counter stands for.
KERNEL_NAMES = {
    "field.mul": "field_op_kernel<0>", "field.sqr": "field_op_kernel<1>",
    "field.add": "field_op_kernel<2>", "field.sub": "field_op_kernel<3>",
    "field.pow": "field_pow_kernel", "field.scan": "field_scan_kernel", "field.dot": "field_dot_kernel",
    "field.lincomb": "field_lincomb_kernel", "butterfly.stage": "butterfly_stage_kernel",
    "butterfly.pass": "fft_pass_kernel",
    "point.dbl": "point_dbl_kernel", "point.add": "point_add_kernel<false>",
    "point.mixed_add": "point_add_kernel<true>", "msm.bucket_accumulate": "bucket_accumulate_kernel",
    "msm.bucket_reduce": "bucket_reduce_kernel", "msm.window_combine": "window_combine_kernel",
    "point.scalar_mul_bits": "scalar_mul_bits_kernel", "point.fixed_base": "fixed_base_kernel",
    "point.table_rows": "table_rows_kernel", "msm.bucket_reduce_wide": "bucket_reduce_wide_kernel",
    "msm.glv_digits": "glv_digits_kernel", "point.windowed_walk": "windowed_walk_kernel",
}


def kernel_launches(rows) -> dict:
    """Per counted op: the wrapper's launches (and single-lane launches) and
    the profiler's calls and device seconds for the kernel it launches."""
    out = {}
    for mod_name, mod in COUNTED.items():
        single = getattr(mod, "single_lane_counts", {})
        for op, n in mod.launch_counts.items():
            key = f"{mod_name}.{op}"
            match = [r for r in rows if KERNEL_NAMES[key] in r[0]]
            out[key] = {
                "launches": n, "single_lane_launches": single.get(op),
                "profiler_calls": sum(r[1] for r in match),
                "device_seconds": sum(r[2] for r in match) / 1e6,
            }
    return out


# torch.roll's CUDA kernel, as the profiler names it (not a substring of
# PyTorch's unrolled elementwise kernels).
ROLL_KERNEL = "roll_cuda_kernel"

# The prover phases construct_proof runs as methods, in order.
PHASES = ("compute_wire_coefficients", "compute_wire_commitments", "compute_z_coefficients",
          "compute_z_commitment", "compute_quotient_polynomial", "compute_quotient_commitment",
          "compute_opening_elements")


def fence_phases(prover, device) -> None:
    """Wrap each phase method of this prover in a profiler range, with a device
    synchronisation before it and at its end, so that its kernels run inside
    the range."""
    for name in PHASES:
        def fenced(fn=getattr(prover, name), name=name):
            torch.cuda.synchronize(device)
            with record_function(f"phase.{name}"):
                out = fn()
                torch.cuda.synchronize(device)
            return out
        setattr(prover, name, fenced)


def phase_breakdown(events) -> dict:
    """Per phase range: its wall seconds, the device operations (kernels and
    copies) that started inside it, their device milliseconds, how many of
    them were ``torch.roll``'s kernel, and the three kernels that took most
    of them."""
    ranges = [(e.name[len("phase."):], e.time_range.start, e.time_range.end)
              for e in events if e.name.startswith("phase.") and e.device_type == DeviceType.CPU]
    out = {name: {"wall_seconds": (t1 - t0) / 1e6, "device_ops": 0, "device_ms": 0.0, "roll_ops": 0,
                  "by_kernel": {}} for name, t0, t1 in ranges}
    out["other"] = {"wall_seconds": None, "device_ops": 0, "device_ms": 0.0, "roll_ops": 0, "by_kernel": {}}
    for e in events:
        # the phase ranges and device synchronisations show on the device's
        # timeline too; they are no device operations
        if e.device_type != DeviceType.CUDA or e.name.startswith("phase.") or "Synchronize" in e.name:
            continue
        t = e.time_range.start
        name = next((nm for nm, t0, t1 in ranges if t0 <= t <= t1), "other")
        ms = e.time_range.elapsed_us() / 1e3
        out[name]["device_ops"] += 1
        out[name]["device_ms"] += ms
        out[name]["roll_ops"] += ROLL_KERNEL in e.name
        out[name]["by_kernel"][e.name[:40]] = out[name]["by_kernel"].get(e.name[:40], 0.0) + ms
    for phase in out.values():
        top = sorted(phase.pop("by_kernel").items(), key=lambda kv: -kv[1])[:3]
        phase["top_kernels_ms"] = dict(top)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-n", type=int, default=16)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--fixture", choices=("random", "crosscheck"), default="random")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    n = 1 << args.log2_n
    srs = test_srs(n, device=device)
    if args.fixture == "crosscheck":
        def new_prover():
            return crosscheck_prover(srs, n)
    else:
        arrays = fixture_arrays(n, 7)

        def new_prover():
            return convert.prover_from_arrays(n, srs, *arrays)
    new_prover().construct_proof()  # warm-up: builds tables (domains, the SRS's Pippenger table)
    prover = new_prover()
    torch.cuda.synchronize(device)
    for mod in COUNTED.values():
        mod.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prover.construct_proof()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    # kernel rows only: an aten op's row repeats the time of the kernels it launched
    rows = [
        (e.key, e.count, e.self_device_time_total)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[2])
    device_s = sum(r[2] for r in rows) / 1e6
    kernels = kernel_launches(rows)
    prover = new_prover()
    fence_phases(prover, device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as fenced:
        prover.construct_proof()
    phases = phase_breakdown(fenced.events())
    fenced_device_s = sum(e.self_device_time_total for e in fenced.key_averages()
                          if e.device_type == DeviceType.CUDA and not e.key.startswith("phase.")) / 1e6
    print(json.dumps({
        "n": n, "fixture": args.fixture, "device": torch.cuda.get_device_name(0), "traced_wall_seconds": wall,
        "device_seconds": device_s, "device_busy_share": device_s / wall,
        "device_ops": sum(r[1] for r in rows),
        "roll_ops": sum(r[1] for r in rows if ROLL_KERNEL in r[0]),
        "index_select_calls": sum(e.count for e in prof.key_averages() if e.key == "aten::index_select"),
        "top": [{"name": k[:60], "calls": c, "device_seconds": t / 1e6} for k, c, t in rows[: args.top]],
        "kernels": kernels,
        "phases": phases, "fenced_device_seconds": fenced_device_s,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
