#!/usr/bin/env python3
"""Determinism check of the G1 surface's kernels, and of torch.profiler's
device timing, on the card.

    python3 tools/repeat_torch_g1.py [--repeats 12] [--sessions 40] [--seed 11]

Runs each entry point of chip_smoke.py's `g1` phase once on seeded inputs
(the fused MSM at 2^12 and 2^15 points and `batched_msm` of three 2^15
vectors, the rounds-batched `pippenger` at 2^15, the windowed and GLV walks
on 2^16 lanes, `hash_to_curve` of 2^12 points), then `--repeats` times
more, each repeat after filling 2 GiB of the caching allocator's memory with
random words and freeing it, so that a kernel that reads memory it never
wrote, or races, gives other limbs. Then counts the torch.profiler sessions
(each over five K1 dot launches at 5 x 2^16 lanes) in which the profiler
saw no device time for the kernel. Prints one line per entry point, the
profiler count and the card's name and power limit, and exits non-zero if
any repeat differs from the first run. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def dirty(device) -> None:
    junk = [torch.randint(-2**31, 2**31 - 1, (1 << 26,), dtype=torch.int32, device=device) for _ in range(8)]
    torch.cuda.synchronize(device)
    del junk


def flat(out) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.int64).cpu() for t in out])


def profiler_misses(fr, device, rng, sessions: int) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows = [cs.rand_lanes((1 << 16,), device, rng) for _ in range(5)]
    table = cs.rand_lanes((3 << 16,), device, rng)[:, : 1 << 16]
    misses = 0
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fr.dot(rows, table)
            torch.cuda.synchronize(device)
        seen = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if not any("field_dot_kernel" in e.key and e.self_device_time_total > 0 for e in seen):
            misses += 1
    return misses


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=12)
    ap.add_argument("--sessions", type=int, default=40)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_torch_g1: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    curve, fr = cs.get_g1(device), cs.get_fr(device)
    small, large, lanes = 1 << 12, 1 << 15, 1 << 16
    pts, _ = cs.known_points(device, small, rng)
    big, _ = cs.known_points(device, large, rng)
    wide, _ = cs.known_points(device, lanes, rng)
    s = fr.encode(cs.walk_scalars(small, rng))
    sw = fr.encode(cs.walk_scalars(lanes, rng))
    enc = [fr.encode(cs.chain_scalars(large, rng)) for _ in range(cs.G1_BATCH)]
    big_s = fr.encode(cs.chain_scalars(large, rng))
    seed = rng.bytes(32)
    calls = {
        "msm_fused_2e12": lambda: cs.msm(s, pts),
        "pippenger_fused_2e15": lambda: cs.pippenger(big_s, big),
        "pippenger_rounds_2e15": lambda: cs.pippenger(big_s, big, fused=False),
        "batched_msm_fused_3x2e15": lambda: cs.batched_msm(enc, big),
        "scalar_mul_windowed_2e16": lambda: curve.scalar_mul_windowed(wide, sw, cs.WALK_C),
        "scalar_mul_glv_2e16": lambda: cs.scalar_mul_glv(wide, sw, cs.WALK_C),
        "hash_to_curve_2e12": lambda: cs.hash_to_curve(seed, small, device=device),
    }
    t0 = time.perf_counter()
    differing = {}
    for name, fn in calls.items():
        first = flat(fn())
        differing[name] = 0
        for _ in range(args.repeats):
            dirty(device)
            differing[name] += not torch.equal(flat(fn()), first)
        print(f"{name}: {differing[name]} of {args.repeats} repeats differ from the first run", flush=True)
    misses = profiler_misses(fr, device, rng, args.sessions)
    print(f"profiler sessions without device time for field_dot_kernel: {misses} of {args.sessions}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; {time.perf_counter() - t0:.1f} s")
    return 1 if any(differing.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
