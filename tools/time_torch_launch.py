#!/usr/bin/env python3
"""Host microseconds of a K1 launch, part by part.

    python3 tools/time_torch_launch.py [--reps 2000]

Times, on the card, the statements a K1 wrapper runs to launch one
one-lane ``mul`` - each statement alone, back to back, host clock
(``time.perf_counter_ns``) over `reps` calls after a warm-up: the operand
broadcast (at 2^16 lanes against an (18, 1) column), the dtype / device /
shape checks, the output's allocation (``torch.empty`` with dtype and
device, or ``Tensor.new_empty``), the device guard (``torch.cuda.device``,
or only the check that the tensor's card is current), the stream handle
(``torch.cuda.current_stream().cuda_stream``, or the raw handle), the
library and constants lookups, the operands' addresses and strides, the
ctypes call that returns before launching (n = 0: the arguments'
conversion alone) and the one that launches (n = 1: the launch and
``cudaGetLastError``), and the launch counter. Then the whole public
wrappers: K1 ``mul`` and ``add`` at one lane, ``mul`` against a broadcast
column at 2^16 lanes, ``pow`` at one lane (exponent 2), a ``scan`` of three
lanes and, where the package has them, ``dot`` (one row of one lane; five
rows of 2^16 lanes) and ``lincomb`` (nine terms of 2^16 lanes) - as host
microseconds per call and as CUDA-event milliseconds per call back to back
(what chip_smoke.py's kernel records time). Prints the card's name and
power limit and one JSON line. It uses only the package's public
wrappers for the whole calls, so copied into a parent checkout it times
the parent's launch path the same way. Needs one CUDA device.
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

from barretenberg_tpu_torch.fields import fr as get_fr  # noqa: E402
from barretenberg_tpu_torch.fields.params import FQ_PARAMS, FR_PARAMS  # noqa: E402
from barretenberg_tpu_torch.kernels import build, field_kernels  # noqa: E402

L = 18


def host_us(fn, reps: int) -> float:
    """Mean host microseconds per call over `reps` back-to-back calls after
    one warm-up; the device is synchronised before and after, not between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parts(reps: int) -> dict:
    """Each statement of a one-lane K1 mul launch, timed alone."""
    dev = torch.device("cuda", 0)
    a = torch.randint(0, 1 << 13, (L, 1), dtype=torch.int32, device=dev)
    b = torch.randint(0, 1 << 13, (L, 1), dtype=torch.int32, device=dev)
    wide = torch.randint(0, 1 << 13, (L, 1 << 16), dtype=torch.int32, device=dev)
    out = torch.empty((L, 1), dtype=torch.int32, device=dev)
    lib = build.get_lib("field_kernels")
    consts = build.field_consts(FR_PARAMS)
    stream = build.current_stream()

    def checks():
        for t in (a, b):
            if t.dtype != torch.int32 or not t.is_cuda or t.shape[0] != L:
                raise ValueError
        if b.device != a.device:
            raise ValueError

    def guard():
        with torch.cuda.device(a.device):
            pass

    def guard_check():
        return a.get_device() == torch.cuda.current_device()

    def pointers():
        return (a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr())

    args = (a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr())

    def call(n):
        return lambda: lib.bb_field_op(0, *args, n, consts, stream)

    timed = {
        "shape_compare": lambda: a.shape != b.shape,
        "broadcast_2^16_vs_column": lambda: torch.broadcast_tensors(wide, a),
        "checks": checks,
        "torch_empty": lambda: torch.empty((L, 1), dtype=torch.int32, device=a.device),
        "new_empty": lambda: a.new_empty((L, 1)),
        "device_guard": guard,
        "device_current_check": guard_check,
        "current_stream": build.current_stream,
        "lib_and_consts": lambda: (build.get_lib("field_kernels"), build.field_consts(FR_PARAMS)),
        "pointers_strides": pointers,
        "ctypes_call_n0": call(0),
        "ctypes_call_launch_n1": call(1),
        "count": lambda: field_kernels._count("mul", 1),
        "reshape": lambda: out.reshape((L, 1)),
    }
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        timed["raw_stream"] = lambda: torch._C._cuda_getCurrentRawStream(0)
    return {name: host_us(fn, reps) for name, fn in timed.items()}


def wrappers(reps: int) -> dict:
    """The whole public wrappers, host us and event ms per call."""
    dev = torch.device("cuda", 0)
    fr = get_fr(dev)
    a = torch.randint(0, 1 << 13, (L, 1), dtype=torch.int32, device=dev)
    b = torch.randint(0, 1 << 13, (L, 1), dtype=torch.int32, device=dev)
    n = 1 << 16
    rows = [torch.randint(0, 1 << 13, (L, n), dtype=torch.int32, device=dev) for _ in range(9)]
    three = torch.randint(0, 1 << 13, (L, 3), dtype=torch.int32, device=dev)
    calls = {
        "mul_1": lambda: field_kernels.mont_mul(FR_PARAMS, a, b),
        "add_1": lambda: field_kernels.add(FR_PARAMS, a, b),
        "mul_2^16_by_column": lambda: field_kernels.mont_mul(FR_PARAMS, rows[0], a),
        "pow_1": lambda: field_kernels.pow_static(FQ_PARAMS, a, 2),
        "scan_3": lambda: fr.prefix_product(three, 1),
    }
    if hasattr(field_kernels, "dot"):
        calls["dot_1x1"] = lambda: field_kernels.dot(FR_PARAMS, [a], b)
        calls["dot_5x2^16"] = lambda: field_kernels.dot(FR_PARAMS, rows[:5], rows[5])
        calls["lincomb_9x2^16"] = lambda: field_kernels.linear_combination(FR_PARAMS, rows, list(range(3, 12)))
    return {name: {"host_us": host_us(fn, reps), "event_ms": event_ms(fn, min(reps, 200))}
            for name, fn in calls.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__, "reps": args.reps,
                      "parts_us": parts(args.reps), "wrappers": wrappers(args.reps)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
