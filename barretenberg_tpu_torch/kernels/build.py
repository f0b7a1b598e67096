"""Builds and loads the CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by its own ``nvcc`` process into its own shared
library with a plain C interface (seconds per file, no PyTorch headers),
all started together, and loaded with ``ctypes``. Libraries land in the
package's git-ignored ``_build/`` directory and are reused while each is
newer than its source and every header that source includes. A failed
build or load raises: there is no path
that carries on without the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from ..config import BUILD_DIR
from ..fields.params import FQ_PARAMS, FR_PARAMS, GLV_B2, GLV_G1, GLV_G2, GLV_MINUS_B1, R_INTERNAL, FieldParams

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = ("field_kernels", "butterfly", "point_kernels", "point_chains", "msm_kernels", "pairing")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict = {}
_lock = threading.Lock()
# Seconds the last build took (0.0 when the libraries were already built)
# and what ptxas reported per source (registers, spills).
build_seconds: float | None = None
build_log: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _deps(name: str) -> list[str]:
    """The source and every header of csrc/ it includes, directly or not."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        with open(os.path.join(CSRC_DIR, f)) as fh:
            todo.extend(_INCLUDE.findall(fh.read()))
    return [os.path.join(CSRC_DIR, f) for f in seen]


def _stale(name: str) -> bool:
    so = _so_path(name)
    if not os.path.exists(so):
        return True
    return any(os.path.getmtime(d) > os.path.getmtime(so) for d in _deps(name))


def build_all(force: bool = False) -> float:
    """Compile every stale source, one nvcc each, in parallel. Returns the
    wall seconds spent (0.0 if nothing had to be built)."""
    global build_seconds
    with _lock:
        todo = [s for s in SOURCES if force or _stale(s)]
        if not todo:
            if build_seconds is None:
                build_seconds = 0.0
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for name in todo:
            tmp = _so_path(name) + f".tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
            procs.append(
                (name, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            )
        failed = []
        for name, tmp, proc in procs:
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{out}")
            else:
                os.replace(tmp, _so_path(name))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        build_seconds = time.perf_counter() - t0
        return build_seconds


_VP, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_SIGNATURES = {
    "field_kernels": {
        "bb_field_op": [_I, _VP, _L, _L, _VP, _L, _L, _VP, _L, _VP, _VP],
        "bb_field_pow": [_VP, _L, _L, _VP, _L, _VP, _I, _VP, _VP],
        "bb_field_scan": [_I, _I, _VP, _L, _L, _L, _VP, _L, _L, _L, _VP, _I, _L, _I, _I, _L, _VP, _L, _VP, _L, _VP, _VP],
        "bb_field_dot": [_I, _VP, _VP, _L, _L, _VP, _L, _L, _L, _I, _VP, _L, _VP, _VP],
        "bb_field_dot_ctas": [_VP],
        "bb_field_lincomb": [_I, _VP, ctypes.c_char_p, _VP, _L, _VP, _VP],
    },
    "butterfly": {
        "bb_butterfly_stage": [_VP, _VP, _L, _L, _VP, _L, _L, _L, _VP, _VP],
        "bb_fft_pass": [_VP, _VP, _L, _I, _VP, _L, _L, _I, _I, _I, _I, _VP, _L, _L, _VP, _I, _VP, _VP],
    },
    "point_kernels": {
        "bb_point_dbl": [_VP] * 6 + [_L, _VP, _VP],
        "bb_point_add": [_I] + [_VP] * 12 + [_L, _VP, _VP],
    },
    "point_chains": {
        "bb_scalar_mul_bits": [_VP, _VP, _VP, _L, _VP, _I] + [_VP] * 4 + [_L, _VP, _VP],
        "bb_fixed_base": [_VP, _VP, _I, _I] + [_VP] * 4 + [_L, _VP, _VP],
        "bb_table_rows": [_VP, _VP, _VP, _L, _I, _I] + [_VP] * 4 + [_VP, _VP],
        "bb_windowed_walk": [_I, _VP, _VP, _VP, _L, _VP, _I, _I] + [_VP] * 5 + [_VP, _VP, _VP, _VP],
    },
    "msm_kernels": {
        "bb_bucket_accumulate": [_VP] * 9 + [_I] * 5 + [_VP, _VP],
        "bb_accumulate_capacity": [_VP],
        "bb_bucket_reduce": [_VP] * 11 + [_I] * 3 + [_VP, _VP],
        "bb_bucket_reduce_wide": [_VP] * 12 + [_I] * 5 + [_VP, _VP],
        "bb_wide_max_clusters": [_I, _VP],
        "bb_window_combine": [_VP] * 8 + [_I, _I, _I, _VP, _VP],
        "bb_glv_digits": [_VP, _VP, _I, _I, _I, _L, _I, _VP, _VP, _VP],
    },
    "pairing": {
        "bb_miller_loop": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _L, _I, _VP, _VP, _VP, _VP, _VP],
        "bb_final_exp": [_VP, _VP, _VP, _L, _I, _VP, _VP, _VP],
    },
}


def _bind(lib, signatures: dict):
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def get_lib(name: str):
    """The loaded library for one source, building all sources first if any
    is stale."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name] = _bind(ctypes.CDLL(_so_path(name)), _SIGNATURES[name])
    return lib


def load_variant(name: str, defines: tuple, extra: dict):
    """One source built anew with extra ``-D`` defines (a debug build, such as
    K3b-wide's phase stamps) into a directory of its own and loaded, with the
    library's signatures and the ``extra`` ones. The package's own library is
    untouched."""
    out_dir = os.path.join(BUILD_DIR, "variant_" + "_".join(defines))
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{name}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", so, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu with {defines}:\n{proc.stdout}{proc.stderr}")
    return _bind(ctypes.CDLL(so), {**_SIGNATURES[name], **extra})


_const_cache: dict = {}


def _limbs30(value: int) -> list:
    return [(value >> (30 * k)) & ((1 << 30) - 1) for k in range(9)]


def _host_words(key: str, words):
    """The host address of the uint32 array of ``words()``, made once per
    key and kept alive (with its address) by the cache."""
    hit = _const_cache.get(key)
    if hit is None:
        arr = np.ascontiguousarray(np.array(words(), dtype=np.uint32))
        hit = _const_cache[key] = (arr, arr.ctypes.data)
    return hit[1]


def field_consts(params: FieldParams):
    """The 19 host words a kernel launch takes: modulus, R' mod p and
    -p^-1 mod 2^30 as 30-bit limbs, derived from the field parameters."""
    p = params.modulus
    return _host_words(params.name,
                       lambda: _limbs30(p) + _limbs30(R_INTERNAL % p) + [(-pow(p, -1, 1 << 30)) % (1 << 30)])


def glv_consts():
    """The 45 host words of K4's GlvConst: GLV_G2 << 14, GLV_G1 << 14,
    GLV_MINUS_B1, GLV_B2 and the Montgomery form of Fr's lambda (cube root),
    as 30-bit limbs (the launch refuses the first four if they are wider
    than the kernel's compile-time widths)."""

    def words():
        lam = FR_PARAMS.cube_root * R_INTERNAL % FR_PARAMS.modulus
        return [w for v in (GLV_G2 << 14, GLV_G1 << 14, GLV_MINUS_B1, GLV_B2, lam) for w in _limbs30(v)]

    return _host_words("glv", words)


def endo_consts():
    """The 9 host words of beta, Fq's cube root of unity, in internal
    Montgomery form as 30-bit limbs: K3g's psi(x, y, z) = (beta x, -y, z)."""
    return _host_words("endo", lambda: _limbs30(FQ_PARAMS.cube_root * R_INTERNAL % FQ_PARAMS.modulus))


def tower_consts():
    """The 174 host words of the pairing kernels' TowerConst
    (csrc/tower.cuh): the Frobenius coefficients C1, C2 and W for k = 1, 2,
    3 as Fq2 values in internal Montgomery form (30-bit limbs), p - 2 as
    eight 32-bit words and its bit length, and the BN parameter z as two
    words and its bit length - all derived from the host tower's
    constants."""

    def words():
        from ..pairing import tower as ht

        p = FQ_PARAMS.modulus
        out = []
        for k in (1, 2, 3):
            for c in (ht._FROB_C1[k], ht._FROB_C2[k], ht._FROB_W[k]):
                out += _limbs30(c[0] * R_INTERNAL % p) + _limbs30(c[1] * R_INTERNAL % p)
        e = p - 2
        out += [(e >> (32 * k)) & 0xFFFFFFFF for k in range(8)] + [e.bit_length()]
        out += [ht.BN_Z & 0xFFFFFFFF, ht.BN_Z >> 32, ht.BN_Z.bit_length()]
        return out

    return _host_words("tower", words)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


_SAME_DEVICE = contextlib.nullcontext()


def on_device(t: torch.Tensor):
    """A context in which `t`'s card is the current device for a launch: no
    switch (and no switch back) when it already is."""
    idx = t.get_device()
    return _SAME_DEVICE if idx == torch.cuda.current_device() else torch.cuda.device(idx)


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on `t`'s card (what
    ``current_stream`` gives when that card is current, without building a
    Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
