"""Native (C) runtime components, loaded via ctypes.

The compute path is PyTorch + CUDA kernels; the host-sequential Fiat-Shamir
Keccak sponge is C, compiled on first use into the package's git-ignored
build directory (the same one the CUDA kernels are built into). If no C
compiler is available the caller keeps its pure-Python implementation,
which computes the same digests.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from ..config import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "keccak.c")
_SO = os.path.join(BUILD_DIR, "libkeccak.so")

_lib = None


def _build() -> bool:
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        return False
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_SO}.tmp{os.getpid()}"
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)
        return True
    except (subprocess.CalledProcessError, OSError):
        return False


def get_keccak():
    """Returns a callable keccak256(data: bytes) -> bytes backed by the C
    library, or None if it cannot be built or loaded."""
    global _lib
    if _lib is None:
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.keccak256.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
        lib.keccak256.restype = None
        _lib = lib

    def keccak256_native(data: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        _lib.keccak256(data, len(data), out)
        return out.raw

    return keccak256_native
