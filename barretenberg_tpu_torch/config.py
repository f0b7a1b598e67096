"""Runtime configuration: device choice.

Every entry point of the package takes ``device=`` and resolves it here.
The default is the CUDA card; tests pass ``device="cpu"``. There is no
switch between kernel and plain paths: a CUDA tensor always goes to the
hand-written kernels (kernels/), a CPU tensor always to their plain PyTorch
versions.
"""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda"

# Everything the package builds at run time (CUDA kernels, the C keccak
# sponge) lands here; the directory is git-ignored.
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def resolve_device(device=None) -> torch.device:
    """Normalise a device argument to an indexed ``torch.device``.

    ``None`` means the default (CUDA). Asking for CUDA on a machine without
    a card raises: nothing silently moves to the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
