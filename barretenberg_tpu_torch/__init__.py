"""barretenberg_tpu_torch: the PyTorch/CUDA port of barretenberg_tpu.

BN254 field and curve arithmetic, radix-2 FFTs over Fr, Pippenger MSM and
the PLONK prover/verifier on torch tensors, with the three hot limb kernels
written by hand in CUDA C++ for Hopper (csrc/, built at first use). The
sub-package layout mirrors barretenberg_tpu so every module's counterpart is
found by path. Entry points take ``device=`` and default to the CUDA card;
CPU tensors run the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
