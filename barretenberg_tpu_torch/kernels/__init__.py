"""Hand-written CUDA kernels (sources in ../csrc) with their plain PyTorch
versions and launch counters: field_kernels (K1), butterfly (K2),
point_kernels (K3)."""
