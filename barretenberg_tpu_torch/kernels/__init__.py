"""Hand-written CUDA kernels (sources in ../csrc) with their plain PyTorch
versions and launch counters: field_kernels (K1), butterfly (K2, and K2b
fft_pass), point_kernels (K3, the lane-wise group law) and msm_kernels (K3a
bucket_accumulate and K3b bucket_reduce, Pippenger's bucket phase)."""
