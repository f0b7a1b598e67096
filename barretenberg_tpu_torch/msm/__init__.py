from .naive import MSM_PIPPENGER_THRESHOLD, batched_msm, msm, naive_msm
from .pippenger import (
    FUSED_MAX_N,
    PippengerPointTable,
    generate_pippenger_point_table,
    optimal_window,
    pippenger,
    pippenger_batch,
    pippenger_low_memory,
    pippenger_precomputed,
    pippenger_precomputed_batch,
    scalar_digits,
)
from .wnaf import signed_digits, signed_digits_full, split_scalars

__all__ = [
    "FUSED_MAX_N",
    "MSM_PIPPENGER_THRESHOLD",
    "PippengerPointTable",
    "batched_msm",
    "generate_pippenger_point_table",
    "msm",
    "naive_msm",
    "optimal_window",
    "pippenger",
    "pippenger_batch",
    "pippenger_low_memory",
    "pippenger_precomputed",
    "pippenger_precomputed_batch",
    "scalar_digits",
    "signed_digits",
    "signed_digits_full",
    "split_scalars",
]
