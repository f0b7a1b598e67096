from .naive import MSM_PIPPENGER_THRESHOLD, batched_msm, msm, naive_msm
from .pippenger import (
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
from .wnaf import signed_digits, split_scalars

__all__ = [
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
    "split_scalars",
]
