from .naive import MSM_PIPPENGER_THRESHOLD, batched_msm, msm, naive_msm
from .pippenger import optimal_window, pippenger, scalar_digits
from .wnaf import signed_digits, split_scalars

__all__ = [
    "MSM_PIPPENGER_THRESHOLD",
    "batched_msm",
    "msm",
    "naive_msm",
    "optimal_window",
    "pippenger",
    "scalar_digits",
    "signed_digits",
    "split_scalars",
]
