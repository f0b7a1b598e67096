from .domain import EvaluationDomain, get_domain  # noqa: F401
from . import arithmetic, fft  # noqa: F401
