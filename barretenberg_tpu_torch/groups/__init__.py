from .group import AffinePoints, Curve, JacobianPoints  # noqa: F401
from .g1 import g1  # noqa: F401
