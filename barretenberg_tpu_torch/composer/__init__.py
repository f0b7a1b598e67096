from .base import AddTriple, ComposerBase, MulTriple, PolyTriple  # noqa: F401
from .standard import StandardComposer  # noqa: F401
from .bool import BoolComposer  # noqa: F401
from .extended import ExtendedComposer  # noqa: F401
from .mimc import MiMCComposer, MiMCQuadruplet  # noqa: F401
