from .preprocess import preprocess  # noqa: F401
from .proof import Proof  # noqa: F401
from .prover import Prover  # noqa: F401
from .verifier import Verifier  # noqa: F401
