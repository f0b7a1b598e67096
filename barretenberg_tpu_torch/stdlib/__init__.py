"""In-circuit standard library (reference: waffle/stdlib/).

Host-side gadget layer: symbolic wires over a composer context. Circuit
construction is sequential bookkeeping, so this layer is pure Python; the
resulting constraint system is proven on device by the PLONK prover.
"""

from .types import witness_t, field_t, bool_t
from .uint32 import Uint32
from .bitarray import BitArray
from .sha256 import sha256
from .mimc import mimc7, mimc_block_cipher

__all__ = [
    "witness_t",
    "field_t",
    "bool_t",
    "Uint32",
    "BitArray",
    "sha256",
    "mimc7",
    "mimc_block_cipher",
]
