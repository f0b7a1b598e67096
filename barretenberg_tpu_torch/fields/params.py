"""BN254 field parameters.

Mirrors the parameter classes of the reference library
(reference: src/barretenberg/curves/bn254/fq.hpp, fr.hpp), but derives the
Montgomery constants from the moduli with Python integer arithmetic instead of
transcribing them, so there is a single source of truth (the modulus itself).

Two Montgomery radices are in play:

* ``R = 2**256``  -- the *external* radix. This is the representation the
  reference library uses for every stored field element (4x64-bit limbs).
  All serialized data (proofs, SRS files, Fiat-Shamir transcripts, KATs)
  is in this form.
* ``R' = 2**270`` -- the *internal* radix used by the limb kernels
  (18 limbs x 15 bits, see fields/montgomery.py). Mapping between the two is
  a single Montgomery multiplication; the map ``u -> u * 2**14 mod p``
  turns external-radix Montgomery products into internal-radix ones
  homomorphically.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Limb geometry of the device representation.
# ---------------------------------------------------------------------------
LIMB_BITS = 15
NUM_LIMBS = 18  # 18 * 15 = 270 >= 256
LIMB_MASK = (1 << LIMB_BITS) - 1
INTERNAL_BITS = LIMB_BITS * NUM_LIMBS  # 270
R_EXTERNAL = 1 << 256
R_INTERNAL = 1 << INTERNAL_BITS


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """All per-field constants, as Python ints (values, not representations)."""

    name: str
    modulus: int
    # Generator of the multiplicative group (a value, e.g. 5 for Fr).
    multiplicative_generator: int
    # 2-adicity of p-1 and a primitive 2^s-th root of unity (value).
    primitive_root_log_size: int
    primitive_root: int  # value of the 2^s-th root of unity (0 if none)
    # Cube root of unity (value) used by the GLV endomorphism ("beta"/"lambda").
    cube_root: int
    # Second coset generator for the PLONK permutation argument (value).
    alternate_multiplicative_generator: int = 0

    # ---- derived quantities -------------------------------------------------
    @property
    def r_ext(self) -> int:
        return R_EXTERNAL % self.modulus

    @property
    def r_int(self) -> int:
        return R_INTERNAL % self.modulus

    @property
    def r_ext_inv(self) -> int:
        return pow(R_EXTERNAL, -1, self.modulus)

    @property
    def r_int_inv(self) -> int:
        return pow(R_INTERNAL, -1, self.modulus)

    @property
    def nprime_int(self) -> int:
        """-p^-1 mod R_INTERNAL (for one-shot Montgomery reduction)."""
        return (-pow(self.modulus, -1, R_INTERNAL)) % R_INTERNAL

    @property
    def to_internal_factor(self) -> int:
        """c with mont_mul_int(x, c) == x * 2**14 mod p (ext-mont -> int-mont)."""
        return (R_INTERNAL * R_INTERNAL // R_EXTERNAL) % self.modulus

    @property
    def from_internal_factor(self) -> int:
        """c with mont_mul_int(x, c) == x * 2**-14 mod p (int-mont -> ext-mont)."""
        return R_EXTERNAL % self.modulus


# ---------------------------------------------------------------------------
# BN254 base field Fq (reference: curves/bn254/fq.hpp:12-15).
# ---------------------------------------------------------------------------
FQ_MODULUS = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47

# Cube root of unity mod q in *external Montgomery form* per fq.hpp:53-56 is
# 0x2c3b3f0d26594943aa303344d4741444a6bb947cffbe332371930c11d782e155; here we
# store the value.
_FQ_CUBE_ROOT_MONT = 0x2C3B3F0D26594943AA303344D4741444A6BB947CFFBE332371930C11D782E155
FQ_CUBE_ROOT = (_FQ_CUBE_ROOT_MONT * pow(R_EXTERNAL, -1, FQ_MODULUS)) % FQ_MODULUS

FQ_PARAMS = FieldParams(
    name="fq",
    modulus=FQ_MODULUS,
    multiplicative_generator=0,  # unused for Fq in the reference (fq.hpp:70)
    primitive_root_log_size=0,
    primitive_root=0,
    cube_root=FQ_CUBE_ROOT,
)

# ---------------------------------------------------------------------------
# BN254 scalar field Fr (reference: curves/bn254/fr.hpp:12-15).
# ---------------------------------------------------------------------------
FR_MODULUS = 0x30644E72E131A029B85045B68181585D2833E84879B97091_43E1F593F0000001

_FR_CUBE_ROOT_MONT = 0x1CBD5653A5661C258BE4BA08B19A750A7D4FDCA77A96C16793E7CEDE4A0329B3
FR_CUBE_ROOT = (_FR_CUBE_ROOT_MONT * pow(R_EXTERNAL, -1, FR_MODULUS)) % FR_MODULUS

_FR_PRIMITIVE_ROOT_MONT = (
    0x1860EF942963F9E756452AC01EB203D8A22BF3742445FFD6636E735580D13D9C
)
FR_PRIMITIVE_ROOT = (_FR_PRIMITIVE_ROOT_MONT * pow(R_EXTERNAL, -1, FR_MODULUS)) % FR_MODULUS

# k1 coset generator is 5 (fr.hpp:66 comment); k2 ("alternate") per fr.hpp:76-79.
_FR_ALT_GEN_MONT = 0x0180A96573D3D9F85C65EC9F484E3A89307F6D866832BB013057819E4FFFFFDB
FR_ALT_GEN = (_FR_ALT_GEN_MONT * pow(R_EXTERNAL, -1, FR_MODULUS)) % FR_MODULUS

FR_PARAMS = FieldParams(
    name="fr",
    modulus=FR_MODULUS,
    multiplicative_generator=5,
    primitive_root_log_size=28,
    primitive_root=FR_PRIMITIVE_ROOT,
    cube_root=FR_CUBE_ROOT,
    alternate_multiplicative_generator=FR_ALT_GEN,
)

# ---------------------------------------------------------------------------
# GLV decomposition constants (reference: fields/field.hpp:413-485).
# These are raw 256-bit integers used by split_into_endomorphism_scalars; they
# are algorithm constants specific to BN254's lambda endomorphism.
# ---------------------------------------------------------------------------
# g1 = {0x7a7bd9d4391eb18d, 0x4ccef014a773d2cf, 0x2, 0}
GLV_G1 = (0x2 << 128) | (0x4CCEF014A773D2CF << 64) | 0x7A7BD9D4391EB18D
# g2 = {0xd91d232ec7e0b3d7, 0x2, 0, 0}
GLV_G2 = (0x2 << 64) | 0xD91D232EC7E0B3D7
# minus_b1 = {0x8211bbeb7d4f1128, 0x6f4d8248eeb859fc, 0, 0}
GLV_MINUS_B1 = (0x6F4D8248EEB859FC << 64) | 0x8211BBEB7D4F1128
# b2 = {0x89d3256894d213e3, 0, 0, 0}
GLV_B2 = 0x89D3256894D213E3
