from . import challenges, keccak  # noqa: F401
