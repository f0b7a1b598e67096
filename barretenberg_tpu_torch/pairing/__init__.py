from .host import (  # noqa: F401
    pairing_check,
    reduced_ate_pairing,
    reduced_ate_pairing_batch,
)
