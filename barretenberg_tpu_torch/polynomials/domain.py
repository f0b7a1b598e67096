"""Evaluation domains over Fr with device twiddle tables.

Mirrors the reference's evaluation_domain, with the precomputed root tables
as tensors on the domain's device: one power table of the domain root
(k < n/2) serves every FFT stage as a strided slice. Tables are built
lazily by one prefix-product scan each (``Field.prefix_product``) and
cached on the instance.
"""

from __future__ import annotations

import functools

import torch

from ..config import resolve_device
from ..fields import fr as _fr
from ..kernels.butterfly import bit_reverse_indices


class EvaluationDomain:
    def __init__(self, size: int, device=None):
        assert size & (size - 1) == 0, "domain size must be a power of two"
        self.size = size
        self.device = resolve_device(device)
        self.log2_size = size.bit_length() - 1
        self.fr = _fr(self.device)
        p = self.fr.p
        self.root = self.fr.get_root_of_unity(self.log2_size)  # host int value
        self.root_inverse = pow(self.root, -1, p)
        self.domain_inverse = pow(size, -1, p)
        self.generator = self.fr.params.multiplicative_generator  # 5
        self.generator_inverse = pow(self.generator, -1, p)

    # ------------------------------------------------------------------
    # Device tables (built lazily, cached)
    # ------------------------------------------------------------------
    def _power_table(self, base_value: int, n: int) -> torch.Tensor:
        """(18, n) internal-Montgomery table of base^k for k < n, as one
        log-depth prefix-product scan."""
        fr = self.fr
        if n == 1:
            return fr.encode([1])
        xs = torch.cat(
            [fr.encode([1]), fr.encode([base_value]).expand(18, n - 1)], dim=1
        )
        return fr.prefix_product(xs, dim=1)

    @functools.cached_property
    def twiddles(self) -> torch.Tensor:
        """omega^k for k < n/2 (covers all forward FFT stages)."""
        return self._power_table(self.root, max(1, self.size // 2))

    @functools.cached_property
    def inverse_twiddles(self) -> torch.Tensor:
        return self._power_table(self.root_inverse, max(1, self.size // 2))

    @functools.cached_property
    def coset_scale(self) -> torch.Tensor:
        """g^j for j < n (coset_fft input scaling)."""
        return self._power_table(self.generator, self.size)

    @functools.cached_property
    def coset_scale_inverse(self) -> torch.Tensor:
        return self._power_table(self.generator_inverse, self.size)

    @property
    def bit_reverse_indices(self) -> torch.Tensor:
        return bit_reverse_indices(self.log2_size, self.device)

    @functools.cached_property
    def _root_vector(self) -> torch.Tensor:
        return self._power_table(self.root, self.size)

    def root_vector(self) -> torch.Tensor:
        """(18, n) table of omega^k for k < n."""
        return self._root_vector

    @functools.cached_property
    def _coset_root_vector(self) -> torch.Tensor:
        return self.fr.mul_by_constant(self.root_vector(), self.generator)

    def coset_root_vector(self) -> torch.Tensor:
        """(18, n) table of g * omega^k (the coset evaluation points)."""
        return self._coset_root_vector


@functools.lru_cache(maxsize=None)
def _get_domain(size: int, device: torch.device) -> EvaluationDomain:
    return EvaluationDomain(size, device)


def get_domain(size: int, device=None) -> EvaluationDomain:
    """The one cached domain of this size on `device` (default: CUDA)."""
    return _get_domain(size, resolve_device(device))
