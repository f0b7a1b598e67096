"""MiMCComposer: native MiMC round gates chained through w_o(X.omega).

Reference: waffle/composer/mimc_composer.cpp. A mimc gate at row i holds
w_o = x_in, w_l = k (round key), w_r = x_cubed, with constraints
  (x_in + k + q_mimc_c)^3 == x_cubed
  (x_in + k + q_mimc_c) * x_cubed^2 == x_out = w_o(next row)
so consecutive rounds chain through the shifted output wire; a noop gate is
inserted whenever the chain breaks (mimc_composer.cpp:61-121).
"""

from __future__ import annotations

import dataclasses

from ..fields.params import FR_MODULUS
from ..plonk.prover import Prover
from ..plonk.widgets import ProverArithmeticWidget, ProverMiMCWidget
from .base import ComposerBase
from .standard import StandardComposer

P = FR_MODULUS
_NONE = -1


@dataclasses.dataclass
class MiMCQuadruplet:
    x_in_idx: int
    k_idx: int
    x_cubed_idx: int
    x_out_idx: int
    mimc_constant: int


class MiMCComposer(StandardComposer):
    def __init__(self):
        super().__init__()
        self.q_mimc_coefficient: list[int] = []
        self.q_mimc_selector: list[int] = []
        self.current_output_wire = _NONE
        # mimc_composer.hpp:24 pins zero_idx at construction
        self.zero_idx = self.add_variable(0)

    # -- standard gates flush the pending chained output first ------------
    def _flush(self) -> None:
        if self.current_output_wire != _NONE:
            self.create_noop_gate()

    def create_add_gate(self, t) -> None:
        self._flush()
        super().create_add_gate(t)
        self.q_mimc_coefficient.append(0)
        self.q_mimc_selector.append(0)

    def create_mul_gate(self, t) -> None:
        self._flush()
        super().create_mul_gate(t)
        self.q_mimc_coefficient.append(0)
        self.q_mimc_selector.append(0)

    def create_bool_gate(self, variable_index: int) -> None:
        self._flush()
        super().create_bool_gate(variable_index)
        self.q_mimc_coefficient.append(0)
        self.q_mimc_selector.append(0)

    def create_poly_gate(self, t) -> None:
        self._flush()
        super().create_poly_gate(t)
        self.q_mimc_coefficient.append(0)
        self.q_mimc_selector.append(0)

    def create_mimc_gate(self, q: MiMCQuadruplet) -> None:
        """(mimc_composer.cpp:61-87)."""
        if self.current_output_wire != _NONE and q.x_in_idx != self.current_output_wire:
            self.create_noop_gate()
        self.q_m.append(0)
        self.q_l.append(0)
        self.q_r.append(0)
        self.q_o.append(0)
        self.q_c.append(0)
        self.q_mimc_coefficient.append(q.mimc_constant % P)
        self.q_mimc_selector.append(1)
        self._record_wires(q.k_idx, q.x_cubed_idx, q.x_in_idx)
        self.current_output_wire = q.x_out_idx

    def create_noop_gate(self) -> None:
        """All-zero gate that lands the pending chained output on w_o
        (mimc_composer.cpp:89-121)."""
        self.q_m.append(0)
        self.q_l.append(0)
        self.q_r.append(0)
        self.q_o.append(0)
        self.q_c.append(0)
        self.q_mimc_coefficient.append(0)
        self.q_mimc_selector.append(0)
        out = (
            self.current_output_wire
            if self.current_output_wire != _NONE
            else self.zero_idx
        )
        self._record_wires(self.zero_idx, self.zero_idx, out)
        self.current_output_wire = _NONE

    def create_dummy_gates(self) -> None:
        """(mimc_composer.cpp:124-170): standard dummies + one gate with
        q_mimc_selector = 1 and one with q_mimc_coefficient = 1 so neither
        polynomial is identically zero. Both are satisfied with zero wires:
        (0+0+0)^3 - 0 + alpha.((0+0+0).0 - 0) == 0."""
        self._flush()
        super().create_dummy_gates()
        self.q_mimc_coefficient += [0, 0]
        self.q_mimc_selector += [0, 0]

        self.q_m.append(0)
        self.q_l.append(0)
        self.q_r.append(0)
        self.q_o.append(0)
        self.q_c.append(0)
        self.q_mimc_coefficient.append(0)
        self.q_mimc_selector.append(1)
        self._record_wires(self.zero_idx, self.zero_idx, self.zero_idx)

        self.q_m.append(0)
        self.q_l.append(0)
        self.q_r.append(0)
        self.q_o.append(0)
        self.q_c.append(0)
        self.q_mimc_coefficient.append(1)
        self.q_mimc_selector.append(0)
        self._record_wires(self.zero_idx, self.zero_idx, self.zero_idx)

    def get_num_constant_gates(self) -> int:
        return 4

    def check_circuit(self) -> bool:
        self._flush()  # land any pending chained output first
        if not super().check_circuit():
            return False
        for i in range(self.n):
            if self.q_mimc_selector[i] == 0:
                continue
            if i + 1 >= self.n:
                return False
            x_in = self.variables[self.w_o[i]]
            k = self.variables[self.w_l[i]]
            cubed = self.variables[self.w_r[i]]
            x_out = self.variables[self.w_o[i + 1]]
            t = (x_in + k + self.q_mimc_coefficient[i]) % P
            if pow(t, 3, P) != cubed or t * cubed % P * cubed % P != x_out:
                return False
        return True

    def preprocess(self, reference_string=None, device=None) -> Prover:
        """(mimc_composer.cpp:173-253)."""
        # land a trailing chained output (preprocess-time flush)
        if self.current_output_wire != _NONE:
            self.create_noop_gate()
        # NOTE: the final mimc gate's x_out constraint references w_o of the
        # row after it; the flush above guarantees that row exists.
        user_n = self.n
        prover = StandardComposer.preprocess(self, reference_string, device)
        pad = prover.n - user_n
        q_coef = self.q_mimc_coefficient + [0] * pad
        q_sel = self.q_mimc_selector + [0] * pad
        prover.widgets.append(
            ProverMiMCWidget(prover.fr.encode(q_sel), prover.fr.encode(q_coef))
        )
        return prover
