"""BoolComposer: tracks booleanity per variable and emits bool selectors.

Reference: waffle/composer/bool_composer.cpp. `create_bool_gate` does not
append a gate - it marks the variable as boolean, and preprocess() derives
the q_bl/q_br/q_bo selector columns from which wires carry boolean variables
(process_bool_gates, bool_composer.cpp:67-78), so booleanity rides existing
gates for free.
"""

from __future__ import annotations

from ..fields.params import FR_MODULUS
from ..plonk.prover import Prover
from ..plonk.widgets import ProverArithmeticWidget, ProverBoolWidget
from .standard import StandardComposer

P = FR_MODULUS


class BoolComposer(StandardComposer):
    def __init__(self):
        super().__init__()
        self.is_bool: list[bool] = []

    def add_variable(self, value: int) -> int:
        idx = super().add_variable(value)
        self.is_bool.append(False)
        return idx

    def create_bool_gate(self, variable_index: int) -> None:
        """(bool_composer.cpp:24-30): just mark the variable."""
        self.is_bool[variable_index] = True

    def create_dummy_gates(self) -> None:
        """Adds the standard dummies plus one all-zero gate whose left/right
        bool selectors are forced on, keeping q_bl/q_br nonzero
        (bool_composer.cpp:37-65)."""
        super().create_dummy_gates()
        zero = self.add_variable(0)
        self._forced_bool_gate = self.n
        self.q_m.append(0)
        self.q_l.append(0)
        self.q_r.append(0)
        self.q_o.append(0)
        self.q_c.append(0)
        self._record_wires(zero, zero, zero)

    def get_num_constant_gates(self) -> int:
        return 3

    def check_circuit(self) -> bool:
        if not super().check_circuit():
            return False
        return all(
            self.variables[i] in (0, 1)
            for i, marked in enumerate(self.is_bool)
            if marked
        )

    def preprocess(self, reference_string=None, device=None) -> Prover:
        if not hasattr(self, "_forced_bool_gate"):
            self.create_dummy_gates()
        # derive bool selector columns before padding
        user_n = self.n
        q_bl = [1 if self.is_bool[self.w_l[i]] else 0 for i in range(user_n)]
        q_br = [1 if self.is_bool[self.w_r[i]] else 0 for i in range(user_n)]
        q_bo = [1 if self.is_bool[self.w_o[i]] else 0 for i in range(user_n)]
        g = self._forced_bool_gate
        q_bl[g] = q_br[g] = q_bo[g] = 1

        prover = super().preprocess(reference_string, device)
        pad = prover.n - user_n
        q_bl += [0] * pad
        q_br += [0] * pad
        q_bo += [0] * pad
        prover.widgets.append(
            ProverBoolWidget(*(prover.fr.encode(q) for q in (q_bl, q_br, q_bo)))
        )
        return prover
