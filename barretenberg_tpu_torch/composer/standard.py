"""StandardComposer: the vanilla-PLONK gate frontend.

Reference: waffle/composer/standard_composer.cpp. Gate constructors append
selector rows (host ints); preprocess() pads to a power of two, computes the
sigma permutations, and builds a device Prover with an arithmetic widget.
The Prover goes on the CUDA card unless the caller passes ``device="cpu"``
(or a reference string that lives on the CPU).
"""

from __future__ import annotations

from ..fields.params import FR_MODULUS
from ..plonk.prover import Prover
from ..plonk.widgets import ProverArithmeticWidget
from ..srs import test_srs
from .base import (
    FIXED_LEFT_WIRE,
    FIXED_RIGHT_WIRE,
    AddTriple,
    ComposerBase,
    MulTriple,
    PolyTriple,
)

P = FR_MODULUS


class StandardComposer(ComposerBase):
    def __init__(self):
        super().__init__()
        self.q_m: list[int] = []
        self.q_l: list[int] = []
        self.q_r: list[int] = []
        self.q_o: list[int] = []
        self.q_c: list[int] = []
        self.zero_idx = None

    # ------------------------------------------------------------------
    def create_add_gate(self, t: AddTriple) -> None:
        self.q_m.append(0)
        self.q_l.append(t.a_scaling % P)
        self.q_r.append(t.b_scaling % P)
        self.q_o.append(t.c_scaling % P)
        self.q_c.append(t.const_scaling % P)
        self._record_wires(t.a, t.b, t.c)

    def create_mul_gate(self, t: MulTriple) -> None:
        self.q_m.append(t.mul_scaling % P)
        self.q_l.append(0)
        self.q_r.append(0)
        self.q_o.append(t.c_scaling % P)
        self.q_c.append(t.const_scaling % P)
        self._record_wires(t.a, t.b, t.c, flags=FIXED_LEFT_WIRE | FIXED_RIGHT_WIRE)

    def create_bool_gate(self, variable_index: int) -> None:
        """w^2 - w = 0 as a mul gate (standard_composer.cpp:63-86)."""
        self.q_m.append(1)
        self.q_l.append(0)
        self.q_r.append(0)
        self.q_o.append(P - 1)
        self.q_c.append(0)
        self._record_wires(
            variable_index,
            variable_index,
            variable_index,
            flags=FIXED_LEFT_WIRE | FIXED_RIGHT_WIRE,
        )

    def create_poly_gate(self, t: PolyTriple) -> None:
        self.q_m.append(t.q_m % P)
        self.q_l.append(t.q_l % P)
        self.q_r.append(t.q_r % P)
        self.q_o.append(t.q_o % P)
        self.q_c.append(t.q_c % P)
        self._record_wires(t.a, t.b, t.c, flags=FIXED_LEFT_WIRE | FIXED_RIGHT_WIRE)

    def create_dummy_gates(self) -> None:
        """Two fixed gates keeping the selector/permutation polynomials
        nonzero and non-identity (standard_composer.cpp:114-165)."""
        self.q_m.append(1)
        self.q_l.append(2)
        self.q_r.append(3)
        self.q_o.append(4)
        self.q_c.append(5)
        a = self.add_variable(6)
        b = self.add_variable(7)
        c = self.add_variable(P - 20)
        self._record_wires(a, b, c)

        self.q_m.append(1)
        self.q_l.append(1)
        self.q_r.append(1)
        self.q_o.append(1)
        self.q_c.append(127)
        self._record_wires(c, a, b)

    def get_num_constant_gates(self) -> int:
        return 2

    def check_circuit(self) -> bool:
        """Host-side satisfiability check of every arithmetic gate - the
        cheap gadget-debugging oracle (no proving)."""
        for i in range(self.n):
            wl = self.variables[self.w_l[i]]
            wr = self.variables[self.w_r[i]]
            wo = self.variables[self.w_o[i]]
            if (
                self.q_m[i] * wl % P * wr
                + self.q_l[i] * wl
                + self.q_r[i] * wr
                + self.q_o[i] * wo
                + self.q_c[i]
            ) % P != 0:
                return False
        return True

    # ------------------------------------------------------------------
    def preprocess(self, reference_string=None, device=None) -> Prover:
        """(standard_composer.cpp:167-220). Pads n -> 2^k (with one extra
        zero gate), builds sigma mappings and the device Prover: on
        `device` (default the CUDA card), or on the reference string's
        device when one is given and `device` is not."""
        n = self.n
        new_n = 1
        while new_n < n + 1:
            new_n <<= 1
        self.zero_idx = self.add_variable(0)
        for _ in range(n, new_n):
            # padding gates carry no epicycles: their sigma mapping stays the
            # identity (standard_composer.cpp:184-194 appends wires only)
            self.q_m.append(0)
            self.q_l.append(0)
            self.q_r.append(0)
            self.q_o.append(0)
            self.q_c.append(0)
            self.gate_flags.append(0)
            self.w_l.append(self.zero_idx)
            self.w_r.append(self.zero_idx)
            self.w_o.append(self.zero_idx)
            self.n += 1

        if reference_string is None:
            reference_string = test_srs(new_n, device=device)
        prover = Prover(new_n, reference_string, device=device)
        fr = prover.fr
        s1, s2, s3 = self.compute_sigma_mappings(new_n)
        prover.sigma_1_mapping = s1
        prover.sigma_2_mapping = s2
        prover.sigma_3_mapping = s3

        prover.w_l = fr.encode([self.variables[i] for i in self.w_l])
        prover.w_r = fr.encode([self.variables[i] for i in self.w_r])
        prover.w_o = fr.encode([self.variables[i] for i in self.w_o])

        widget = ProverArithmeticWidget(
            fr.encode(self.q_m),
            fr.encode(self.q_l),
            fr.encode(self.q_r),
            fr.encode(self.q_o),
            fr.encode(self.q_c),
        )
        prover.widgets.append(widget)
        return prover
