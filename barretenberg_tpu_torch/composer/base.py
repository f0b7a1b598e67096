"""Circuit composer base: gate/variable/copy-constraint bookkeeping.

Reference: waffle/composer/composer_base.hpp. Pure host Python - circuit
construction is inherently sequential pointer-chasing; only the final
preprocess() step moves data to device (selector/wire polynomials as (18, n)
limb arrays for the Prover).

Wire values ("variables") are plain field-value ints. A gate references
variables by index; `wire_epicycles` records (gate, column) uses of each
variable so copy constraints become cyclic sigma permutations
(composer_base.hpp:163-196).
"""

from __future__ import annotations

import dataclasses

from ..fields.params import FR_MODULUS

P = FR_MODULUS

# WireType tags in the top 2 bits (composer_base.hpp:72-77)
LEFT = 0
RIGHT = 1 << 30
OUTPUT = 1 << 31

# Gate flags (composer_base.hpp:56-70): slots the merge optimizer must not
# move (multiplicative operands of mul/bool/poly gates)
FIXED_LEFT_WIRE = 0x200
FIXED_RIGHT_WIRE = 0x400
FIXED_OUTPUT_WIRE = 0x800


@dataclasses.dataclass
class AddTriple:
    a: int
    b: int
    c: int
    a_scaling: int
    b_scaling: int
    c_scaling: int
    const_scaling: int


@dataclasses.dataclass
class MulTriple:
    a: int
    b: int
    c: int
    mul_scaling: int
    c_scaling: int
    const_scaling: int


@dataclasses.dataclass
class PolyTriple:
    a: int
    b: int
    c: int
    q_m: int
    q_l: int
    q_r: int
    q_o: int
    q_c: int


class ComposerBase:
    def __init__(self):
        self.n = 0
        self.w_l: list[int] = []
        self.w_r: list[int] = []
        self.w_o: list[int] = []
        self.variables: list[int] = []
        self.wire_epicycles: list[list[tuple[int, int]]] = []  # (gate, tag)
        self.gate_flags: list[int] = []

    def get_num_gates(self) -> int:
        return self.n

    def add_variable(self, value: int) -> int:
        self.variables.append(int(value) % P)
        self.wire_epicycles.append([])
        return len(self.variables) - 1

    def get_variable(self, index: int) -> int:
        return self.variables[index]

    def assert_equal(self, a_idx: int, b_idx: int) -> None:
        """Copy-constraint rewiring (composer_base.hpp:141-161)."""
        assert self.variables[a_idx] == self.variables[b_idx]
        for gate, tag in self.wire_epicycles[b_idx]:
            self.wire_epicycles[a_idx].append((gate, tag))
            if tag == LEFT:
                self.w_l[gate] = a_idx
            elif tag == RIGHT:
                self.w_r[gate] = a_idx
            else:
                self.w_o[gate] = a_idx
        self.wire_epicycles[b_idx] = []

    def _record_wires(self, a: int, b: int, c: int, flags: int = 0) -> None:
        g = self.n
        self.gate_flags.append(flags)
        self.w_l.append(a)
        self.w_r.append(b)
        self.w_o.append(c)
        self.wire_epicycles[a].append((g, LEFT))
        self.wire_epicycles[b].append((g, RIGHT))
        self.wire_epicycles[c].append((g, OUTPUT))
        self.n += 1

    def compute_sigma_mappings(self, padded_n: int):
        """Cyclic permutation over each variable's epicycle list
        (composer_base.hpp:163-196). Returns three uint32 numpy arrays."""
        import numpy as np

        sigma_1 = np.arange(padded_n, dtype=np.uint32)
        sigma_2 = np.arange(padded_n, dtype=np.uint32) + np.uint32(RIGHT)
        sigma_3 = np.arange(padded_n, dtype=np.uint32) + np.uint32(OUTPUT)
        sigmas = {LEFT: sigma_1, RIGHT: sigma_2, OUTPUT: sigma_3}
        for cycles in self.wire_epicycles:
            for j, (gate, tag) in enumerate(cycles):
                nxt_gate, nxt_tag = cycles[(j + 1) % len(cycles)]
                sigmas[tag][gate] = nxt_gate + nxt_tag
        return sigma_1, sigma_2, sigma_3
