"""ExtendedComposer: gate-count optimizer using the 4th virtual wire.

Reference: waffle/composer/extended_composer.cpp:100-463. Adjacent gate
pairs that share an eliminable intermediate wire are merged into one "quad"
row whose constraint also references the NEXT row's output wire through the
sequential widget's q_oo selector (sequential_widget.cpp:47-63):

    q_m.wl.wr + q_l.wl + q_r.wr + q_o.wo + q_oo.wo(next row) + q_c = 0

Full algorithm (both the reference's rewrites):

  1. quad collection (get_shared_wire, extended_composer.cpp:102-156): scan
     adjacent gate pairs for a shared wire that is isolated to the pair,
     not boolean-constrained, and not pinned to a multiplicative slot
     (FIXED_LEFT/RIGHT gate flags); record the pair, the removed wire's two
     selector refs, and the four surviving wires with their selector refs
     and mutability (filter, :19-73).
  2. merge pass in REVERSE gate order (:183-427): for each quad, find a
     "lookahead" wire among its survivors that can occupy (or be swapped
     into) the next row's output slot -> delete the second gate and read
     the lookahead through q_oo. If no lookahead exists but the PREVIOUS
     quad is gate-adjacent, perform the ANCHORING rewrite (:233-265): keep
     the second gate as a selector-free anchor row whose w_o carries one
     survivor, place the wire shared with the previous quad in the merged
     row's output slot, so the previous quad (processed next) can elide
     its own gate against it.
  3. selector combination (:345-380): scale gate1 by the removed wire's
     gate2-selector and gate2 by minus its gate1-selector (zero selectors
     combine as 1), then each surviving wire's new selector is the sum of
     its (scaled, aliased) selector refs.

Deviation from the reference: quads are only collected over user gates
(the reference's loop also pairs its own trailing dummy gates and then
reads one gate past the end of the selector vectors - out-of-bounds in
C++; test_extended_composer never trips it because the OOB read happens
not to match).
"""

from __future__ import annotations

import dataclasses

from ..fields.params import FR_MODULUS
from ..plonk.prover import Prover
from ..plonk.widgets import ProverSequentialWidget
from .base import (
    FIXED_LEFT_WIRE,
    FIXED_OUTPUT_WIRE,
    FIXED_RIGHT_WIRE,
    LEFT,
    OUTPUT,
    RIGHT,
)
from .bool import BoolComposer

P = FR_MODULUS

_SLOT_FLAGS = {
    "l": FIXED_LEFT_WIRE,
    "r": FIXED_RIGHT_WIRE,
    "o": FIXED_OUTPUT_WIRE,
}


@dataclasses.dataclass
class _WireProp:
    """extended_wire_properties (extended_composer.hpp): a surviving wire,
    whether any of its slots is movable, and refs to its selectors (refs,
    not values - combination reads them after the in-place scaling)."""

    mutable: bool
    index: int
    wire_type: str  # 'l' | 'r' | 'o'
    selectors: list[tuple[int, str]]  # (gate, slot) refs into q arrays


@dataclasses.dataclass
class _Quad:
    gates: tuple[int, int]
    removed: _WireProp
    wires: list[_WireProp]


class ExtendedComposer(BoolComposer):
    def __init__(self):
        super().__init__()
        self.q_oo: list[int] = []
        self.merged_count = 0  # quads merged (deleting + anchoring)
        self.deleted_count = 0  # gates actually removed
        self._no_merge_from: int | None = None

    def create_dummy_gates(self) -> None:
        self._no_merge_from = self.n
        super().create_dummy_gates()

    # ------------------------------------------------------------------
    def _q(self, slot: str) -> list[int]:
        return {"l": self.q_l, "r": self.q_r, "o": self.q_o}[slot]

    def _w(self, slot: str) -> list[int]:
        return {"l": self.w_l, "r": self.w_r, "o": self.w_o}[slot]

    def _flag(self, gate: int, slot: str) -> bool:
        return bool(self.gate_flags[gate] & _SLOT_FLAGS[slot])

    def _sel_value(self, refs: list[tuple[int, str]]) -> int:
        return sum(self._q(slot)[g] for g, slot in refs) % P

    def _get_shared_wire(self, i: int) -> _WireProp | None:
        """(extended_composer.cpp:102-156)."""
        if (self._flag(i, "l") and self._flag(i + 1, "l")) or (
            self._flag(i, "r") and self._flag(i + 1, "r")
        ):
            return None
        second = [
            (self._w(s)[i + 1], not self._flag(i + 1, s), s) for s in "lro"
        ]
        for s1 in "lro":
            if self._flag(i, s1):
                continue
            v = self._w(s1)[i]
            found = next(
                (s2 for w2, ok, s2 in second if ok and w2 == v), None
            )
            if found is None or self.is_bool[v]:
                continue
            if not all(g in (i, i + 1) for g, _ in self.wire_epicycles[v]):
                continue  # is_isolated (:75-82)
            return _WireProp(True, v, s1, [(i, s1), (i + 1, found)])
        return None

    def _filter(self, i: int, removed: int, zero_idx: int) -> list[_WireProp]:
        """Surviving wires of the pair, deduped, selectors accumulated
        (extended_composer.cpp:19-73). Padded to 4 with the zero wire."""
        out: list[_WireProp] = []
        for gate, slot in ((i, "l"), (i, "r"), (i, "o"), (i + 1, "l"), (i + 1, "r"), (i + 1, "o")):
            w = self._w(slot)[gate]
            if w == removed:
                continue
            mut = not self._flag(gate, slot)
            hit = next((x for x in out if x.index == w), None)
            if hit is None:
                out.append(_WireProp(mut, w, slot, [(gate, slot)]))
            else:
                hit.mutable = hit.mutable and mut
                hit.selectors.append((gate, slot))
        while len(out) < 4:
            out.append(_WireProp(True, zero_idx, "l", []))
        return out

    # ------------------------------------------------------------------
    def _combine_linear_relations(self, zero_idx: int) -> None:
        n_user = self._no_merge_from if self._no_merge_from is not None else self.n
        self.q_oo = [0] * self.n
        deleted = [False] * self.n

        # ---- pass 1: collect potential quads --------------------------
        quads: list[_Quad] = []
        i = 0
        while i + 1 < n_user:
            m = self._get_shared_wire(i)
            if m is not None:
                quads.append(
                    _Quad((i, i + 1), m, self._filter(i, m.index, zero_idx))
                )
                i += 1  # skip the absorbed gate
            i += 1

        # ---- pass 2: merge, in reverse (anchoring feeds earlier quads) --
        for j in range(len(quads) - 1, -1, -1):
            quad = quads[j]
            g1i, g2i = quad.gates
            next_gate = g2i + 1
            if next_gate >= self.n:
                continue
            lf = self._flag(next_gate, "l")
            rf = self._flag(next_gate, "r")
            of = self._flag(next_gate, "o")

            def links_next(x: _WireProp) -> bool:
                if x.wire_type != "o" and not x.mutable:
                    return False
                if self.w_l[next_gate] == x.index and not lf and not of:
                    return True
                if self.w_r[next_gate] == x.index and not rf and not of:
                    return True
                return self.w_o[next_gate] == x.index

            lookahead = next(
                (x for x in quad.wires if x.index != zero_idx and links_next(x)),
                None,
            )
            deleting = lookahead is not None
            anchoring = False
            anchor = None

            if (
                lookahead is None
                and j > 0
                and quads[j - 1].gates[1] + 1 == quad.gates[0]
            ):
                # anchoring rewrite (:233-265): expose a wire shared with
                # the preceding quad through this quad's output slot
                prev = quads[j - 1]

                def movable(x: _WireProp) -> bool:
                    return x.wire_type == "o" or x.mutable

                anchor = next(
                    (
                        x
                        for x in quad.wires
                        if movable(x)
                        and x.index != zero_idx
                        and any(
                            y.index == x.index and movable(y)
                            for y in prev.wires
                        )
                    ),
                    None,
                )
                if anchor is not None:
                    lookahead = next(
                        (
                            x
                            for x in quad.wires
                            if x.index != anchor.index and movable(x)
                        ),
                        None,
                    )
                    if lookahead is not None:
                        anchoring = True
                    else:
                        anchor = None
            if lookahead is None:
                continue

            # ---- slot assignment (:270-322) ---------------------------
            gate_wires: list[_WireProp | None] = [None, None, None, None]
            gate_wires[3] = lookahead
            if anchoring:
                gate_wires[2] = anchor

            def included(idx: int) -> bool:
                return any(g is not None and g.index == idx for g in gate_wires)

            def place(wire: _WireProp, policy) -> None:
                if included(wire.index):
                    return
                if policy("o", wire) and gate_wires[2] is None:
                    gate_wires[2] = wire
                elif policy("r", wire) and gate_wires[1] is None:
                    gate_wires[1] = wire
                elif policy("l", wire) and gate_wires[0] is None:
                    gate_wires[0] = wire

            for w in quad.wires:  # fixed wires keep their slots first
                place(w, lambda t, x: x.wire_type == t and not x.mutable)
            for w in quad.wires:
                place(w, lambda t, x: x.wire_type == t or x.mutable)
            for k in range(3):  # degenerate quads: pad with the zero wire
                if gate_wires[k] is None:
                    gate_wires[k] = _WireProp(True, zero_idx, "l", [])

            if deleting:
                # swap the lookahead wire into the next row's output slot
                left = self.w_l[next_gate] == lookahead.index and not lf
                right = self.w_r[next_gate] == lookahead.index and not rf
                if (left or right) and not of:
                    slot = "l" if left else "r"
                    wa, qa = self._w(slot), self._q(slot)
                    old_tag = LEFT if left else RIGHT
                    self._change_epicycle(
                        lookahead.index, next_gate, old_tag, OUTPUT
                    )
                    self._change_epicycle(
                        self.w_o[next_gate], next_gate, OUTPUT, old_tag
                    )
                    wa[next_gate], self.w_o[next_gate] = (
                        self.w_o[next_gate],
                        wa[next_gate],
                    )
                    qa[next_gate], self.q_o[next_gate] = (
                        self.q_o[next_gate],
                        qa[next_gate],
                    )
                deleted[g2i] = True

            # ---- selector combination (:345-380) ----------------------
            sel1 = self._q(quad.removed.selectors[0][1])[g1i]
            sel2 = self._q(quad.removed.selectors[1][1])[g2i]
            right_f = sel2 if sel2 != 0 else 1
            left_f = (-(sel1 if sel1 != 0 else 1)) % P
            for arr in (self.q_m, self.q_l, self.q_r, self.q_o, self.q_c):
                arr[g1i] = arr[g1i] * right_f % P
                arr[g2i] = arr[g2i] * left_f % P

            new_sels = [self._sel_value(gw.selectors) for gw in gate_wires]
            self.q_l[g1i] = new_sels[0]
            self.q_r[g1i] = new_sels[1]
            self.q_o[g1i] = new_sels[2]
            self.q_oo[g1i] = new_sels[3]
            self.q_c[g1i] = (self.q_c[g1i] + self.q_c[g2i]) % P
            if self.q_m[g2i] != 0:
                self.q_m[g1i] = (self.q_m[g1i] + self.q_m[g2i]) % P

            # rewire the merged row
            for slot, gw in zip("lro", gate_wires[:3]):
                self._w(slot)[g1i] = gw.index
            if anchoring:
                self.w_l[g2i] = zero_idx
                self.w_r[g2i] = zero_idx
                self.w_o[g2i] = gate_wires[3].index
                self.q_m[g2i] = 0
                self.q_l[g2i] = 0
                self.q_r[g2i] = 0
                self.q_o[g2i] = 0
                self.q_c[g2i] = 0
            self.merged_count += 1

        # ---- compact the arrays, rebuild the permutation bookkeeping ----
        self.deleted_count = sum(deleted)
        keep = [g for g in range(self.n) if not deleted[g]]
        remap = {old: new for new, old in enumerate(keep)}
        if hasattr(self, "_forced_bool_gate"):
            self._forced_bool_gate = remap[self._forced_bool_gate]
        for name in ("w_l", "w_r", "w_o", "q_m", "q_l", "q_r", "q_o", "q_c", "q_oo", "gate_flags"):
            arr = getattr(self, name)
            setattr(self, name, [arr[g] for g in keep])
        self.n = len(keep)
        for cycles in self.wire_epicycles:
            cycles.clear()
        for g in range(self.n):
            self.wire_epicycles[self.w_l[g]].append((g, LEFT))
            self.wire_epicycles[self.w_r[g]].append((g, RIGHT))
            self.wire_epicycles[self.w_o[g]].append((g, OUTPUT))

    def check_circuit(self) -> bool:
        """Gate check including the q_oo * w_o(next row) term."""
        if len(self.q_oo) != self.n:
            return super().check_circuit()
        if not all(
            self.variables[i] in (0, 1)
            for i, marked in enumerate(self.is_bool)
            if marked
        ):
            return False
        for i in range(self.n):
            wl = self.variables[self.w_l[i]]
            wr = self.variables[self.w_r[i]]
            wo = self.variables[self.w_o[i]]
            wo_next = self.variables[self.w_o[(i + 1) % self.n]]
            if (
                self.q_m[i] * wl % P * wr
                + self.q_l[i] * wl
                + self.q_r[i] * wr
                + self.q_o[i] * wo
                + self.q_oo[i] * wo_next
                + self.q_c[i]
            ) % P != 0:
                return False
        return True

    def _change_epicycle(self, wire: int, gate: int, old_tag: int, new_tag: int):
        cycles = self.wire_epicycles[wire]
        for k, (g, t) in enumerate(cycles):
            if g == gate and t == old_tag:
                cycles[k] = (gate, new_tag)
                return

    # ------------------------------------------------------------------
    def preprocess(self, reference_string=None, device=None) -> Prover:
        """(extended_composer.cpp:464+): merge, then standard preprocess
        with Arithmetic + Bool + Sequential widgets."""
        if not hasattr(self, "_forced_bool_gate"):
            self.create_dummy_gates()
        zero_idx = self.add_variable(0)
        self._combine_linear_relations(zero_idx)
        user_n = self.n
        prover = super().preprocess(reference_string, device)
        q_oo = self.q_oo + [0] * (prover.n - user_n)
        # the sequential widget shares the arithmetic widget's alpha power
        # (old_alpha = alpha_base / alpha), so it must come directly after it
        # (extended_composer.cpp:696-700's widget order)
        prover.widgets.insert(1, ProverSequentialWidget(prover.fr.encode(q_oo)))
        return prover
