"""Core stdlib wire types: witness_t, field_t, bool_t.

Reference: waffle/stdlib/common.hpp:21-54 (witness registration),
stdlib/field/field.tcc (lazy-constant field wires), stdlib/bool/bool.tcc
(boolean wires with the free-NOT inverted flag).

A field_t tracks ``value = multiplicative_constant * x + additive_constant``
for circuit variable x, so scaling and shifting by constants are free; a
gate is emitted only when two witness-backed operands combine
(field.tcc:126-180). A bool_t tracks ``value = witness_bool ^ inverted``;
NOT just flips the flag (bool.tcc's witness_inverted trick).
"""

from __future__ import annotations

from ..fields.params import FR_MODULUS

P = FR_MODULUS
NO_WITNESS = -1


class witness_t:
    """Registers a concrete value as a circuit variable
    (common.hpp:21-54)."""

    def __init__(self, context, value: int):
        self.context = context
        self.value = int(value) % P
        self.witness_index = context.add_variable(self.value)


class field_t:
    def __init__(
        self,
        context=None,
        value: int | None = None,
        *,
        witness_index: int = NO_WITNESS,
        additive_constant: int = 0,
        multiplicative_constant: int = 1,
    ):
        self.context = context
        self.witness_index = witness_index
        if value is not None:
            # constant wire
            self.additive_constant = int(value) % P
            self.multiplicative_constant = 0
            self.witness_index = NO_WITNESS
        else:
            self.additive_constant = additive_constant % P
            self.multiplicative_constant = multiplicative_constant % P

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_witness(w: witness_t) -> "field_t":
        return field_t(w.context, witness_index=w.witness_index)

    @staticmethod
    def from_bool(b: "bool_t") -> "field_t":
        if b.witness_index == NO_WITNESS:
            return field_t(b.context, value=1 if b.get_value() else 0)
        if b.witness_inverted:
            return field_t(
                b.context,
                witness_index=b.witness_index,
                additive_constant=1,
                multiplicative_constant=P - 1,
            )
        return field_t(b.context, witness_index=b.witness_index)

    def _coerce(self, other) -> "field_t":
        if isinstance(other, field_t):
            return other
        return field_t(self.context, value=int(other))

    def is_constant(self) -> bool:
        return self.witness_index == NO_WITNESS

    # -- arithmetic (field.tcc:126-180, :192-248) ---------------------------
    def __add__(self, other) -> "field_t":
        other = self._coerce(other)
        ctx = self.context or other.context
        if self.witness_index == other.witness_index and not self.is_constant():
            return field_t(
                ctx,
                witness_index=self.witness_index,
                additive_constant=self.additive_constant + other.additive_constant,
                multiplicative_constant=self.multiplicative_constant
                + other.multiplicative_constant,
            )
        if self.is_constant() and other.is_constant():
            return field_t(
                ctx, value=self.additive_constant + other.additive_constant
            )
        if other.is_constant():
            return field_t(
                ctx,
                witness_index=self.witness_index,
                additive_constant=self.additive_constant + other.additive_constant,
                multiplicative_constant=self.multiplicative_constant,
            )
        if self.is_constant():
            return other + self
        # both witnesses: emit an add gate
        from ..composer import AddTriple

        left = ctx.get_variable(self.witness_index)
        right = ctx.get_variable(other.witness_index)
        out = (
            left * self.multiplicative_constant
            + right * other.multiplicative_constant
            + self.additive_constant
            + other.additive_constant
        ) % P
        out_idx = ctx.add_variable(out)
        ctx.create_add_gate(
            AddTriple(
                self.witness_index,
                other.witness_index,
                out_idx,
                self.multiplicative_constant,
                other.multiplicative_constant,
                P - 1,
                (self.additive_constant + other.additive_constant) % P,
            )
        )
        return field_t(ctx, witness_index=out_idx)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other) -> "field_t":
        other = self._coerce(other)
        neg = field_t(
            other.context,
            witness_index=other.witness_index,
            additive_constant=-other.additive_constant,
            multiplicative_constant=-other.multiplicative_constant
            if not other.is_constant()
            else 1,
        )
        if other.is_constant():
            neg = field_t(other.context, value=-other.additive_constant)
        return self.__add__(neg)

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    def __mul__(self, other) -> "field_t":
        other = self._coerce(other)
        ctx = self.context or other.context
        if self.is_constant() and other.is_constant():
            return field_t(
                ctx, value=self.additive_constant * other.additive_constant
            )
        if other.is_constant():
            return field_t(
                ctx,
                witness_index=self.witness_index,
                additive_constant=self.additive_constant * other.additive_constant,
                multiplicative_constant=self.multiplicative_constant
                * other.additive_constant,
            )
        if self.is_constant():
            return other * self
        # both witnesses: poly gate (field.tcc:192-248)
        from ..composer import PolyTriple

        q_c = self.additive_constant * other.additive_constant % P
        q_r = self.additive_constant * other.multiplicative_constant % P
        q_l = self.multiplicative_constant * other.additive_constant % P
        q_m = self.multiplicative_constant * other.multiplicative_constant % P
        left = ctx.get_variable(self.witness_index)
        right = ctx.get_variable(other.witness_index)
        out = (left * right % P * q_m + left * q_l + right * q_r + q_c) % P
        out_idx = ctx.add_variable(out)
        ctx.create_poly_gate(
            PolyTriple(
                self.witness_index,
                other.witness_index,
                out_idx,
                q_m,
                q_l,
                q_r,
                P - 1,
                q_c,
            )
        )
        return field_t(ctx, witness_index=out_idx)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other) -> "field_t":
        """(field.tcc:251-325)."""
        other = self._coerce(other)
        ctx = self.context or other.context
        if other.is_constant():
            inv = (
                pow(other.additive_constant, -1, P)
                if other.additive_constant
                else 1
            )
            if self.is_constant():
                return field_t(ctx, value=self.additive_constant * inv)
            return field_t(
                ctx,
                witness_index=self.witness_index,
                additive_constant=self.additive_constant * inv,
                multiplicative_constant=self.multiplicative_constant * inv,
            )
        from ..composer import PolyTriple

        num = self.get_value()
        den = other.get_value()
        out = num * pow(den, -1, P) % P
        out_idx = ctx.add_variable(out)
        # m2.x2.x3 + a2.x3 - m1.x1 - a1 = 0 with (left=x3, right=x2, out=x1)
        if self.is_constant():
            self_idx = ctx.add_variable(self.additive_constant)
            self_m, self_a = 1, 0
        else:
            self_idx = self.witness_index
            self_m, self_a = self.multiplicative_constant, self.additive_constant
        ctx.create_poly_gate(
            PolyTriple(
                out_idx,
                other.witness_index,
                self_idx,
                other.multiplicative_constant,
                other.additive_constant,
                0,
                -self_m,
                -self_a,
            )
        )
        return field_t(ctx, witness_index=out_idx)

    def normalize(self) -> "field_t":
        """Collapse scaling into a fresh variable (field.tcc:327-352)."""
        if self.is_constant() or (
            self.multiplicative_constant == 1 and self.additive_constant == 0
        ):
            return self
        from ..composer import AddTriple

        ctx = self.context
        out = self.get_value()
        out_idx = ctx.add_variable(out)
        ctx.create_add_gate(
            AddTriple(
                self.witness_index,
                self.witness_index,
                out_idx,
                self.multiplicative_constant,
                0,
                P - 1,
                self.additive_constant,
            )
        )
        return field_t(ctx, witness_index=out_idx)

    def get_value(self) -> int:
        if self.is_constant():
            return self.additive_constant
        x = self.context.get_variable(self.witness_index)
        return (x * self.multiplicative_constant + self.additive_constant) % P

    def assert_equal(self, other: "field_t") -> None:
        """Constrain self == other with one gate."""
        diff = self - other
        if diff.is_constant():
            assert diff.additive_constant == 0, "constant wires differ"
            return
        from ..composer import AddTriple

        ctx = diff.context
        zero = ctx.add_variable(0)
        ctx.create_add_gate(
            AddTriple(
                diff.witness_index,
                diff.witness_index,
                zero,
                diff.multiplicative_constant,
                0,
                0,
                diff.additive_constant,
            )
        )


class bool_t:
    """Boolean wire; value = witness_bool (constant) or
    inverted ? NOT var : var (bool.tcc)."""

    def __init__(self, context=None, value: bool = False):
        self.context = context
        self.witness_bool = bool(value)
        self.witness_inverted = False
        self.witness_index = NO_WITNESS

    @staticmethod
    def from_witness(w: witness_t) -> "bool_t":
        assert w.value in (0, 1), "bool witness must be 0 or 1"
        b = bool_t(w.context)
        b.witness_bool = w.value == 1
        b.witness_index = w.witness_index
        w.context.create_bool_gate(w.witness_index)
        return b

    def is_constant(self) -> bool:
        return self.witness_index == NO_WITNESS

    def get_value(self) -> bool:
        if self.is_constant():
            return self.witness_bool ^ self.witness_inverted
        x = self.context.get_variable(self.witness_index)
        return bool(x) ^ self.witness_inverted

    # affine view: value = ia + sa * x with ia in {0,1}, sa in {1, -1}
    def _affine(self):
        if self.witness_inverted:
            return 1, P - 1
        return 0, 1

    def _binary_op(self, other: "bool_t", table) -> "bool_t":
        """Emit a poly gate for out = f(a, b) where f is bilinear:
        table(ia, sa, ib, sb) -> (q_m, q_l, q_r, q_c)."""
        ctx = self.context or other.context
        if self.is_constant() and other.is_constant():
            raise AssertionError("handled by caller")
        from ..composer import PolyTriple

        a_idx = self.witness_index
        b_idx = other.witness_index
        ia, sa = self._affine()
        ib, sb = other._affine()
        q_m, q_l, q_r, q_c = table(ia, sa, ib, sb)
        a_val = ctx.get_variable(a_idx)
        b_val = ctx.get_variable(b_idx)
        out = (
            a_val * b_val % P * q_m + a_val * q_l + b_val * q_r + q_c
        ) % P
        out_idx = ctx.add_variable(out)
        ctx.create_poly_gate(
            PolyTriple(a_idx, b_idx, out_idx, q_m, q_l, q_r, P - 1, q_c)
        )
        res = bool_t(ctx)
        res.witness_bool = out == 1
        res.witness_index = out_idx
        return res

    def __and__(self, other: "bool_t") -> "bool_t":
        if self.is_constant() or other.is_constant():
            if self.is_constant():
                return other.__and__(self) if not other.is_constant() else bool_t(
                    self.context, self.get_value() and other.get_value()
                )
            # other is the constant
            if other.get_value():
                return self._copy()
            return bool_t(self.context, False)
        # a & b = (ia + sa x)(ib + sb y)
        return self._binary_op(
            other,
            lambda ia, sa, ib, sb: (
                sa * sb % P,
                sa * ib % P,
                sb * ia % P,
                ia * ib % P,
            ),
        )

    def __or__(self, other: "bool_t") -> "bool_t":
        if self.is_constant() or other.is_constant():
            if self.is_constant() and other.is_constant():
                return bool_t(self.context, self.get_value() or other.get_value())
            if self.is_constant():
                return other.__or__(self)
            if other.get_value():
                return bool_t(self.context, True)
            return self._copy()
        # a | b = a + b - ab
        return self._binary_op(
            other,
            lambda ia, sa, ib, sb: (
                -sa * sb % P,
                sa * (1 - ib) % P,
                sb * (1 - ia) % P,
                (ia + ib - ia * ib) % P,
            ),
        )

    def __xor__(self, other: "bool_t") -> "bool_t":
        if self.is_constant() or other.is_constant():
            if self.is_constant() and other.is_constant():
                return bool_t(self.context, self.get_value() ^ other.get_value())
            if self.is_constant():
                return other.__xor__(self)
            if other.get_value():
                return self.__invert__()
            return self._copy()
        # a ^ b = a + b - 2ab
        return self._binary_op(
            other,
            lambda ia, sa, ib, sb: (
                -2 * sa * sb % P,
                sa * (1 - 2 * ib) % P,
                sb * (1 - 2 * ia) % P,
                (ia + ib - 2 * ia * ib) % P,
            ),
        )

    def __invert__(self) -> "bool_t":
        """Free NOT: flip the inverted flag (bool.tcc's trick)."""
        res = self._copy()
        if res.is_constant():
            res.witness_bool = not res.witness_bool
        else:
            res.witness_inverted = not res.witness_inverted
        return res

    def __eq__(self, other) -> "bool_t":  # type: ignore[override]
        if not isinstance(other, bool_t):
            return NotImplemented
        return ~(self ^ other)

    def __hash__(self):
        return id(self)

    def _copy(self) -> "bool_t":
        res = bool_t(self.context)
        res.witness_bool = self.witness_bool
        res.witness_inverted = self.witness_inverted
        res.witness_index = self.witness_index
        return res
