"""32-bit word gadget (reference: waffle/stdlib/uint32/uint32.tcc).

Representation mirrors the reference's lazy-carry design: a Uint32 holds a
field accumulator plus a bound on its integer value; additions just add
accumulators (one gate each) and defer the mod-2^32 range proof until the
bound approaches overflow or bits are needed, at which point `normalize`
decomposes into 32 value bits + carry bits (uint32.tcc's
decompose/normalize). Bitwise ops work on the bool_t decomposition with one
poly gate per bit; shifts and rotates permute the bit list for free.
"""

from __future__ import annotations

from ..fields.params import FR_MODULUS
from .types import NO_WITNESS, bool_t, field_t, witness_t

P = FR_MODULUS
MASK32 = (1 << 32) - 1
# normalize before the accumulator could approach the field modulus
_MAX_ACC = 1 << 240


class Uint32:
    def __init__(self, context=None, value: int | None = None):
        self.context = context
        self._bits: list[bool_t] | None = None
        self._acc: field_t | None = None
        self.maximum = 0
        if value is not None:
            self._acc = field_t(context, value=int(value) & MASK32)
            self.maximum = int(value) & MASK32

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_witness(w: witness_t) -> "Uint32":
        """Witness word; immediately range-constrained to 32 bits via
        decomposition (uint32.tcc's witness constructor)."""
        assert w.value <= MASK32, "uint32 witness out of range"
        u = Uint32(w.context)
        u._acc = field_t.from_witness(w)
        u.maximum = MASK32
        u._decompose(extra_bits=0)
        return u

    @staticmethod
    def from_bits(context, bits: list[bool_t]) -> "Uint32":
        assert len(bits) == 32
        u = Uint32(context)
        u._bits = list(bits)
        u.maximum = MASK32
        return u

    @staticmethod
    def from_field(f: field_t, maximum: int) -> "Uint32":
        u = Uint32(f.context)
        u._acc = f
        u.maximum = maximum
        return u

    def is_constant(self) -> bool:
        if self._bits is not None:
            return all(b.is_constant() for b in self._bits)
        return self._acc.is_constant()

    # -- value plumbing --------------------------------------------------------
    def get_value(self) -> int:
        if self._bits is not None:
            v = 0
            for i, b in enumerate(self._bits):
                v |= int(b.get_value()) << i
            return v
        return self._acc.get_value() & MASK32

    def _accumulator(self) -> field_t:
        """Field wire holding the (possibly un-normalized) integer value."""
        if self._acc is None:
            # materialize from bits: sum of 2^i * b_i (weighted add chain)
            acc = field_t(self.context, value=0)
            for i, b in enumerate(self._bits):
                acc = acc + field_t.from_bool(b) * (1 << i)
            self._acc = acc
        return self._acc

    def _decompose(self, extra_bits: int | None = None) -> None:
        """Range-proof the accumulator: acc == sum 2^i b_i + 2^32 * carry,
        all bits boolean-constrained; keeps the low 32 bits
        (uint32.tcc normalize)."""
        acc = self._accumulator()
        if acc.is_constant():
            v = acc.get_value()
            self._bits = [
                bool_t(self.context, bool((v >> i) & 1)) for i in range(32)
            ]
            self._acc = field_t(self.context, value=v & MASK32)
            self.maximum = v & MASK32
            return
        ctx = self.context
        if extra_bits is None:
            extra_bits = max(0, self.maximum.bit_length() - 32)
        v = acc.get_value()
        bits = []
        for i in range(32 + extra_bits):
            w = witness_t(ctx, (v >> i) & 1)
            bits.append(bool_t.from_witness(w))
        total = field_t(ctx, value=0)
        for i, b in enumerate(bits):
            total = total + field_t.from_bool(b) * (1 << i)
        acc.assert_equal(total)
        self._bits = bits[:32]
        low = field_t(ctx, value=0)
        for i, b in enumerate(self._bits):
            low = low + field_t.from_bool(b) * (1 << i)
        self._acc = low
        self.maximum = MASK32

    def normalize(self) -> "Uint32":
        if self._bits is None or self.maximum > MASK32:
            self._decompose()
        return self

    def get_bits(self) -> list[bool_t]:
        if self._bits is None:
            self._decompose()
        return self._bits

    # -- arithmetic (lazy carries, uint32.tcc add path) -----------------------
    def _coerce(self, other) -> "Uint32":
        if isinstance(other, Uint32):
            return other
        return Uint32(self.context, value=int(other))

    def __add__(self, other) -> "Uint32":
        other = self._coerce(other)
        a, b = self, other
        if a.maximum + b.maximum >= _MAX_ACC:
            a = a.normalize()
        if a.maximum + b.maximum >= _MAX_ACC:
            b = b.normalize()
        out = Uint32(self.context or other.context)
        out._acc = a._accumulator() + b._accumulator()
        out.maximum = a.maximum + b.maximum
        return out

    __radd__ = __add__

    def __sub__(self, other) -> "Uint32":
        other = self._coerce(other).normalize()
        # a - b + k*2^32 >= 0 for k covering a's bound
        k = (self.maximum >> 32) + 2
        out = Uint32(self.context or other.context)
        out._acc = self._accumulator() - other._accumulator() + (k << 32)
        out.maximum = self.maximum + (k << 32)
        return out

    def __mul__(self, other) -> "Uint32":
        other = self._coerce(other)
        a = self.normalize()
        b = other.normalize()
        out = Uint32(self.context or other.context)
        out._acc = a._accumulator() * b._accumulator()
        out.maximum = a.maximum * b.maximum
        return out

    __rmul__ = __mul__

    def _divmod(self, other) -> tuple["Uint32", "Uint32"]:
        """Witness-division with range-checked remainder (reference:
        waffle/stdlib/uint32/uint32.tcc:743-830 operator/): witness the
        quotient q, range-constrain it to 32 bits, form r = a - b*q with
        in-circuit uint32 arithmetic, then constrain r < b. A zero divisor
        makes the r < b constraint unsatisfiable (matching the reference,
        where no satisfying witness exists)."""
        other = self._coerce(other)
        ctx = self.context or other.context
        if self.is_constant() and other.is_constant():
            a_val, b_val = self.get_value(), other.get_value()
            return (
                Uint32(ctx, value=a_val // b_val),
                Uint32(ctx, value=a_val % b_val),
            )
        a = self.normalize()
        b = other.normalize()
        a_val, b_val = a.get_value(), b.get_value()
        q_val = a_val // b_val if b_val else 0  # witness only; 0-div is
        q = Uint32.from_witness(witness_t(ctx, q_val))  # then unsatisfiable
        r = (a - b * q).normalize()
        lt = r._lt_bit(b)
        # pin the comparison to TRUE (reference: assert_equal on the wires)
        field_t.from_bool(lt).assert_equal(field_t(ctx, value=1))
        return q, r

    def __floordiv__(self, other) -> "Uint32":
        return self._divmod(other)[0]

    def __mod__(self, other) -> "Uint32":
        return self._divmod(other)[1]

    # -- bitwise ---------------------------------------------------------------
    def _bitwise(self, other, op) -> "Uint32":
        other = self._coerce(other)
        a_bits = self.get_bits()
        b_bits = other.get_bits()
        return Uint32.from_bits(
            self.context or other.context,
            [op(x, y) for x, y in zip(a_bits, b_bits)],
        )

    def __and__(self, other) -> "Uint32":
        return self._bitwise(other, lambda x, y: x & y)

    def __or__(self, other) -> "Uint32":
        return self._bitwise(other, lambda x, y: x | y)

    def __xor__(self, other) -> "Uint32":
        return self._bitwise(other, lambda x, y: x ^ y)

    def __invert__(self) -> "Uint32":
        return Uint32.from_bits(self.context, [~b for b in self.get_bits()])

    # -- shifts / rotates (free bit permutations, uint32.tcc ror/shr) ----------
    def __rshift__(self, n: int) -> "Uint32":
        bits = self.get_bits()
        zero = bool_t(self.context, False)
        return Uint32.from_bits(
            self.context, bits[n:] + [zero] * min(n, 32)
        )

    def __lshift__(self, n: int) -> "Uint32":
        bits = self.get_bits()
        zero = bool_t(self.context, False)
        return Uint32.from_bits(
            self.context, [zero] * min(n, 32) + bits[: 32 - n]
        )

    def ror(self, n: int) -> "Uint32":
        bits = self.get_bits()
        n %= 32
        return Uint32.from_bits(self.context, bits[n:] + bits[:n])

    def rol(self, n: int) -> "Uint32":
        return self.ror(32 - (n % 32))

    # -- comparisons -------------------------------------------------------------
    def _lt_bit(self, other) -> bool_t:
        """bool_t for self < other: bit 32 of (self - other + 2^32) is 0."""
        other = self._coerce(other)
        a = self.normalize()
        b = other.normalize()
        diff = a._accumulator() - b._accumulator() + (1 << 32)
        if diff.is_constant():
            return bool_t(self.context, not ((diff.get_value() >> 32) & 1))
        ctx = self.context or other.context
        v = diff.get_value()
        bits = []
        for i in range(33):
            w = witness_t(ctx, (v >> i) & 1)
            bits.append(bool_t.from_witness(w))
        total = field_t(ctx, value=0)
        for i, bb in enumerate(bits):
            total = total + field_t.from_bool(bb) * (1 << i)
        diff.assert_equal(total)
        return ~bits[32]

    def __lt__(self, other) -> bool_t:
        return self._lt_bit(other)

    def __ge__(self, other) -> bool_t:
        return ~self._lt_bit(other)

    def __gt__(self, other) -> bool_t:
        return self._coerce(other)._lt_bit(self)

    def __le__(self, other) -> bool_t:
        return ~self._coerce(other)._lt_bit(self)

    def eq(self, other) -> bool_t:
        """Equality via two comparisons (a >= b) & (b >= a)."""
        other = self._coerce(other)
        return self.__ge__(other) & other.__ge__(self)

    def ne(self, other) -> bool_t:
        return ~self.eq(other)
