"""Native-field wire gadget (r1cs/gadgets/std/src/fields/fp.rs).

Counterpart of ``gingerlib_tpu/gadgets/std/fp.py``.

A wire is a LinearCombination plus (in proving mode) its python-int value.
Linear ops are free; mul/inverse/select cost the reference's constraint
counts (mul 1, inverse 1, cond_select 1, to_bits n+1, ...).
"""

from __future__ import annotations

from ...relations.r1cs import ConstraintSystem, LinearCombination, ONE
from .boolean import Boolean


def _one_lc():
    return LinearCombination.of(ONE)


class FpG:
    __slots__ = ("cs", "lc", "value")

    def __init__(self, cs: ConstraintSystem, lc: LinearCombination,
                 value=None):
        self.cs = cs
        self.lc = lc
        self.value = None if value is None else value % cs.field.modulus

    # ---------------- constructors ----------------

    @staticmethod
    def alloc(cs, value=None, name="fp") -> "FpG":
        v = cs.alloc(name, value)
        return FpG(cs, LinearCombination.of(v), value)

    @staticmethod
    def alloc_input(cs, value=None, name="fp") -> "FpG":
        v = cs.alloc_input(name, value)
        return FpG(cs, LinearCombination.of(v), value)

    @staticmethod
    def constant(cs, k: int) -> "FpG":
        k = k % cs.field.modulus
        return FpG(cs, _one_lc() * k, k)

    @staticmethod
    def from_boolean(cs, b: Boolean) -> "FpG":
        return FpG(cs, b.lc(), b.get_value())

    # ---------------- linear ops (free) ----------------

    def add(self, other: "FpG") -> "FpG":
        val = None if self.value is None or other.value is None \
            else self.value + other.value
        return FpG(self.cs, self.lc + other.lc, val)

    def sub(self, other: "FpG") -> "FpG":
        val = None if self.value is None or other.value is None \
            else self.value - other.value
        return FpG(self.cs, self.lc - other.lc, val)

    def neg(self) -> "FpG":
        return FpG(self.cs, self.lc * -1,
                   None if self.value is None else -self.value)

    def add_constant(self, k: int) -> "FpG":
        return self.add(FpG.constant(self.cs, k))

    def mul_by_constant(self, k: int) -> "FpG":
        val = None if self.value is None else self.value * k
        return FpG(self.cs, self.lc * k, val)

    def double(self) -> "FpG":
        return self.add(self)

    # ---------------- multiplicative ops ----------------

    def mul(self, other: "FpG", name="mul") -> "FpG":
        p = self.cs.field.modulus
        val = None if self.value is None or other.value is None \
            else self.value * other.value % p
        out = FpG.alloc(self.cs, val, name)
        self.cs.enforce(self.lc, other.lc, out.lc, name)
        return out

    def square(self, name="square") -> "FpG":
        return self.mul(self, name)

    def inverse(self, name="inverse") -> "FpG":
        """1 constraint: self * out == 1 (fp.rs:298; fails for zero)."""
        p = self.cs.field.modulus
        val = None
        if self.value is not None:
            if self.value == 0:
                raise ZeroDivisionError("inverse of zero wire")
            val = pow(self.value, -1, p)
        out = FpG.alloc(self.cs, val, name)
        self.cs.enforce(self.lc, out.lc, _one_lc(), name)
        return out

    def mul_equals(self, other: "FpG", result: "FpG", name="mul_equals"):
        self.cs.enforce(self.lc, other.lc, result.lc, name)

    def square_equals(self, result: "FpG", name="square_equals"):
        self.cs.enforce(self.lc, self.lc, result.lc, name)

    # ---------------- equality ----------------

    def enforce_equal(self, other: "FpG", name="eq"):
        self.cs.enforce(self.lc - other.lc, _one_lc(), LinearCombination(),
                        name)

    def conditionally_enforce_equal(self, other: "FpG", cond: Boolean,
                                    name="cond_eq"):
        """(a − b)·cond == 0 (eq.rs ConditionalEqGadget)."""
        self.cs.enforce(self.lc - other.lc, cond.lc(), LinearCombination(),
                        name)

    def is_eq(self, other: "FpG", name="verdict") -> Boolean:
        """Boolean-result equality (EquVerdictGadget, eq.rs:7-145 /
        doc/SchnorrVerdict.md): allocate v, t with
            (a−b)·t == 1−v      and      (a−b)·v == 0.
        """
        cs = self.cs
        p = cs.field.modulus
        diff = self.sub(other)
        v_val = t_val = None
        if diff.value is not None:
            d = diff.value % p
            v_val = 1 if d == 0 else 0
            t_val = 1 if d == 0 else pow(d, -1, p)
        v = Boolean.alloc(cs, v_val, f"{name}/v")
        t = FpG.alloc(cs, t_val, f"{name}/t")
        cs.enforce(diff.lc, t.lc, _one_lc() - v.lc(), f"{name}/inv")
        cs.enforce(diff.lc, v.lc(), LinearCombination(), f"{name}/zero")
        return v

    def is_zero(self, name="is_zero") -> Boolean:
        return self.is_eq(FpG.constant(self.cs, 0), name)

    # ---------------- selection ----------------

    @staticmethod
    def cond_select(cond: Boolean, a: "FpG", b: "FpG",
                    name="select") -> "FpG":
        """cond ? a : b — 1 constraint (select.rs CondSelectGadget)."""
        cs = a.cs
        p = cs.field.modulus
        val = None
        cv = cond.get_value()
        if cv is not None and a.value is not None and b.value is not None:
            val = a.value if cv else b.value
        out = FpG.alloc(cs, val, name)
        # cond·(a − b) == out − b
        cs.enforce(cond.lc(), a.lc - b.lc, out.lc - b.lc, name)
        return out

    # ---------------- bit (de)composition ----------------

    def to_bits_with_length_restriction(self, skip_leading: int,
                                        name="to_bits"):
        """Big-endian bits of the wire with `skip_leading` top bits dropped
        (fp.rs:35 — the truncation primitive for Schnorr/VRF).  Allocates
        (nbits − skip) bits and enforces the packing constraint."""
        cs = self.cs
        p = cs.field.modulus
        nbits = p.bit_length() - skip_leading
        bits = []
        if self.value is not None:
            vbits = [(self.value >> i) & 1 for i in range(nbits)][::-1]
        else:
            vbits = [None] * nbits
        for i, vb in enumerate(vbits):
            bits.append(Boolean.alloc(cs, vb, f"{name}/bit{i}"))
        # Σ bit_i · 2^i == self  (one packing constraint)
        acc = LinearCombination()
        coeff = 1
        for b in reversed(bits):  # LSB first
            acc = acc + b.lc() * coeff
            coeff <<= 1
        cs.enforce(acc - self.lc, _one_lc(), LinearCombination(),
                   f"{name}/packing")
        return bits  # big-endian

    def to_bits(self, name="to_bits"):
        return self.to_bits_with_length_restriction(0, name)

    def to_bits_strict(self, name="to_bits_strict"):
        bits = self.to_bits(name)
        Boolean.enforce_in_field(self.cs, bits, self.cs.field.modulus,
                                 f"{name}/in_field")
        return bits

    @staticmethod
    def from_bits(cs, bits_be, name="from_bits") -> "FpG":
        """Pack big-endian booleans into a wire (fp.rs:489) — free (LC)."""
        acc = LinearCombination()
        val = 0
        known = True
        coeff = 1
        for b in reversed(bits_be):
            acc = acc + b.lc() * coeff
            bv = b.get_value()
            if bv is None:
                known = False
            elif bv:
                val += coeff
            coeff <<= 1
        return FpG(cs, acc, val % cs.field.modulus if known else None)

    def is_odd(self, name="is_odd") -> Boolean:
        bits = self.to_bits_strict(name)
        return bits[-1]

    # ---------------- lookups (select.rs:21,46) ----------------

    @staticmethod
    def two_bit_lookup(cs, bits, table, name="lookup2") -> "FpG":
        """table[b0 + 2·b1] with b = (b0, b1) booleans; 1 constraint."""
        b0, b1 = bits
        c0, c1, c2, c3 = [t % cs.field.modulus for t in table]
        val = None
        if b0.get_value() is not None and b1.get_value() is not None:
            val = table[b0.get_value() + 2 * b1.get_value()]
        out = FpG.alloc(cs, val, name)
        # b1·b0·(c3−c2−c1+c0) + b0·(c1−c0) + b1·(c2−c0) + c0 == out
        # as one R1CS constraint: b1 · [b0·(c3−c2−c1+c0) pre-packed] …
        # standard form: (b1)·(b0·(c3−c2−c1+c0) + c2−c0) = out − b0·(c1−c0) − c0
        lhs_b = b0.lc() * ((c3 - c2 - c1 + c0) % cs.field.modulus) \
            + _one_lc() * ((c2 - c0) % cs.field.modulus)
        rhs = out.lc - b0.lc() * ((c1 - c0) % cs.field.modulus) \
            - _one_lc() * c0
        cs.enforce(b1.lc(), lhs_b, rhs, name)
        return out

    @staticmethod
    def three_bit_cond_neg_lookup(cs, bits, b0b1, table,
                                  name="lookup3") -> "FpG":
        """table[b0+2b1] negated when b2 (select.rs:46).  b0b1 is the
        precomputed AND of b0 and b1 (shared across calls)."""
        b0, b1, b2 = bits
        p = cs.field.modulus
        c0, c1, c2, c3 = [t % p for t in table]
        val = None
        if all(b.get_value() is not None for b in bits):
            y = table[b0.get_value() + 2 * b1.get_value()] % p
            val = (-y) % p if b2.get_value() else y
        out = FpG.alloc(cs, val, name)
        # y = c0 + b0(c1−c0) + b1(c2−c0) + b0b1(c3−c2−c1+c0)
        y_lc = _one_lc() * c0 + b0.lc() * ((c1 - c0) % p) \
            + b1.lc() * ((c2 - c0) % p) \
            + b0b1.lc() * ((c3 - c2 - c1 + c0) % p)
        # out = y·(1 − 2·b2)  →  (y)·(1 − 2 b2) == out
        cs.enforce(y_lc, _one_lc() - b2.lc() * 2, out.lc, name)
        return out
