"""Boolean gadget: tri-state {allocated, negated-allocated, constant}.

Mirrors r1cs/gadgets/std/src/bits/boolean.rs (AllocatedBit :27-192,
Boolean :369-700); counterpart of ``gingerlib_tpu/gadgets/std/boolean.py``.  All synthesis is host-side python-int arithmetic on our
ConstraintSystem; constraint counts match the reference (xor/and/or: one
constraint each on allocated bits).
"""

from __future__ import annotations

from ...relations.r1cs import ConstraintSystem, LinearCombination, ONE


def _lc_one():
    return LinearCombination.of(ONE)


class Boolean:
    """value in {0,1}; three representations like the reference:
    constant | Is(var) | Not(var)."""

    def __init__(self, var=None, value=None, negated=False, constant=None):
        self.var = var            # allocated variable index (or None)
        self.value = value        # python 0/1 (may be None in setup mode)
        self.negated = negated
        self.constant = constant  # True/False for constants, else None

    # ---------------- constructors ----------------

    @staticmethod
    def const(b: bool) -> "Boolean":
        return Boolean(constant=bool(b))

    @staticmethod
    def alloc(cs: ConstraintSystem, value=None, name="bit") -> "Boolean":
        v = cs.alloc(name, None if value is None else int(bool(value)))
        # bit * (1 - bit) == 0  (boolean.rs:40-53)
        cs.enforce(LinearCombination.of(v), _lc_one() - LinearCombination.of(v),
                   LinearCombination(), f"{name}/booleanity")
        return Boolean(var=v, value=None if value is None else int(bool(value)))

    @staticmethod
    def alloc_input(cs: ConstraintSystem, value=None, name="bit") -> "Boolean":
        v = cs.alloc_input(name, None if value is None else int(bool(value)))
        cs.enforce(LinearCombination.of(v), _lc_one() - LinearCombination.of(v),
                   LinearCombination(), f"{name}/booleanity")
        return Boolean(var=v, value=None if value is None else int(bool(value)))

    # ---------------- views ----------------

    def get_value(self):
        if self.constant is not None:
            return int(self.constant)
        if self.value is None:
            return None
        return (1 - self.value) if self.negated else self.value

    def lc(self) -> LinearCombination:
        """coefficient-1 linear combination representing this boolean."""
        if self.constant is not None:
            return _lc_one() * int(self.constant)
        base = LinearCombination.of(self.var)
        return (_lc_one() - base) if self.negated else base

    def not_(self) -> "Boolean":
        if self.constant is not None:
            return Boolean.const(not self.constant)
        return Boolean(var=self.var, value=self.value,
                       negated=not self.negated)

    # ---------------- binary ops ----------------

    def xor(self, cs: ConstraintSystem, other: "Boolean") -> "Boolean":
        if self.constant is not None:
            return other if not self.constant else other.not_()
        if other.constant is not None:
            return self if not other.constant else self.not_()
        a, b = self, other
        av, bv = a.get_value(), b.get_value()
        val = None if av is None or bv is None else av ^ bv
        c = cs.alloc("xor", val)
        # (2a)·b = a + b − c  (boolean.rs xor: :70-96)
        cs.enforce(a.lc() * 2, b.lc(),
                   a.lc() + b.lc() - LinearCombination.of(c), "xor")
        return Boolean(var=c, value=val)

    def and_(self, cs: ConstraintSystem, other: "Boolean") -> "Boolean":
        if self.constant is not None:
            return other if self.constant else Boolean.const(False)
        if other.constant is not None:
            return self if other.constant else Boolean.const(False)
        av, bv = self.get_value(), other.get_value()
        val = None if av is None or bv is None else av & bv
        c = cs.alloc("and", val)
        cs.enforce(self.lc(), other.lc(), LinearCombination.of(c), "and")
        return Boolean(var=c, value=val)

    def or_(self, cs: ConstraintSystem, other: "Boolean") -> "Boolean":
        # a|b = ¬(¬a & ¬b)  (boolean.rs:536)
        return self.not_().and_(cs, other.not_()).not_()

    @staticmethod
    def kary_and(cs: ConstraintSystem, bits) -> "Boolean":
        acc = Boolean.const(True)
        for b in bits:
            acc = acc.and_(cs, b)
        return acc

    # ---------------- enforcement ----------------

    def enforce_equal(self, cs: ConstraintSystem, other: "Boolean",
                      name="bool_eq"):
        cs.enforce(self.lc() - other.lc(), _lc_one(), LinearCombination(),
                   name)

    @staticmethod
    def enforce_nand(cs: ConstraintSystem, bits, name="nand"):
        """Π bits != 1 (boolean.rs enforce_nand)."""
        acc = Boolean.kary_and(cs, bits)
        cs.enforce(acc.lc(), _lc_one(), LinearCombination(), name)

    @staticmethod
    def enforce_in_field(cs: ConstraintSystem, bits_be, modulus: int,
                         name="in_field"):
        """Enforce that the big-endian bit string is < modulus
        (boolean.rs:609 — decomposition comparison against (p-1) bits).

        Standard "smaller than" chain: run over the bits of p-1 from MSB;
        whenever p-1 has a run of ones followed by a zero, the candidate's
        corresponding bits cannot all be ones unless some earlier bit was
        smaller.  Implemented as the reference does: for every 0-bit of
        (p-1), enforce NAND of (current bit AND all 1-bits of p-1 seen so
        far in the current run-tracking form).
        """
        b = modulus - 1
        chars = bin(b)[2:]
        assert len(bits_be) == len(chars)
        current_run = []
        last_run = None
        for bit, c in zip(bits_be, chars):
            if c == "1":
                current_run.append(bit)
            else:
                if current_run:
                    if last_run is None:
                        last_run = Boolean.kary_and(cs, current_run)
                    else:
                        last_run = last_run.and_(
                            cs, Boolean.kary_and(cs, current_run))
                    current_run = []
                run = last_run if last_run is not None else Boolean.const(True)
                # if all previous 1-bits matched, this bit must be 0
                Boolean.enforce_nand(cs, [run, bit], name)
        return
