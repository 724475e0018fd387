"""Twisted-Edwards group gadget (complete formulas) over the native field.

Counterpart of ``gingerlib_tpu/gadgets/std/te_groups.py``; mirrors
r1cs/gadgets/std/src/groups/curves/twisted_edwards/mod.rs: affine (x, y)
wires with the complete unified addition law

    x3 = (x1 y2 + y1 x2) / (1 + d x1 x2 y1 y2)
    y3 = (y1 y2 - a x1 x2) / (1 - d x1 x2 y1 y2)

so, unlike the SW gadget, there are no exceptional cases: a scalar
multiplication may start from the identity (0, 1) and needs no
generator-offset trick.  Cost: 7 constraints an addition, 3 an on-curve
check.

Also the fixed-base scalar multiplication of the Pedersen CRH gadget
(precomputed_base_scalar_mul, groups/mod.rs:97, with the TE gadget's 2-bit
lookup): the doubling chain is host-side and each 2-bit chunk costs two
lookups and one addition.  ``_host_add`` and ``_host_double`` are the
python-int twisted-Edwards arithmetic that the tests and ``chip_smoke.py``
hold the device curves to.
"""

from __future__ import annotations

from .boolean import Boolean
from .fp import FpG


class TEPointG:
    """Affine TE point gadget: x, y are FpG wires."""

    __slots__ = ("x", "y")

    def __init__(self, x: FpG, y: FpG):
        self.x = x
        self.y = y

    def value(self):
        if self.x.value is None or self.y.value is None:
            return None
        return (self.x.value, self.y.value)


class TEGroupGadget:
    def __init__(self, a_host: int, d_host: int, modulus: int):
        self.a = a_host % modulus
        self.d = d_host % modulus
        self.p = modulus

    @classmethod
    def for_curve(cls, curve):
        """curve: a ``curves/twisted_edwards.TECurveOps``."""
        return cls(curve.a_host, curve.d_host, curve.fp.modulus)

    # -- allocation --

    def alloc(self, cs, xy=None, name="pt") -> TEPointG:
        x = FpG.alloc(cs, None if xy is None else xy[0], f"{name}/x")
        y = FpG.alloc(cs, None if xy is None else xy[1], f"{name}/y")
        return TEPointG(x, y)

    def alloc_input(self, cs, xy=None, name="pt") -> TEPointG:
        x = FpG.alloc_input(cs, None if xy is None else xy[0], f"{name}/x")
        y = FpG.alloc_input(cs, None if xy is None else xy[1], f"{name}/y")
        return TEPointG(x, y)

    def alloc_checked(self, cs, xy=None, name="pt") -> TEPointG:
        pt = self.alloc(cs, xy, name)
        self.enforce_on_curve(cs, pt, f"{name}/on_curve")
        return pt

    def constant(self, cs, xy) -> TEPointG:
        return TEPointG(FpG.constant(cs, xy[0] % self.p),
                        FpG.constant(cs, xy[1] % self.p))

    def zero(self, cs) -> TEPointG:
        return self.constant(cs, (0, 1))

    # -- checks --

    def enforce_on_curve(self, cs, pt: TEPointG, name="on_curve"):
        """a x^2 + y^2 = 1 + d x^2 y^2, as (d x^2) y^2 = a x^2 + y^2 - 1."""
        x2 = pt.x.square(f"{name}/x2")
        y2 = pt.y.square(f"{name}/y2")
        dx2 = x2.mul_by_constant(self.d)
        rhs = x2.mul_by_constant(self.a).add(y2).add_constant(-1 % self.p)
        dx2.mul_equals(y2, rhs, f"{name}/eq")

    def enforce_equal(self, cs, pt, q, name="pt_eq"):
        pt.x.enforce_equal(q.x, f"{name}/x")
        pt.y.enforce_equal(q.y, f"{name}/y")

    def neg(self, cs, pt: TEPointG) -> TEPointG:
        return TEPointG(pt.x.neg(), pt.y)

    def cond_select(self, cs, cond: Boolean, a: TEPointG, b: TEPointG,
                    name="sel") -> TEPointG:
        return TEPointG(FpG.cond_select(cond, a.x, b.x, f"{name}/x"),
                        FpG.cond_select(cond, a.y, b.y, f"{name}/y"))

    # -- group law (complete) --

    def add(self, cs, pt: TEPointG, q: TEPointG, name="add") -> TEPointG:
        p = self.p
        v0 = pt.x.mul(q.y, f"{name}/x1y2")     # x1 y2
        v1 = pt.y.mul(q.x, f"{name}/y1x2")     # y1 x2
        v2 = pt.x.mul(q.x, f"{name}/x1x2")     # x1 x2
        v3 = pt.y.mul(q.y, f"{name}/y1y2")     # y1 y2
        t = v0.mul(v1, f"{name}/t")            # x1 x2 y1 y2
        x3v = y3v = None
        if all(w.value is not None for w in (v0, v1, v2, v3, t)):
            dt = self.d * t.value % p
            x3v = (v0.value + v1.value) * pow(1 + dt, -1, p) % p
            y3v = (v3.value - self.a * v2.value) * pow(1 - dt, -1, p) % p
        x3 = FpG.alloc(cs, x3v, f"{name}/x3")
        y3 = FpG.alloc(cs, y3v, f"{name}/y3")
        # x3 (1 + d t) = v0 + v1
        one_plus_dt = t.mul_by_constant(self.d).add_constant(1)
        x3.mul_equals(one_plus_dt, v0.add(v1), f"{name}/x3c")
        # y3 (1 - d t) = v3 - a v2
        one_minus_dt = t.mul_by_constant(-self.d % p).add_constant(1)
        y3.mul_equals(one_minus_dt, v3.sub(v2.mul_by_constant(self.a)),
                      f"{name}/y3c")
        return TEPointG(x3, y3)

    def double(self, cs, pt: TEPointG, name="dbl") -> TEPointG:
        return self.add(cs, pt, pt, name)

    def add_constant(self, cs, pt: TEPointG, xy, name="addc") -> TEPointG:
        return self.add(cs, pt, self.constant(cs, xy), name)

    # -- scalar multiplication --

    def mul_bits(self, cs, base: TEPointG, bits_lsb, name="mulbits",
                 acc: TEPointG | None = None) -> TEPointG:
        """sum of bit_i 2^i base (+ acc); complete formulas, so it starts
        at the identity."""
        result = acc if acc is not None else self.zero(cs)
        power = base
        for i, bit in enumerate(bits_lsb):
            added = self.add(cs, result, power, f"{name}/add{i}")
            result = self.cond_select(cs, bit, added, result, f"{name}/sel{i}")
            if i + 1 < len(bits_lsb):
                power = self.double(cs, power, f"{name}/dbl{i}")
        return result

    def mul_bits_fixed_base(self, cs, base_xy, bits_lsb, name="fbmul",
                            acc: TEPointG | None = None) -> TEPointG:
        """Fixed base through host-side 2-bit windows: a 2-bit chunk is a
        4-entry constant-point lookup and one complete addition
        (precomputed_base_scalar_mul, groups/mod.rs:97)."""
        result = acc if acc is not None else self.zero(cs)
        bits = list(bits_lsb)
        if len(bits) % 2:
            bits.append(Boolean.const(False))
        cur = (base_xy[0] % self.p, base_xy[1] % self.p)
        for w in range(len(bits) // 2):
            b0, b1 = bits[2 * w], bits[2 * w + 1]
            dbl = self._host_double(cur)
            tpl = self._host_add(dbl, cur)
            table_x = [0, cur[0], dbl[0], tpl[0]]
            table_y = [1, cur[1], dbl[1], tpl[1]]
            tx = FpG.two_bit_lookup(cs, (b0, b1), table_x, f"{name}/lx{w}")
            ty = FpG.two_bit_lookup(cs, (b0, b1), table_y, f"{name}/ly{w}")
            result = self.add(cs, result, TEPointG(tx, ty), f"{name}/add{w}")
            cur = self._host_double(dbl)  # x4 to the next window
        return result

    # -- host mirrors: the python-int twisted-Edwards arithmetic --

    def _host_add(self, P, Q):
        p = self.p
        x1, y1 = P
        x2, y2 = Q
        t = x1 * x2 * y1 * y2 % p
        x3 = (x1 * y2 + y1 * x2) * pow(1 + self.d * t, -1, p) % p
        y3 = (y1 * y2 - self.a * x1 * x2) * pow(1 - self.d * t, -1, p) % p
        return (x3, y3)

    def _host_double(self, P):
        return self._host_add(P, P)
