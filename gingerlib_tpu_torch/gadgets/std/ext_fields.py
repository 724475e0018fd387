"""In-circuit extension-field gadgets (r1cs/gadgets/std/src/fields/).

Counterpart of ``gingerlib_tpu/gadgets/std/ext_fields.py``: the MNT4,
MNT6 and BLS12 towers (Fq2, Fq4; Fq3, Fq6; Fq2, Fq6 = Fq2[V]/(V^3 - xi),
Fq12), their Frobenius tables from ``fields/host_ext.py``.

Same composable quad/cubic tower design as the device side
(fields/towers.py), but over FpG wires: elements are flat lists of K wires,
multiplication is Karatsuba/Toom with the reference's constraint counts,
Frobenius is free (constant multiplications on LCs).
"""

from __future__ import annotations

from ...fields import host_ext
from .fp import FpG


class FpGOps:
    """Degree-1 base: elements are [FpG]."""

    def __init__(self, field):
        self.field = field
        self.K = 1

    def const(self, cs, v) -> list:
        vs = v if isinstance(v, (list, tuple)) else [v]
        return [FpG.constant(cs, vs[0])]

    def alloc(self, cs, vals=None, name="e") -> list:
        return [FpG.alloc(cs, None if vals is None else vals[0], name)]

    def alloc_input(self, cs, vals=None, name="e") -> list:
        return [FpG.alloc_input(cs, None if vals is None else vals[0], name)]

    def one(self, cs):
        return [FpG.constant(cs, 1)]

    def zero(self, cs):
        return [FpG.constant(cs, 0)]

    def add(self, cs, a, b):
        return [a[0].add(b[0])]

    def sub(self, cs, a, b):
        return [a[0].sub(b[0])]

    def neg(self, cs, a):
        return [a[0].neg()]

    def double(self, cs, a):
        return [a[0].double()]

    def mul(self, cs, a, b, name="mul"):
        return [a[0].mul(b[0], name)]

    def sqr(self, cs, a, name="sqr"):
        return [a[0].square(name)]

    def inv(self, cs, a, name="inv"):
        return [a[0].inverse(name)]

    def mul_by_const(self, cs, a, k):
        ks = k if isinstance(k, (list, tuple)) else [k]
        return [a[0].mul_by_constant(ks[0])]

    def frob(self, cs, a, i):
        return a

    def enforce_equal(self, cs, a, b, name="eq"):
        a[0].enforce_equal(b[0], name)

    def conditionally_enforce_equal(self, cs, a, b, cond, name="ceq"):
        a[0].conditionally_enforce_equal(b[0], cond, name)

    def cond_select(self, cs, cond, a, b, name="sel"):
        return [FpG.cond_select(cond, a[0], b[0], name)]

    def value(self, a):
        return [a[0].value]


class _ExtG:
    def __init__(self, sub, degree):
        self.sf = sub
        self.field = sub.field
        self.degree = degree
        self.K = degree * sub.K

    def _split(self, x):
        k = self.sf.K
        return [x[i * k:(i + 1) * k] for i in range(self.degree)]

    def const(self, cs, comps):
        flat = _flatten(comps)
        assert len(flat) == self.K
        k = self.sf.K
        out = []
        for i in range(self.degree):
            out += self.sf.const(cs, flat[i * k:(i + 1) * k])
        return out

    def alloc(self, cs, vals=None, name="e"):
        k = self.sf.K
        out = []
        for i in range(self.degree):
            sub_vals = None if vals is None else vals[i * k:(i + 1) * k]
            out += self.sf.alloc(cs, sub_vals, f"{name}/c{i}")
        return out

    def alloc_input(self, cs, vals=None, name="e"):
        k = self.sf.K
        out = []
        for i in range(self.degree):
            sub_vals = None if vals is None else vals[i * k:(i + 1) * k]
            out += self.sf.alloc_input(cs, sub_vals, f"{name}/c{i}")
        return out

    def one(self, cs):
        return self.sf.one(cs) + self.sf.zero(cs) * (self.degree - 1)

    def zero(self, cs):
        return self.sf.zero(cs) * self.degree

    def add(self, cs, a, b):
        return [x.add(y) for x, y in zip(a, b)]

    def sub(self, cs, a, b):
        return [x.sub(y) for x, y in zip(a, b)]

    def neg(self, cs, a):
        return [x.neg() for x in a]

    def double(self, cs, a):
        return [x.double() for x in a]

    def enforce_equal(self, cs, a, b, name="eq"):
        for i, (x, y) in enumerate(zip(a, b)):
            x.enforce_equal(y, f"{name}/{i}")

    def conditionally_enforce_equal(self, cs, a, b, cond, name="ceq"):
        for i, (x, y) in enumerate(zip(a, b)):
            x.conditionally_enforce_equal(y, cond, f"{name}/{i}")

    def cond_select(self, cs, cond, a, b, name="sel"):
        return [FpG.cond_select(cond, x, y, f"{name}/{i}")
                for i, (x, y) in enumerate(zip(a, b))]

    def value(self, a):
        return [x.value for x in a]


def _flatten(v):
    if isinstance(v, int):
        return [v]
    out = []
    for c in v:
        out.extend(_flatten(c))
    return out


class QuadExtG(_ExtG):
    def __init__(self, sub, nonresidue_host, frob_c1_host):
        super().__init__(sub, 2)
        self.nr = nonresidue_host
        self.frob_c1 = frob_c1_host  # subfield host consts per power

    def mul_by_nonresidue(self, cs, a):
        return self.sf.mul_by_const(cs, a, self.nr)

    def mul(self, cs, x, y, name="mul"):
        a0, a1 = self._split(x)
        b0, b1 = self._split(y)
        S = self.sf
        v0 = S.mul(cs, a0, b0, f"{name}/v0")
        v1 = S.mul(cs, a1, b1, f"{name}/v1")
        c0 = S.add(cs, v0, self.mul_by_nonresidue(cs, v1))
        t = S.mul(cs, S.add(cs, a0, a1), S.add(cs, b0, b1), f"{name}/t")
        c1 = S.sub(cs, S.sub(cs, t, v0), v1)
        return c0 + c1

    def sqr(self, cs, x, name="sqr"):
        a0, a1 = self._split(x)
        S = self.sf
        v0 = S.sqr(cs, a0, f"{name}/v0")
        v1 = S.sqr(cs, a1, f"{name}/v1")
        c0 = S.add(cs, v0, self.mul_by_nonresidue(cs, v1))
        t = S.sqr(cs, S.add(cs, a0, a1), f"{name}/t")
        c1 = S.sub(cs, S.sub(cs, t, v0), v1)
        return c0 + c1

    def inv(self, cs, x, name="inv"):
        a0, a1 = self._split(x)
        S = self.sf
        norm = S.sub(cs, S.sqr(cs, a0, f"{name}/a0s"),
                     self.mul_by_nonresidue(cs, S.sqr(cs, a1, f"{name}/a1s")))
        t = S.inv(cs, norm, f"{name}/n")
        return S.mul(cs, a0, t, f"{name}/c0") + \
            S.neg(cs, S.mul(cs, a1, t, f"{name}/c1"))

    def conjugate(self, cs, x):
        a0, a1 = self._split(x)
        return a0 + self.sf.neg(cs, a1)

    unitary_inverse = conjugate

    def frob(self, cs, x, i):
        a0, a1 = self._split(x)
        S = self.sf
        f0 = S.frob(cs, a0, i)
        f1 = S.mul_by_const(cs, S.frob(cs, a1, i), self.frob_c1[i % self.K])
        return f0 + f1

    def mul_by_const(self, cs, x, k):
        flat = _flatten(k)
        k0, k1 = flat[:self.sf.K], flat[self.sf.K:]
        # (a0 + a1 Y)(k0 + k1 Y) done as full const mult
        a0, a1 = self._split(x)
        S = self.sf
        t00 = S.mul_by_const(cs, a0, k0)
        t11 = S.mul_by_const(cs, a1, k1)
        t01 = S.mul_by_const(cs, a0, k1)
        t10 = S.mul_by_const(cs, a1, k0)
        c0 = S.add(cs, t00, S.mul_by_const(cs, t11, self.nr))
        c1 = S.add(cs, t01, t10)
        return c0 + c1


class CubicExtG(_ExtG):
    def __init__(self, sub, nonresidue_host, frob_c1_host, frob_c2_host):
        super().__init__(sub, 3)
        self.nr = nonresidue_host
        self.frob_c1 = frob_c1_host
        self.frob_c2 = frob_c2_host

    def mul_by_nonresidue(self, cs, a):
        return self.sf.mul_by_const(cs, a, self.nr)

    def mul(self, cs, x, y, name="mul"):
        a0, a1, a2 = self._split(x)
        b0, b1, b2 = self._split(y)
        S = self.sf
        v0 = S.mul(cs, a0, b0, f"{name}/v0")
        v1 = S.mul(cs, a1, b1, f"{name}/v1")
        v2 = S.mul(cs, a2, b2, f"{name}/v2")
        t12 = S.mul(cs, S.add(cs, a1, a2), S.add(cs, b1, b2), f"{name}/t12")
        c0 = S.add(cs, v0, self.mul_by_nonresidue(
            cs, S.sub(cs, S.sub(cs, t12, v1), v2)))
        t01 = S.mul(cs, S.add(cs, a0, a1), S.add(cs, b0, b1), f"{name}/t01")
        c1 = S.add(cs, S.sub(cs, S.sub(cs, t01, v0), v1),
                   self.mul_by_nonresidue(cs, v2))
        t02 = S.mul(cs, S.add(cs, a0, a2), S.add(cs, b0, b2), f"{name}/t02")
        c2 = S.add(cs, S.sub(cs, S.sub(cs, t02, v0), v2), v1)
        return c0 + c1 + c2

    def sqr(self, cs, x, name="sqr"):
        return self.mul(cs, x, x, name)

    def inv(self, cs, x, name="inv"):
        a0, a1, a2 = self._split(x)
        S = self.sf
        s0 = S.sub(cs, S.sqr(cs, a0, f"{name}/a0s"),
                   self.mul_by_nonresidue(cs, S.mul(cs, a1, a2, f"{name}/a12")))
        s1 = S.sub(cs, self.mul_by_nonresidue(cs, S.sqr(cs, a2, f"{name}/a2s")),
                   S.mul(cs, a0, a1, f"{name}/a01"))
        s2 = S.sub(cs, S.sqr(cs, a1, f"{name}/a1s"),
                   S.mul(cs, a0, a2, f"{name}/a02"))
        norm = S.add(cs, S.mul(cs, a0, s0, f"{name}/n0"),
                     self.mul_by_nonresidue(cs, S.add(
                         cs, S.mul(cs, a2, s1, f"{name}/n1"),
                         S.mul(cs, a1, s2, f"{name}/n2"))))
        t = S.inv(cs, norm, f"{name}/n")
        return S.mul(cs, s0, t, f"{name}/c0") + \
            S.mul(cs, s1, t, f"{name}/c1") + \
            S.mul(cs, s2, t, f"{name}/c2")

    def frob(self, cs, x, i):
        a0, a1, a2 = self._split(x)
        S = self.sf
        f0 = S.frob(cs, a0, i)
        f1 = S.mul_by_const(cs, S.frob(cs, a1, i), self.frob_c1[i % self.K])
        f2 = S.mul_by_const(cs, S.frob(cs, a2, i), self.frob_c2[i % self.K])
        return f0 + f1 + f2

    def mul_by_const(self, cs, x, k):
        flat = _flatten(k)
        K = self.sf.K
        k0, k1, k2 = flat[:K], flat[K:2 * K], flat[2 * K:]
        a0, a1, a2 = self._split(x)
        S = self.sf
        def mc(a, kk):
            return S.mul_by_const(cs, a, kk)
        c0 = S.add(cs, mc(a0, k0), self.mul_by_nonresidue(
            cs, S.add(cs, mc(a1, k2), mc(a2, k1))))
        c1 = S.add(cs, S.add(cs, mc(a0, k1), mc(a1, k0)),
                   self.mul_by_nonresidue(cs, mc(a2, k2)))
        c2 = S.add(cs, S.add(cs, mc(a0, k2), mc(a1, k1)), mc(a2, k0))
        return c0 + c1 + c2


# ---------------------------------------------------------------------------
# builders mirroring fields/towers.py
# ---------------------------------------------------------------------------

def build_mnt4_tower_gadgets(fq_params, nr2: int):
    p = fq_params.modulus
    base = FpGOps(fq_params)
    fq2 = QuadExtG(base, nr2, host_ext.frob_table_fp2(p, nr2))
    c1_4 = host_ext.frob_table_fp4(p, nr2)
    fq4 = QuadExtG(fq2, [0, 1], [[c, 0] for c in c1_4])
    return base, fq2, fq4


def build_mnt6_tower_gadgets(fq_params, nr3: int):
    p = fq_params.modulus
    base = FpGOps(fq_params)
    c1, c2 = host_ext.frob_table_fp3(p, nr3)
    fq3 = CubicExtG(base, nr3, c1, c2)
    c1_6 = host_ext.frob_table_fp6_2over3(p, nr3)
    fq6 = QuadExtG(fq3, [0, 1, 0], [[c, 0, 0] for c in c1_6])
    return base, fq3, fq6


def build_bls12_tower_gadgets(fq_params, nr2: int, xi):
    """Fq -> Fq2 (X^2 = nr2) -> Fq6 (V^3 = xi) -> Fq12 (W^2 = V), gadget
    descriptors mirroring fields/towers.build_bls12_towers."""
    p = fq_params.modulus
    base = FpGOps(fq_params)
    fq2 = QuadExtG(base, nr2, host_ext.frob_table_fp2(p, nr2))
    c1, c2 = host_ext.frob_table_fp6_3over2(p, nr2, xi)
    fq6 = CubicExtG(fq2, list(xi), [list(c) for c in c1],
                    [list(c) for c in c2])
    c1_12 = host_ext.frob_table_fp12(p, nr2, xi)
    fq12 = QuadExtG(fq6, [0, 0, 1, 0, 0, 0],
                    [[list(c), [0, 0], [0, 0]] for c in c1_12])
    return base, fq2, fq6, fq12
