"""Extension-field towers as batched flat component tensors.

Counterpart of ``gingerlib_tpu/fields/towers.py``: the base field with a
unit component axis (``FpOps``), the quadratic extension (``QuadExtOps``)
and the cubic one (``CubicExtOps``): Fq2, which carries G2 of MNT4-753 and
of BLS12; MNT4's Fq4 = Fq2[Y]/(Y^2 - X), which carries its pairing's GT;
Fq3, which carries G2 of MNT6-753, and MNT6's Fq6 = Fq3[Y]/(Y^2 - X), its
GT; BLS12's Fq6 = Fq2[V]/(V^3 - xi) and Fq12 = Fq6[W]/(W^2 - V), its GT;
with the cyclotomic squares (the quartic formula, Granger-Scott over
Fq12), the sparse line multiplies ``mul_by_023`` (MNT4), ``mul_by_2345``
(MNT6), ``mul_by_014`` (BLS12's M-twist) and ``mul_by_034`` (its D-twist)
and the fixed-exponent powers.

An element of a degree-K tower is an int64 tensor [..., K, n_digits] whose K
components are in Montgomery form, sub-tower low component first.  Constants
(``one()``, ``const()``) are host numpy arrays; ``tensor(name, device)``
hands out cached device copies.

Launches: a Karatsuba product needs three products in the subfield, and
``QuadExtOps`` stacks them on a new axis [..., 3, sK, n_digits] and makes ONE
subfield product of the stack.  Over the base field that is one Montgomery
multiply of three rows; over Fq2 it is one Fq2 product of three elements,
i.e. one multiply of nine rows.  ``CubicExtOps`` does the same with the six
products of its Toom-style multiply: one multiply of six rows over the base
field, so that an Fq6 product is one Fq3 product of three elements, one
multiply of eighteen rows; over Fq2 one Fq2 product of six elements, so
that an Fq12 product is one Fq2 product of eighteen elements, one multiply
of 54 rows.  The BLS12 line multiplies and the Granger-Scott square put all
their Fq2 products (13 and 6) in one Fq2 product too.  Every Montgomery
product is canonical, so the values are those of the JAX package's
one-after-another calls, digit for digit, in a fraction of the launches.
Fixed exponents are host constants, so the power chains branch on the host
where the JAX package selects.

Frobenius maps: where every coefficient of every level lies in the base
field (the MNT towers, and BLS12-377's, whose happen to) x^(p^i) is one
componentwise scaling; BLS12-381's lie in Fq2, and there x^(p^i) is the
Fq2 Frobenius of every Fq2 component of x (a conjugation for odd i) times
one Fq2 constant per component, derived on the host from the levels'
tables: one Fq2 product.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp as fpmod
from .fp import FpParams
from . import host_ext
from ..ops.limbs import NP_DTYPE


class _FieldBase:
    """What every tower level shares: componentwise add/sub/neg and the
    predicates, all on [..., K, n_digits]."""

    fp: FpParams
    K: int

    def __init__(self):
        self._tensors = {}

    def zero(self) -> np.ndarray:
        return np.zeros((self.K, self.fp.n_digits), dtype=NP_DTYPE)

    def const(self, v) -> np.ndarray:
        """Host constant (nested ints, standard form) -> digits [K, n]."""
        vs = host_ext.flatten(v)
        if len(vs) != self.K:
            raise ValueError(f"expected {self.K} components, got {len(vs)}")
        return fpmod.fp_from_ints(self.fp, vs)

    def tensor(self, name: str, device, *args) -> torch.Tensor:
        """The host constant that method ``name`` returns for ``args``
        (``zero``, ``one``, ...) as a cached tensor on ``device``."""
        key = (name, args, str(device))
        hit = self._tensors.get(key)
        if hit is None:
            hit = torch.from_numpy(getattr(self, name)(*args)).to(device)
            self._tensors[key] = hit
        return hit

    def add(self, a, b):
        return fpmod.add_mod(self.fp, a, b)

    def sub(self, a, b):
        return fpmod.sub_mod(self.fp, a, b)

    def neg(self, a):
        return fpmod.neg_mod(self.fp, a)

    def double(self, a):
        return fpmod.add_mod(self.fp, a, a)

    def is_zero(self, a):
        return (a == 0).all(dim=(-1, -2))

    def eq(self, a, b):
        return (a == b).all(dim=(-1, -2))

    def scale_fp(self, a, s):
        """Multiply every component by the base-field element s [..., n]."""
        return fpmod.mont_mul(self.fp, a, s.unsqueeze(-2))

    # whether every Frobenius coefficient of this level and those below it
    # lies in the base field (then ``frob`` is a componentwise scaling)
    frob_in_base = True

    def frob_scale_ints(self, i: int) -> list:
        """Standard-form factors, one a component, by which ``frob(x, i)``
        multiplies x where ``frob_in_base``."""
        return [1] * self.K

    def frob_scale(self, i: int) -> np.ndarray:
        return fpmod.fp_from_ints(self.fp, self.frob_scale_ints(i))

    def frob_fq2_ints(self, i: int) -> list:
        """Where the coefficients lie in Fq2 (BLS12): the Fq2 constant, a
        pair of standard-form ints, by which ``frob(x, i)`` multiplies the
        Fq2 Frobenius of each Fq2 component of x."""
        return [[1, 0]]

    def frob_fq2(self, i: int) -> np.ndarray:
        return fpmod.fp_from_ints(self.fp, host_ext.flatten(
            self.frob_fq2_ints(i))).reshape(self.K // 2, 2, -1)

    def fq2(self):
        """The Fq2 at the bottom of this tower (BLS12's chunk field)."""
        f = self
        while f.K > 2:
            f = f.sf
        if f.K != 2 or not isinstance(f.sf, FpOps):
            raise NotImplementedError(f"{self.name}: no Fq2 at the bottom")
        return f

    def frob(self, x, i: int):
        """x^(p^i): one multiply by the per-component factors (none where
        they are all one), or over Fq2 components, their Frobenius and one
        Fq2 product by the constants."""
        i %= self.K
        if self.frob_in_base:
            if all(c == 1 for c in self.frob_scale_ints(i)):
                return x
            return fpmod.mont_mul(self.fp, x,
                                  self.tensor("frob_scale", x.device, i))
        f2 = self.fq2()
        y = f2.frob(x.unflatten(-2, (self.K // 2, 2)), i)
        if all(c == [1, 0] for c in self.frob_fq2_ints(i)):
            return y.flatten(-3, -2)
        return f2.mul(y, self.tensor("frob_fq2", x.device, i)).flatten(-3,
                                                                      -2)


def _check_frob(level, sub, tables):
    """Set ``level.frob_in_base`` from its Frobenius tables (flat subfield
    elements); coefficients outside the base field must be Fq2 values over
    an Fq2 at the bottom of the tower (BLS12's)."""
    coeffs = [c for t in tables for c in t]
    if any(len(c) != sub.K for c in coeffs):
        raise ValueError(f"{level.name}: Frobenius coefficients of "
                         f"{sub.K} components expected")
    level.frob_in_base = sub.frob_in_base and not any(
        any(c[1:]) for c in coeffs)
    if not level.frob_in_base:
        if any(any(c[2:]) for c in coeffs):
            raise NotImplementedError(
                f"{level.name}: Frobenius coefficients outside Fq2")
        level.fq2()


def _frob_fq2_parts(level, i: int, tables) -> list:
    """The Fq2 constants of ``level.frob(x, i)``, one an Fq2 component:
    the subfield's for the first part, times the part's coefficient (an
    Fq2 value) for each further part."""
    f2 = level.fq2()
    p, nr2 = level.fp.modulus, f2.nr_ints[0]
    sub = level.sf.frob_fq2_ints(i)
    out = list(sub)
    for t in tables:
        c = t[i % level.K][:2]
        out += [list(host_ext.quad_mul(p, nr2, u, c)) for u in sub]
    return out


class FpOps(_FieldBase):
    """Degree-1 'tower': the base prime field with a unit component axis."""

    def __init__(self, params: FpParams):
        super().__init__()
        self.fp = params
        self.K = 1
        self.name = params.name

    def one(self) -> np.ndarray:
        return np.asarray(self.fp.one_mont)[None, :]

    def mul(self, a, b):
        return fpmod.mont_mul(self.fp, a, b)

    def sqr(self, a):
        return fpmod.mont_mul(self.fp, a, a)

    def inv(self, a):
        return fpmod.inv_mod(self.fp, a)


class QuadExtOps(_FieldBase):
    """sub[Y]/(Y^2 - nonresidue): x = a0 + a1*Y as [..., 2*sub.K, n_digits],
    over the base field (Fq2) or over a quadratic extension (MNT4's Fq4).

    Where the nonresidue is the subfield's own generator X (Fq4 over Fq2:
    Y^2 = X), multiplying by it is a component rotation and one multiply by
    the subfield's nonresidue (``sf.mul_by_gen``), not a subfield product.
    """

    def __init__(self, name, sub, nonresidue_host, frob_c1_host):
        super().__init__()
        if not isinstance(sub, (FpOps, QuadExtOps, CubicExtOps)):
            raise TypeError(f"{name}: no tower over {type(sub).__name__}")
        self.name = name
        self.sf = sub
        self.fp = sub.fp
        self.K = 2 * sub.K
        self._nr_host = sub.const(nonresidue_host)           # [sK, n]
        self.nr_ints = [v % self.fp.modulus
                        for v in host_ext.flatten(nonresidue_host)]
        gen = [0] * sub.K
        if not isinstance(sub, FpOps):
            gen[sub.sf.K] = 1
        self.nr_is_sub_gen = not isinstance(sub, FpOps) and \
            host_ext.flatten(nonresidue_host) == gen
        self._nr_is_minus_one = isinstance(sub, FpOps) and \
            host_ext.flatten(nonresidue_host)[0] % self.fp.modulus == \
            self.fp.modulus - 1
        self._frob_c1 = [host_ext.flatten(c) for c in frob_c1_host]
        _check_frob(self, sub, [self._frob_c1])

    def one(self) -> np.ndarray:
        z = self.zero()
        z[: self.sf.K] = self.sf.one()
        return z

    def nonresidue(self) -> np.ndarray:
        return self._nr_host

    def frob_scale_ints(self, i: int) -> list:
        sub = self.sf.frob_scale_ints(i)
        c = self._frob_c1[i % self.K][0]
        return sub + [s * c % self.fp.modulus for s in sub]

    def frob_fq2_ints(self, i: int) -> list:
        if self.K == 2:
            return [[1, 0]]
        return _frob_fq2_parts(self, i, [self._frob_c1])

    # -- structure ------------------------------------------------------

    def _halves(self, x):
        k = self.sf.K
        return x[..., :k, :], x[..., k:, :]

    def _pair(self, x):
        """[..., K, n] -> [..., 2, sK, n]: the two subfield components on
        an axis of their own."""
        return x.unflatten(-2, (2, self.sf.K))

    def _stack(self, x):
        """(a0, a1, a0 + a1) as [..., 3, sK, n], the operands of a
        Karatsuba product's three subfield products."""
        a0, a1 = self._halves(x)
        return torch.cat([x, self.sf.add(a0, a1)],
                         dim=-2).unflatten(-2, (3, self.sf.K))

    def _karatsuba(self, v):
        """Products (v0, v1, t) [..., 3, sK, n] -> (v0 + nr*v1, t - v0 - v1)."""
        S = self.sf
        v0, v1, t = v.unbind(-3)
        c0 = S.add(v0, self.mul_by_nonresidue(v1))
        c1 = S.sub(S.sub(t, v0), v1)
        return torch.cat([c0, c1], dim=-2)

    # -- arithmetic -----------------------------------------------------

    def mul_by_nonresidue(self, a):
        """A subfield element times Y^2 (a negation where Y^2 = -1, as over
        BLS12-381's Fq2)."""
        if self.nr_is_sub_gen:
            return self.sf.mul_by_gen(a)
        if self._nr_is_minus_one:
            return self.sf.neg(a)
        return self.sf.mul(a, self.tensor("nonresidue", a.device))

    def mul_by_gen(self, x):
        """x * Y (the tower generator): (a0, a1) -> (nr*a1, a0)."""
        a0, a1 = self._halves(x)
        return torch.cat([self.mul_by_nonresidue(a1), a0], dim=-2)

    def mul(self, x, y):
        return self._karatsuba(self.sf.mul(self._stack(x), self._stack(y)))

    def sqr(self, x):
        return self._karatsuba(self.sf.sqr(self._stack(x)))

    def inv(self, x):
        S = self.sf
        pair = self._pair(x)
        sq = S.sqr(pair)                        # a0^2, a1^2
        norm = S.sub(sq[..., 0, :, :], self.mul_by_nonresidue(sq[..., 1, :, :]))
        xt = S.mul(pair, S.inv(norm).unsqueeze(-3))      # a0*t, a1*t
        return torch.cat([xt[..., 0, :, :], S.neg(xt[..., 1, :, :])], dim=-2)

    def conjugate(self, x):
        a0, a1 = self._halves(x)
        return torch.cat([a0, self.sf.neg(a1)], dim=-2)

    def mul_by_sub(self, x, s):
        """Multiply by a subfield element s [..., sK, n] (sparse)."""
        return self.sf.mul(self._pair(x), s.unsqueeze(-3)).flatten(-3, -2)

    # -- the cyclotomic subgroup (GT) -----------------------------------

    def cyclotomic_square(self, x):
        """Squaring of unitary elements (norm 1): Granger-Scott over
        BLS12's Fq12 (``_cyclotomic_square_gs``), elsewhere the quartic
        formula, two subfield squarings (one stacked product) instead of
        three."""
        S = self.sf
        if isinstance(S, CubicExtOps) and isinstance(S.sf, QuadExtOps):
            return self._cyclotomic_square_gs(x)
        a0, a1 = self._halves(x)
        sq = S.sqr(torch.stack([a1, S.add(a1, a0)], dim=-3))
        a = sq[..., 0, :, :]
        c = S.sub(sq[..., 1, :, :], a)
        d = self.mul_by_nonresidue(a)
        e = S.sub(c, d)
        one = S.tensor("one", x.device)
        return torch.cat([S.add(S.double(d), one), S.sub(e, one)], dim=-2)

    def _cyclotomic_square_gs(self, x):
        """Granger-Scott compressed squaring (fp12_2over3over2.rs:116-180):
        three Fp4-style squarings over the Fq2 pairs (z0, z1), (z2, z3),
        (z4, z5) of x = ((z0, z4, z3), (z2, z1, z5)), their six Fq2
        products in one."""
        fq6 = self.sf
        f2 = fq6.sf
        ch = x.unflatten(-2, (6, 2))              # Fq2 components
        za, zb = ch[..., [0, 3, 1], :, :], ch[..., [4, 2, 5], :, :]
        # tmp = za zb and (za + zb)(za + xi zb), all three pairs at once
        lhs = torch.cat([za, f2.add(za, zb)], dim=-3)
        rhs = torch.cat([zb, f2.add(za, fq6.mul_by_nonresidue(zb))], dim=-3)
        pr = f2.mul(lhs, rhs)
        tmp, big = pr[..., :3, :, :], pr[..., 3:, :, :]
        xi_tmp = fq6.mul_by_nonresidue(tmp)
        ta = f2.sub(f2.sub(big, tmp), xi_tmp)     # t0, t2, t4
        # 3 t - 2 z for (t0, z0), (t4, z3), (t2, z4); 3 t + 2 z for
        # (xi t5, z2), (t1, z1), (t3, z5), with t1, t3, t5 = 2 tmp
        u = ta[..., [0, 2, 1], :, :]
        m = f2.add(f2.double(f2.sub(u, ch[..., [0, 2, 1], :, :])), u)
        v = f2.double(torch.stack([xi_tmp[..., 2, :, :], tmp[..., 0, :, :],
                                   tmp[..., 1, :, :]], dim=-3))
        pl = f2.add(f2.double(f2.add(v, ch[..., 3:, :, :])), v)
        # ((nz0, nz4, nz3), (nz2, nz1, nz5))
        return torch.cat([m[..., [0, 2, 1], :, :], pl],
                         dim=-3).flatten(-3, -2)

    def _line_products(self, parts):
        """One subfield product of the stacked operand pairs ``parts``
        (lhs, rhs), each [..., k, sK, n] over a batch that broadcasts;
        returns the products split back into the parts' sizes."""
        batch = torch.broadcast_shapes(*(t.shape[:-3] for pr in parts
                                         for t in pr))
        lhs = torch.cat([l.expand(batch + l.shape[-3:]) for l, _ in parts],
                        dim=-3)
        rhs = torch.cat([r.expand(batch + l.shape[-3:]) for l, r in parts],
                        dim=-3)
        out = self.sf.sf.mul(lhs, rhs)
        return out.split([l.shape[-3] for l, _ in parts], dim=-3)

    def mul_by_014(self, x, c0, c1, c4):
        """x * (c0 + c1 V + c4 V W), c* in Fq2 [..., 2, n]: the M-twist
        BLS12 line (fp12_2over3over2.rs:95-114, BLS12-381), the Karatsuba
        shape of the JAX package: mul_by_01 of a and of a + b, mul_by_1 of
        b, their 13 Fq2 products in one."""
        fq6 = self.sf
        if not isinstance(fq6, CubicExtOps) or fq6.sf.K != 2:
            raise NotImplementedError("mul_by_014 is the Fq12 line shape")
        a_, b_ = self._halves(x)
        p01, p1 = self._line_products([
            fq6._by_01_pair(a_, fq6.add(a_, b_), (c0, c1),
                            (c0, fq6.sf.add(c1, c4))),
            (fq6._parts(b_)[..., [2, 0, 1], :, :], c4.unsqueeze(-3))])
        r = fq6._by_01_combine(p01.unflatten(-3, (2, 5)))
        aa, t = r[..., 0, :, :], r[..., 1, :, :]
        bb = torch.cat([fq6.mul_by_nonresidue(p1[..., 0, :, :]),
                        p1[..., 1, :, :], p1[..., 2, :, :]], dim=-2)
        return self._line_combine(aa, bb, t)

    def mul_by_034(self, x, c0, c3, c4):
        """x * (c0 + c3 W + c4 V W), c* in Fq2 [..., 2, n]: the D-twist
        BLS12 line (BLS12-377), the same Karatsuba shape with the roles
        flipped: a times c0, mul_by_01 of b and of a + b, their 13 Fq2
        products in one."""
        fq6 = self.sf
        if not isinstance(fq6, CubicExtOps) or fq6.sf.K != 2:
            raise NotImplementedError("mul_by_034 is the Fq12 line shape")
        a_, b_ = self._halves(x)
        pa, p01 = self._line_products([
            (fq6._parts(a_), c0.unsqueeze(-3)),
            fq6._by_01_pair(b_, fq6.add(a_, b_), (c3, c4),
                            (fq6.sf.add(c0, c3), c4))])
        r = fq6._by_01_combine(p01.unflatten(-3, (2, 5)))
        bb, t = r[..., 0, :, :], r[..., 1, :, :]
        return self._line_combine(pa.flatten(-3, -2), bb, t)

    def _line_combine(self, aa, bb, t):
        """(aa + nr bb, t - aa - bb): the Karatsuba tail of the lines."""
        fq6 = self.sf
        return torch.cat([fq6.add(self.mul_by_nonresidue(bb), aa),
                          fq6.sub(fq6.sub(t, aa), bb)], dim=-2)

    def mul_by_023(self, x, a, c1):
        """x * (c0 + c1*Y) with c0 = [a, 0], a in Fp: the MNT4 affine-line
        shape.  a: base-field digits [..., n]; c1: subfield element
        [..., sK, n].  v0 is a scaling by a, and v1 and the cross product
        are one stacked subfield product."""
        S = self.sf
        if not isinstance(S, QuadExtOps) or not isinstance(S.sf, FpOps):
            raise NotImplementedError("mul_by_023 is the Fq4 line shape")
        x0, x1 = self._halves(x)
        v0 = S.scale_fp(x0, a)
        # other.c0 + other.c1 = c1 with a added into its first Fp component
        oc = torch.cat([fpmod.add_mod(self.fp, c1[..., :1, :],
                                      a.unsqueeze(-2)), c1[..., 1:, :]],
                       dim=-2)
        v = S.mul(torch.stack(torch.broadcast_tensors(x1, S.add(x0, x1)),
                              dim=-3),
                  torch.stack(torch.broadcast_tensors(c1, oc), dim=-3))
        v1, t = v.unbind(-3)
        nc0 = S.add(v0, self.mul_by_nonresidue(v1))
        nc1 = S.sub(S.sub(t, v0), v1)
        return torch.cat([nc0, nc1], dim=-2)

    def mul_by_2345(self, x, a, c1, a_nr=None):
        """x * (c0 + c1*Y) with c0 = (0, 0, a) = a X^2, a in Fp: the MNT6
        affine-line shape.  a: base-field digits [..., n]; c1: subfield
        element [..., 3, n]; ``a_nr``: a*nr where the caller has it (a
        loop's lines share their a).  v0 = x0 * a X^2 is three base
        multiplies of one launch, and v1 and the cross product are one
        stacked Fq3 product."""
        S = self.sf
        if not isinstance(S, CubicExtOps) or not isinstance(S.sf, FpOps):
            raise NotImplementedError("mul_by_2345 is the Fq6 line shape")
        fp = self.fp
        x0, x1 = self._halves(x)
        if a_nr is None:
            a_nr = fpmod.mont_mul(fp, a, S.tensor("nonresidue", a.device)[0])
        # (b1 t, b2 t, b0 a) with t = a nr
        v0 = fpmod.mont_mul(fp, x0[..., [1, 2, 0], :],
                            torch.stack(torch.broadcast_tensors(
                                a_nr, a_nr, a), dim=-2))
        # other.c0 + other.c1 = c1 with a added into its last component
        oc = torch.cat([c1[..., :2, :], fpmod.add_mod(
            fp, c1[..., 2:, :], a.unsqueeze(-2))], dim=-2)
        v = S.mul(torch.stack(torch.broadcast_tensors(x1, S.add(x0, x1)),
                              dim=-3),
                  torch.stack(torch.broadcast_tensors(c1, oc), dim=-3))
        v1, t = v.unbind(-3)
        nc0 = S.add(v0, self.mul_by_nonresidue(v1))
        nc1 = S.sub(S.sub(t, v0), v1)
        return torch.cat([nc0, nc1], dim=-2)


class CubicExtOps(_FieldBase):
    """sub[X]/(X^3 - nonresidue): x = a0 + a1*X + a2*X^2 as
    [..., 3*sub.K, n_digits], the Toom-style products of the JAX package's
    ``CubicExtOps``: six subfield products a multiply, stacked into ONE
    subfield product of six elements.  Over the base field (MNT6's Fq3)
    or over Fq2 (BLS12's Fq6, X^3 = xi in Fq2, Frobenius coefficients in
    Fq2)."""

    def __init__(self, name, sub, nonresidue_host, frob_c1_host,
                 frob_c2_host):
        super().__init__()
        self.name = name
        self.sf = sub
        self.fp = sub.fp
        self.K = 3 * sub.K
        self._nr_host = sub.const(nonresidue_host)           # [sK, n]
        self.nr_ints = [v % self.fp.modulus
                        for v in host_ext.flatten(nonresidue_host)]
        gen = [0] * sub.K
        if not isinstance(sub, FpOps):
            gen[sub.sf.K] = 1
        # xi = X, the subfield's generator (BLS12-377: (0, 1)), or 1 + X
        # (BLS12-381: (1, 1)): a rotation and one multiply by the
        # subfield's nonresidue, and an addition for the second
        self._nr_kind = "generic" if isinstance(sub, FpOps) else \
            "gen" if self.nr_ints == gen else \
            "one_plus_gen" if self.nr_ints == [1] + gen[1:] else "generic"
        self._c1 = [host_ext.flatten(c) for c in frob_c1_host]
        self._c2 = [host_ext.flatten(c) for c in frob_c2_host]
        _check_frob(self, sub, [self._c1, self._c2])
        self._frob = [(c1[0], c2[0]) for c1, c2 in zip(self._c1, self._c2)]

    def one(self) -> np.ndarray:
        z = self.zero()
        z[: self.sf.K] = self.sf.one()
        return z

    def nonresidue(self) -> np.ndarray:
        return self._nr_host

    def frob_scale_ints(self, i: int) -> list:
        sub = self.sf.frob_scale_ints(i)
        c1, c2 = self._frob[i % self.K]
        p = self.fp.modulus
        return sub + [s * c1 % p for s in sub] + [s * c2 % p for s in sub]

    def frob_fq2_ints(self, i: int) -> list:
        return _frob_fq2_parts(self, i, [self._c1, self._c2])

    # -- structure ------------------------------------------------------

    def _parts(self, x):
        """[..., K, n] -> [..., 3, sK, n]."""
        return x.unflatten(-2, (3, self.sf.K))

    def _toom(self, x):
        """(a0, a1, a2, a1 + a2, a0 + a1, a0 + a2) as [..., 6, sK, n]: the
        operands of the six subfield products, the sums in one launch."""
        a = self._parts(x)
        sums = self.sf.add(a[..., [1, 0, 0], :, :], a[..., [2, 1, 2], :, :])
        return torch.cat([a, sums], dim=-3)

    def _combine(self, v):
        """Products (v0, v1, v2, t12, t01, t02) [..., 6, sK, n] ->
        (v0 + nr (t12 - v1 - v2), t01 - v0 - v1 + nr v2, t02 - v0 - v2 +
        v1)."""
        S = self.sf
        d = S.sub(S.sub(v[..., 3:, :, :], v[..., [1, 0, 0], :, :]),
                  v[..., [2, 1, 2], :, :])
        nr = self.mul_by_nonresidue(torch.stack(
            [d[..., 0, :, :], v[..., 2, :, :]], dim=-3))
        out = S.add(torch.stack([v[..., 0, :, :], d[..., 1, :, :],
                                 d[..., 2, :, :]], dim=-3),
                    torch.cat([nr, v[..., 1:2, :, :]], dim=-3))
        return out.flatten(-3, -2)

    # -- arithmetic -----------------------------------------------------

    def mul_by_nonresidue(self, a):
        """A subfield element (or a stack of them) times X^3."""
        if self._nr_kind == "gen":
            return self.sf.mul_by_gen(a)
        if self._nr_kind == "one_plus_gen":
            return self.sf.add(a, self.sf.mul_by_gen(a))
        return self.sf.mul(a, self.tensor("nonresidue", a.device))

    def mul_by_gen(self, x):
        """x * X (the tower generator): (a0, a1, a2) -> (nr*a2, a0, a1)."""
        a = self._parts(x)
        return torch.cat([self.mul_by_nonresidue(a[..., 2, :, :]),
                          a[..., 0, :, :], a[..., 1, :, :]], dim=-2)

    def mul(self, x, y):
        x, y = torch.broadcast_tensors(x, y)
        st = self._toom(torch.stack([x, y]))
        return self._combine(self.sf.mul(st[0], st[1]))

    def sqr(self, x):
        st = self._toom(x)
        return self._combine(self.sf.sqr(st))

    def inv(self, x):
        S = self.sf
        a = self._parts(x)
        # a0^2, a1 a2, a2^2, a0 a1, a0 a2, a1^2 in one product
        pr = S.mul(a[..., [0, 1, 2, 0, 0, 1], :, :],
                   a[..., [0, 2, 2, 1, 2, 1], :, :])
        nr = self.mul_by_nonresidue(pr[..., 1:3, :, :])
        # s0 = a0^2 - nr a1 a2, s1 = nr a2^2 - a0 a1, s2 = a1^2 - a0 a2
        s_ = S.sub(torch.stack([pr[..., 0, :, :], nr[..., 1, :, :],
                                pr[..., 5, :, :]], dim=-3),
                   torch.stack([nr[..., 0, :, :], pr[..., 3, :, :],
                                pr[..., 4, :, :]], dim=-3))
        q = S.mul(a[..., [0, 2, 1], :, :], s_)    # a0 s0, a2 s1, a1 s2
        norm = S.add(q[..., 0, :, :], self.mul_by_nonresidue(
            S.add(q[..., 1, :, :], q[..., 2, :, :])))
        return S.mul(s_, S.inv(norm).unsqueeze(-3)).flatten(-3, -2)

    def mul_by_sub(self, x, s):
        """Multiply by a subfield element s [..., sK, n] (sparse)."""
        return self.sf.mul(self._parts(x), s.unsqueeze(-3)).flatten(-3, -2)

    def _by_01_operands(self, x, b0, b1):
        """The five subfield products of x * (b0 + b1 X) as operand stacks
        [..., 5, sK, n]: a0 b0, a1 b1, (a1 + a2) b1, (a0 + a1)(b0 + b1),
        (a0 + a2) b0."""
        S = self.sf
        a = self._parts(x)
        sums = S.add(a[..., [1, 0, 0], :, :], a[..., [2, 1, 2], :, :])
        b0, b1 = torch.broadcast_tensors(b0, b1)
        return (torch.cat([a[..., :2, :, :], sums], dim=-3),
                torch.stack([b0, b1, b1, S.add(b0, b1), b0], dim=-3))

    def _by_01_pair(self, x, y, bx, by):
        """The operands of x * (bx0 + bx1 X) and y * (by0 + by1 X) as one
        stack of ten products [..., 10, sK, n] each side."""
        def st(u, v):
            return torch.stack(torch.broadcast_tensors(u, v), dim=-3)
        lhs, rhs = self._by_01_operands(st(x, y), st(bx[0], by[0]),
                                        st(bx[1], by[1]))
        return lhs.flatten(-4, -3), rhs.flatten(-4, -3)

    def _by_01_combine(self, pr):
        """The five products [..., 5, sK, n] -> x * (b0 + b1 X)."""
        S = self.sf
        aa, bb, t12, t01, t02 = pr.unbind(-3)
        c0 = S.add(self.mul_by_nonresidue(S.sub(t12, bb)), aa)
        c1 = S.sub(S.sub(t01, aa), bb)
        c2 = S.add(S.sub(t02, aa), bb)
        return torch.cat([c0, c1, c2], dim=-2)

    def mul_by_01(self, x, b0, b1):
        """x * (b0 + b1*X), b0, b1 in the subfield: five subfield products,
        one stacked product."""
        lhs, rhs = self._by_01_operands(x, b0, b1)
        return self._by_01_combine(self.sf.mul(lhs, rhs))

    def mul_by_1(self, x, b1):
        """x * (b1*X), b1 in the subfield: three subfield products."""
        pr = self.sf.mul(self._parts(x)[..., [2, 0, 1], :, :],
                         b1.unsqueeze(-3))
        return torch.cat([self.mul_by_nonresidue(pr[..., 0, :, :]),
                          pr[..., 1, :, :], pr[..., 2, :, :]], dim=-2)


# ---------------------------------------------------------------------------
# generic helpers on any tower
# ---------------------------------------------------------------------------

def ext_pow_const(ops, x, exp_bits):
    """x^e for a fixed exponent given as bits, MSB first: square and
    multiply from the leading one, the multiply only where the bit is set."""
    bits = [int(b) for b in np.asarray(exp_bits).reshape(-1)]
    if 1 not in bits:
        return ops.tensor("one", x.device).expand(x.shape).clone()
    r = x
    for b in bits[bits.index(1) + 1:]:
        r = ops.sqr(r)
        if b:
            r = ops.mul(r, x)
    return r


def _wnaf_digits_msb(e: int):
    """Signed NAF digits of e >= 1, MSB first (find_wnaf, biginteger)."""
    digs = []
    while e:
        if e & 1:
            d = 2 - (e & 3)
            e -= d
        else:
            d = 0
        digs.append(d)
        e >>= 1
    return list(reversed(digs))


def ext_cyclotomic_pow_const(ops, x, e: int):
    """x^e for unitary x (GT): NAF digits with cyclotomic squarings and the
    free conjugate inverse, a multiply only at the non-zero digits."""
    if e == 0:
        return ops.tensor("one", x.device).expand(x.shape).clone()
    digs = _wnaf_digits_msb(e)
    x_inv = ops.conjugate(x) if min(digs) < 0 else None
    r = x
    for d in digs[1:]:
        r = ops.cyclotomic_square(r)
        if d:
            r = ops.mul(r, x if d > 0 else x_inv)
    return r


def ext_product(ops, f_batch):
    """The product of f_batch [k, ..., K, nd] along axis 0: a tree of
    products, one ``ops.mul`` a level (the pairings' product of Miller
    values)."""
    cur = f_batch
    while cur.shape[0] > 1:
        if cur.shape[0] % 2:
            cur = torch.cat([cur, ops.tensor("one", cur.device).expand(
                (1,) + cur.shape[1:])], dim=0)
        cur = ops.mul(cur[0::2], cur[1::2])
    return cur[0]


def ext_batch_inverse_tree(ops, a):
    """Invert a flat batch [N, K, nd] with ~3N multiplies and ONE field
    inversion: pairwise products up a log-depth tree, ``ops.inv`` at the
    root, inverses pushed back down.  Zeros pass through as zeros."""
    n = a.shape[0]
    zero_mask = ops.is_zero(a)[:, None, None]
    one = ops.tensor("one", a.device)
    x = torch.where(zero_mask, one, a)

    n2 = 1 << max(0, (n - 1).bit_length())
    if n2 != n:
        x = torch.cat([x, one.expand(n2 - n, -1, -1)], dim=0)

    levels = [x]
    cur = x
    while cur.shape[0] > 1:
        cur = ops.mul(cur[0::2], cur[1::2])
        levels.append(cur)

    inv = ops.inv(levels[-1])  # [1, K, nd]
    for child in reversed(levels[:-1]):
        left, right = child[0::2], child[1::2]
        inv = torch.stack([ops.mul(inv, right), ops.mul(inv, left)],
                          dim=1).reshape(child.shape)
    return torch.where(zero_mask, torch.zeros_like(a), inv[:n])


def ext_to_ints(ops, x) -> list:
    """One element [K, n] (tensor or array) -> list of K standard-form
    ints."""
    return fpmod.fp_to_ints(ops.fp, x.reshape(ops.K, ops.fp.n_digits))


# ---------------------------------------------------------------------------
# the towers of the concrete parameter sets
# ---------------------------------------------------------------------------

def build_quadratic_tower(fq_params: FpParams, nr2: int):
    """Fq -> Fq2 (X^2 = nr2): the part of the MNT4 and BLS12 towers that the
    G1/G2 arithmetic uses.  Returns (base, fq2)."""
    base = FpOps(fq_params)
    fq2 = QuadExtOps(f"{fq_params.name}2", base, nr2,
                     host_ext.frob_table_fp2(fq_params.modulus, nr2))
    return base, fq2


def build_bls12_towers(fq_params: FpParams, nr2: int, xi):
    """BLS12 tower Fq -> Fq2 (X^2 = nr2) -> Fq6 (V^3 = xi) -> Fq12 (W^2 =
    V); Fq12's nonresidue V is (0, 0, 1, 0, 0, 0) in flat Fq6 components
    and its Frobenius coefficients are Fq2 values embedded as (c, 0, 0).
    Returns (base, fq2, fq6, fq12)."""
    p = fq_params.modulus
    base, fq2 = build_quadratic_tower(fq_params, nr2)
    c1, c2 = host_ext.frob_table_fp6_3over2(p, nr2, xi)
    fq6 = CubicExtOps(f"{fq_params.name}6", fq2, list(xi),
                      [list(c) for c in c1], [list(c) for c in c2])
    fq12 = QuadExtOps(f"{fq_params.name}12", fq6, [0, 0, 1, 0, 0, 0],
                      [[list(c), [0, 0], [0, 0]] for c in
                       host_ext.frob_table_fp12(p, nr2, xi)])
    return base, fq2, fq6, fq12


def build_mnt4_towers(fq_params: FpParams, nr2: int):
    """MNT4-style tower Fq -> Fq2 (X^2 = nr2) -> Fq4 (Y^2 = X); Fq4's
    Frobenius coefficients are base-field values embedded as (c, 0).
    Returns (base, fq2, fq4)."""
    base, fq2 = build_quadratic_tower(fq_params, nr2)
    fq4 = QuadExtOps(f"{fq_params.name}4", fq2, [0, 1],
                     [[c, 0] for c in host_ext.frob_table_fp4(
                         fq_params.modulus, nr2)])
    return base, fq2, fq4


def build_mnt6_towers(fq_params: FpParams, nr3: int):
    """MNT6-style tower Fq -> Fq3 (X^3 = nr3) -> Fq6 (Y^2 = X); Fq6's
    Frobenius coefficients are base-field values embedded as (c, 0, 0).
    Returns (base, fq3, fq6)."""
    p = fq_params.modulus
    base = FpOps(fq_params)
    fq3 = CubicExtOps(f"{fq_params.name}3", base, nr3,
                      *host_ext.frob_table_fp3(p, nr3))
    fq6 = QuadExtOps(f"{fq_params.name}6", fq3, [0, 1, 0],
                     [[c, 0, 0] for c in host_ext.frob_table_fp6_2over3(
                         p, nr3)])
    return base, fq3, fq6
