"""Extension-field towers as batched flat component tensors.

Counterpart of ``gingerlib_tpu/fields/towers.py``, as far as the port's paths
need it: the base field with a unit component axis (``FpOps``), the
quadratic extension (``QuadExtOps``) and the cubic one (``CubicExtOps``):
Fq2, which carries G2 of MNT4-753 and BLS12-377, and MNT4's Fq4 =
Fq2[Y]/(Y^2 - X), which carries its pairing's GT; Fq3, which carries G2 of
MNT6-753, and MNT6's Fq6 = Fq3[Y]/(Y^2 - X), its GT; with the cyclotomic
square, the sparse line multiplies ``mul_by_023`` (MNT4) and
``mul_by_2345`` (MNT6) and the fixed-exponent powers.  BLS12's Fq6/Fq12
(a cubic tower over Fq2, whose Frobenius coefficients are not base-field
values) and their line shapes are not ported yet.

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
multiply of eighteen rows.  Every Montgomery product is canonical, so
the values are those of the JAX package's one-after-another calls, digit for
digit, in a fraction of the launches.  Fixed exponents are host constants,
so the power chains branch on the host where the JAX package selects.
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

    def frob_scale_ints(self, i: int) -> list:
        """Standard-form factors, one a component, by which ``frob(x, i)``
        multiplies x: every Frobenius map of the ported towers is such a
        componentwise scaling."""
        return [1] * self.K

    def frob_scale(self, i: int) -> np.ndarray:
        return fpmod.fp_from_ints(self.fp, self.frob_scale_ints(i))

    def frob(self, x, i: int):
        """x^(p^i): one multiply by the per-component factors, none where
        they are all one."""
        i %= self.K
        if all(c == 1 for c in self.frob_scale_ints(i)):
            return x
        return fpmod.mont_mul(self.fp, x,
                              self.tensor("frob_scale", x.device, i))


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
        gen = [0] * sub.K
        if not isinstance(sub, FpOps):
            gen[sub.sf.K] = 1
        self.nr_is_sub_gen = not isinstance(sub, FpOps) and \
            host_ext.flatten(nonresidue_host) == gen
        self._frob_c1 = [host_ext.flatten(c) for c in frob_c1_host]
        for c in self._frob_c1:
            if len(c) != sub.K or any(c[1:]):
                raise NotImplementedError(
                    "Frobenius coefficients outside the base field")

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
        """A subfield element times Y^2."""
        if self.nr_is_sub_gen:
            return self.sf.mul_by_gen(a)
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
        """Squaring of unitary elements (norm 1): the quartic formula, two
        subfield squarings (one stacked product) instead of three."""
        S = self.sf
        a0, a1 = self._halves(x)
        sq = S.sqr(torch.stack([a1, S.add(a1, a0)], dim=-3))
        a = sq[..., 0, :, :]
        c = S.sub(sq[..., 1, :, :], a)
        d = self.mul_by_nonresidue(a)
        e = S.sub(c, d)
        one = S.tensor("one", x.device)
        return torch.cat([S.add(S.double(d), one), S.sub(e, one)], dim=-2)

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
    subfield product of six elements.  Its Frobenius maps need
    coefficients in the base field, as MNT6's Fq3 has them; BLS12's Fq6
    over Fq2 is not ported."""

    def __init__(self, name, sub, nonresidue_host, frob_c1_host,
                 frob_c2_host):
        super().__init__()
        self.name = name
        self.sf = sub
        self.fp = sub.fp
        self.K = 3 * sub.K
        self._nr_host = sub.const(nonresidue_host)           # [sK, n]
        self._frob = []
        for c1, c2 in zip(frob_c1_host, frob_c2_host):
            c1, c2 = host_ext.flatten(c1), host_ext.flatten(c2)
            if any(c1[1:]) or any(c2[1:]) or len(c1) != sub.K:
                raise NotImplementedError(
                    "Frobenius coefficients outside the base field")
            self._frob.append((c1[0], c2[0]))

    def one(self) -> np.ndarray:
        z = self.zero()
        z[: self.sf.K] = self.sf.one()
        return z

    def nonresidue(self) -> np.ndarray:
        return self._nr_host

    def frob_scale_ints(self, i: int) -> list:
        sub = self.sf.frob_scale_ints(i)
        c1, c2 = self._frob[i % 3]
        p = self.fp.modulus
        return sub + [s * c1 % p for s in sub] + [s * c2 % p for s in sub]

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

    def mul_by_01(self, x, b0, b1):
        """x * (b0 + b1*X), b0, b1 in the subfield: five subfield products,
        one stacked product."""
        S = self.sf
        a0, a1, a2 = self._parts(x).unbind(-3)
        pr = S.mul(torch.stack([a0, a1, S.add(a1, a2), S.add(a0, a1),
                                S.add(a0, a2)], dim=-3),
                   torch.stack(torch.broadcast_tensors(
                       b0, b1, b1, S.add(b0, b1), b0), dim=-3))
        aa, bb, t12, t01, t02 = pr.unbind(-3)
        c0 = S.add(self.mul_by_nonresidue(S.sub(t12, bb)), aa)
        c1 = S.sub(S.sub(t01, aa), bb)
        c2 = S.add(S.sub(t02, aa), bb)
        return torch.cat([c0, c1, c2], dim=-2)

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
