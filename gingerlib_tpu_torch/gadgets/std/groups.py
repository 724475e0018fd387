"""Short-Weierstrass group gadgets over any field gadget tower
(r1cs/gadgets/std/src/groups/curves/short_weierstrass/*); counterpart of
``gingerlib_tpu/gadgets/std/groups.py``.

Affine coordinates with the reference's incomplete-addition formulas:
  add:    λ·(x2−x1) = y2−y1 ;  x3 = λ²−x1−x2 ;  y3 = λ(x1−x3)−y1
  double: λ·2y = 3x²+a     ;  x3 = λ²−2x    ;  y3 = λ(x−x3)−y
Incompleteness (x1 == x2 cases) is the caller's responsibility, exactly as
in the reference (the Schnorr/verifier gadgets use generator offsets to
dodge the exceptional cases, field_based_schnorr.rs:136-141).
"""

from __future__ import annotations

from .boolean import Boolean


class AffinePointG:
    """(x, y) with components as ext-field gadget element lists."""

    __slots__ = ("x", "y")

    def __init__(self, x, y):
        self.x = x
        self.y = y


class SWGroupGadget:
    def __init__(self, fops, a_host, b_host):
        """fops: field gadget ops (FpGOps / QuadExtG / CubicExtG);
        a_host/b_host: curve coefficients as host component lists."""
        self.F = fops
        self.a = a_host
        self.b = b_host

    # -- allocation --

    def alloc(self, cs, xy=None, name="pt") -> AffinePointG:
        x = self.F.alloc(cs, None if xy is None else xy[0], f"{name}/x")
        y = self.F.alloc(cs, None if xy is None else xy[1], f"{name}/y")
        return AffinePointG(x, y)

    def alloc_input(self, cs, xy=None, name="pt") -> AffinePointG:
        x = self.F.alloc_input(cs, None if xy is None else xy[0], f"{name}/x")
        y = self.F.alloc_input(cs, None if xy is None else xy[1],
                               f"{name}/y")
        return AffinePointG(x, y)

    def constant(self, cs, xy, name="cpt") -> AffinePointG:
        return AffinePointG(self.F.const(cs, xy[0]), self.F.const(cs, xy[1]))

    def alloc_checked(self, cs, xy=None, name="pt") -> AffinePointG:
        p = self.alloc(cs, xy, name)
        self.enforce_on_curve(cs, p, f"{name}/on_curve")
        return p

    # -- predicates / checks --

    def enforce_on_curve(self, cs, p: AffinePointG, name="on_curve"):
        F = self.F
        y2 = F.sqr(cs, p.y, f"{name}/y2")
        x2 = F.sqr(cs, p.x, f"{name}/x2")
        x3 = F.mul(cs, x2, p.x, f"{name}/x3")
        rhs = F.add(cs, F.add(cs, x3, F.mul_by_const(cs, p.x, self.a)),
                    F.const(cs, self.b))
        F.enforce_equal(cs, y2, rhs, name)

    def enforce_equal(self, cs, p, q, name="pt_eq"):
        self.F.enforce_equal(cs, p.x, q.x, f"{name}/x")
        self.F.enforce_equal(cs, p.y, q.y, f"{name}/y")

    def neg(self, cs, p: AffinePointG) -> AffinePointG:
        return AffinePointG(p.x, self.F.neg(cs, p.y))

    def cond_select(self, cs, cond: Boolean, p, q, name="sel"):
        return AffinePointG(
            self.F.cond_select(cs, cond, p.x, q.x, f"{name}/x"),
            self.F.cond_select(cs, cond, p.y, q.y, f"{name}/y"))

    # -- group law (incomplete) --

    def _value_known(self, p: AffinePointG):
        return all(w.value is not None for w in p.x + p.y)

    def _host_values(self, p: AffinePointG):
        return ([w.value for w in p.x], [w.value for w in p.y])

    def add(self, cs, p: AffinePointG, q: AffinePointG,
            name="add") -> AffinePointG:
        F = self.F
        lam_val = x3_val = y3_val = None
        if self._value_known(p) and self._value_known(q):
            lam_val, x3_val, y3_val = self._host_add(p, q)
        lam = F.alloc(cs, lam_val, f"{name}/lambda")
        dx = F.sub(cs, q.x, p.x)
        dy = F.sub(cs, q.y, p.y)
        self._ext_mul_equals(cs, lam, dx, dy, f"{name}/slope")
        x3 = F.alloc(cs, x3_val, f"{name}/x3")
        lam2 = F.sqr(cs, lam, f"{name}/lam2")
        F.enforce_equal(cs, lam2,
                        F.add(cs, F.add(cs, x3, p.x), q.x), f"{name}/x3c")
        y3 = F.alloc(cs, y3_val, f"{name}/y3")
        self._ext_mul_equals(cs, lam, F.sub(cs, p.x, x3),
                             F.add(cs, y3, p.y), f"{name}/y3c")
        return AffinePointG(x3, y3)

    def double(self, cs, p: AffinePointG, name="dbl") -> AffinePointG:
        F = self.F
        lam_val = x3_val = y3_val = None
        if self._value_known(p):
            lam_val, x3_val, y3_val = self._host_double(p)
        lam = F.alloc(cs, lam_val, f"{name}/lambda")
        x2 = F.sqr(cs, p.x, f"{name}/x2")
        three_x2_a = F.add(cs, F.add(cs, F.double(cs, x2), x2),
                           F.const(cs, self.a))
        self._ext_mul_equals(cs, lam, F.double(cs, p.y), three_x2_a,
                             f"{name}/slope")
        x3 = F.alloc(cs, x3_val, f"{name}/x3")
        lam2 = F.sqr(cs, lam, f"{name}/lam2")
        F.enforce_equal(cs, lam2, F.add(cs, x3, F.double(cs, p.x)),
                        f"{name}/x3c")
        y3 = F.alloc(cs, y3_val, f"{name}/y3")
        self._ext_mul_equals(cs, lam, F.sub(cs, p.x, x3),
                             F.add(cs, y3, p.y), f"{name}/y3c")
        return AffinePointG(x3, y3)

    def _ext_mul_equals(self, cs, a, b, c, name):
        """enforce a*b == c in the ext field (mul + equality, saving the
        output allocation when possible)."""
        prod = self.F.mul(cs, a, b, f"{name}/prod")
        self.F.enforce_equal(cs, prod, c, f"{name}/eq")

    # -- host-side mirrors for witness computation --

    def _host_add(self, p, q):
        xv, yv = self._host_values(p)
        xq, yq = self._host_values(q)
        lam = self._hdiv(self._hsub(yq, yv), self._hsub(xq, xv))
        x3 = self._hsub(self._hsub(self._hsqr(lam), xv), xq)
        y3 = self._hsub(self._hmulv(lam, self._hsub(xv, x3)), yv)
        return lam, x3, y3

    def _host_double(self, p):
        xv, yv = self._host_values(p)
        num = self._hadd(self._hscale(self._hsqr(xv), 3), self._aval())
        lam = self._hdiv(num, self._hscale(yv, 2))
        x3 = self._hsub(self._hsqr(lam), self._hscale(xv, 2))
        y3 = self._hsub(self._hmulv(lam, self._hsub(xv, x3)), yv)
        return lam, x3, y3

    # host ext arithmetic on flat component lists
    def _p(self):
        return self.F.field.modulus

    def _aval(self):
        from .ext_fields import _flatten
        return [v % self._p() for v in _flatten(self.a)]

    def _hadd(self, u, v):
        return [(a + b) % self._p() for a, b in zip(u, v)]

    def _hsub(self, u, v):
        return [(a - b) % self._p() for a, b in zip(u, v)]

    def _hscale(self, u, k):
        return [a * k % self._p() for a in u]

    def _hmulv(self, u, v):
        return _host_ext_mul(self.F, u, v)

    def _hsqr(self, u):
        return _host_ext_mul(self.F, u, u)

    def _hdiv(self, u, v):
        return _host_ext_mul(self.F, u, _host_ext_inv(self.F, v))

    # -- scalar multiplication over booleans --

    def mul_bits(self, cs, base: AffinePointG, acc: AffinePointG, bits_lsb,
                 name="mulbits") -> AffinePointG:
        """Variable-base: acc + Σ bit_i·2^i·base with an in-circuit doubling
        chain (GroupGadget::mul_bits, groups/mod.rs:76-95).  acc must not be
        the identity; exceptional additions are the caller's concern."""
        power = base
        result = acc
        for i, bit in enumerate(bits_lsb):
            added = self.add(cs, result, power, f"{name}/add{i}")
            result = self.cond_select(cs, bit, added, result,
                                      f"{name}/sel{i}")
            if i + 1 < len(bits_lsb):
                power = self.double(cs, power, f"{name}/dbl{i}")
        return result

    def mul_bits_const_base(self, cs, base_xy, bits_lsb, acc: AffinePointG,
                            name="mulbits") -> AffinePointG:
        """acc + Σ bit_i · 2^i · base  with a *constant* base: the doubling
        chain is host-side; per bit one constant-point add + select
        (GroupGadget::mul_bits, groups/mod.rs:76-95)."""
        cur = [v % self._p() for v in _flatten_xy(base_xy[0])], \
              [v % self._p() for v in _flatten_xy(base_xy[1])]
        result = acc
        for i, bit in enumerate(bits_lsb):
            cpt = self.constant(cs, cur)
            added = self.add(cs, result, cpt, f"{name}/add{i}")
            result = self.cond_select(cs, bit, added, result,
                                      f"{name}/sel{i}")
            cur = _host_point_double(self, cur)
        return result


def _flatten_xy(v):
    from .ext_fields import _flatten
    return _flatten(v)


def _host_ext_mul(F, u, v):
    """multiply flat component lists in F's tower (host ints)."""
    from .ext_fields import FpGOps, QuadExtG, CubicExtG, _flatten
    p = F.field.modulus
    if isinstance(F, FpGOps):
        return [u[0] * v[0] % p]
    k = F.sf.K
    if isinstance(F, QuadExtG):
        a0, a1 = u[:k], u[k:]
        b0, b1 = v[:k], v[k:]
        nr = _flatten(F.nr)
        v0 = _host_ext_mul(F.sf, a0, b0)
        v1 = _host_ext_mul(F.sf, a1, b1)
        nr_v1 = _host_ext_mul_const(F.sf, v1, nr)
        c0 = [(x + y) % p for x, y in zip(v0, nr_v1)]
        t = _host_ext_mul(F.sf, [(x + y) % p for x, y in zip(a0, a1)],
                          [(x + y) % p for x, y in zip(b0, b1)])
        c1 = [(x - y - z) % p for x, y, z in zip(t, v0, v1)]
        return c0 + c1
    assert isinstance(F, CubicExtG)
    a0, a1, a2 = u[:k], u[k:2 * k], u[2 * k:]
    b0, b1, b2 = v[:k], v[k:2 * k], v[2 * k:]
    nr = _flatten(F.nr)
    m = lambda x, y: _host_ext_mul(F.sf, x, y)
    addl = lambda x, y: [(i + j) % p for i, j in zip(x, y)]
    subl = lambda x, y: [(i - j) % p for i, j in zip(x, y)]
    v0, v1, v2 = m(a0, b0), m(a1, b1), m(a2, b2)
    t12 = m(addl(a1, a2), addl(b1, b2))
    c0 = addl(v0, _host_ext_mul_const(F.sf, subl(subl(t12, v1), v2), nr))
    t01 = m(addl(a0, a1), addl(b0, b1))
    c1 = addl(subl(subl(t01, v0), v1), _host_ext_mul_const(F.sf, v2, nr))
    t02 = m(addl(a0, a2), addl(b0, b2))
    c2 = addl(subl(subl(t02, v0), v2), v1)
    return c0 + c1 + c2


def _host_ext_mul_const(F, u, k):
    return _host_ext_mul(F, u, [x % F.field.modulus for x in
                                (k if isinstance(k, list) else [k])])


def _host_ext_inv(F, u):
    from .ext_fields import FpGOps, QuadExtG, CubicExtG, _flatten
    p = F.field.modulus
    if isinstance(F, FpGOps):
        return [pow(u[0], -1, p)]
    k = F.sf.K
    if isinstance(F, QuadExtG):
        a0, a1 = u[:k], u[k:]
        nr = _flatten(F.nr)
        norm = [(x - y) % p for x, y in zip(
            _host_ext_mul(F.sf, a0, a0),
            _host_ext_mul_const(F.sf, _host_ext_mul(F.sf, a1, a1), nr))]
        t = _host_ext_inv(F.sf, norm)
        return _host_ext_mul(F.sf, a0, t) + \
            [(-x) % p for x in _host_ext_mul(F.sf, a1, t)]
    assert isinstance(F, CubicExtG)
    a0, a1, a2 = u[:k], u[k:2 * k], u[2 * k:]
    nr = _flatten(F.nr)
    m = lambda x, y: _host_ext_mul(F.sf, x, y)
    subl = lambda x, y: [(i - j) % p for i, j in zip(x, y)]
    addl = lambda x, y: [(i + j) % p for i, j in zip(x, y)]
    mc = lambda x: _host_ext_mul_const(F.sf, x, nr)
    s0 = subl(m(a0, a0), mc(m(a1, a2)))
    s1 = subl(mc(m(a2, a2)), m(a0, a1))
    s2 = subl(m(a1, a1), m(a0, a2))
    norm = addl(m(a0, s0), mc(addl(m(a2, s1), m(a1, s2))))
    t = _host_ext_inv(F.sf, norm)
    return m(s0, t) + m(s1, t) + m(s2, t)


def _host_point_double(gadget: SWGroupGadget, xy):
    """host affine doubling for constant-base chains."""
    F = gadget.F
    p = gadget._p()
    x, y = xy
    num = gadget._hadd(gadget._hscale(_host_ext_mul(F, x, x), 3),
                       gadget._aval())
    lam = _host_ext_mul(F, num, _host_ext_inv(F, gadget._hscale(y, 2)))
    x3 = gadget._hsub(_host_ext_mul(F, lam, lam), gadget._hscale(x, 2))
    y3 = gadget._hsub(_host_ext_mul(F, lam, gadget._hsub(x, x3)), y)
    return (x3, y3)
