"""Host (python-int) MNT and BLS12 ate pairings: the exact oracles of the
port's pairings.

Counterpart of ``gingerlib_tpu/curves/pairing_host.py`` (``HostMNTPairing``,
``host_mnt4753_pairing``, ``host_mnt6753_pairing``, ``host_sw6_pairing``,
``host_mnt6298_pairing``; ``HostBls12Pairing``,
``host_bls12_377_pairing``, ``host_bls12_381_pairing``): the reference's
affine Miller ladder (mnt4/mod.rs:100-224, mnt6/mod.rs) and its BLS12 loop
over homogeneous-projective G2 lines (bls12/g2.rs, bls12/mod.rs), both over
the host tower arithmetic of ``fields/host_ext.py``, and the final
exponentiations by pow chains.  Elements are flat lists of standard-form
ints.  ``chip_smoke.py`` and the tests hold the device pairings
(``curves/pairing_mnt.py``, ``curves/pairing_bls12.py``) to them.
"""

from __future__ import annotations

from .. import params as PP
from ..fields import host_ext as HE
from ..params._gen import curves_gen as CG, towers_gen as TG


class _HostGT:
    """GT's arithmetic in python ints over the host tower ``self.F``, and
    the pairing as the final exponentiation of the Miller loop."""

    p: int
    F: HE.HostTower

    def _fmul(self, a, b):
        return HE.host_ext_mul(self.F, a, b)

    def _finv(self, a):
        return HE.host_ext_inv(self.F, a)

    def _fone(self):
        return [1] + [0] * (self.F.K - 1)

    def _ffrob(self, a, i):
        return HE.host_ext_frob(self.F, a, i)

    def _fpow(self, a, e):
        r = self._fone()
        base = a
        while e:
            if e & 1:
                r = self._fmul(r, base)
            base = self._fmul(base, base)
            e >>= 1
        return r

    def _fconj(self, a):
        """a^(q^(k/2)): the second half of GT's quadratic level negated."""
        k = self.F.sf.K
        return a[:k] + [(-v) % self.p for v in a[k:]]

    def pairing(self, p_xy, q_xy):
        return self.final_exponentiation(self.miller_loop(p_xy, q_xy))


class HostMNTPairing(_HostGT):
    def __init__(self, p: int, sub: HE.HostTower, fqk: HE.HostTower,
                 g2_a_host, wnaf, ate_is_neg, w1, w0_abs, w0_is_neg,
                 easy_frob: int, easy_mul_q_plus_1: bool):
        """sub / fqk: the twist's field (Fq2, Fq3) and GT's (Fq4, Fq6) as
        host towers; wnaf LSB first with the top digit trimmed, as the
        curve constants store it; the easy part is f^(q^easy_frob - 1),
        times its q-power where ``easy_mul_q_plus_1`` (MNT6); the hard
        part's exponent is w1*q + w0."""
        self.p = p
        self.S = sub
        self.F = fqk
        self.g2_a = [v % p for v in HE.flatten(g2_a_host)]
        self.wnaf = list(reversed(wnaf))
        self.ate_is_neg = ate_is_neg
        self.w1 = w1
        self.w0_abs = w0_abs
        self.w0_is_neg = w0_is_neg
        self.easy_frob = easy_frob
        self.easy_mul_q_plus_1 = easy_mul_q_plus_1
        t = [0] * sub.K
        t[1] = 1
        self.twist = t
        self.twist_sq = HE.host_ext_mul(sub, t, t)

    def miller_loop(self, p_xy, q_xy):
        """p_xy: ([x], [y]) of G1; q_xy: ([x comps], [y comps]) of G2."""
        S, p = self.S, self.p
        mul, inv = HE.host_ext_mul, HE.host_ext_inv
        xp, yp = p_xy[0][0], p_xy[1][0]
        x2, y2 = list(q_xy[0]), list(q_xy[1])
        py_tw2 = [v * yp % p for v in self.twist_sq]
        f = self._fone()
        sx, sy = x2, y2
        for n in self.wnaf:
            # doubling step
            xx = mul(S, sx, sx)
            num = [(3 * a + b) % p for a, b in zip(xx, self.g2_a)]
            den = [(2 * a) % p for a in sy]
            gamma = mul(S, num, inv(S, den))
            gamma_x = mul(S, gamma, sx)
            gT = HE.host_ext_mul_const(S, gamma, self.twist)
            c1 = [(a - b * xp - c) % p for a, b, c in zip(gamma_x, gT, sy)]
            f = self._fmul(self._fmul(f, f), py_tw2 + c1)
            nx = [(a - 2 * b) % p for a, b in zip(mul(S, gamma, gamma), sx)]
            ny = [(a - b) % p for a, b in zip(
                mul(S, gamma, [(i - j) % p for i, j in zip(sx, nx)]), sy)]
            sx, sy = nx, ny
            if n != 0:
                sign = 1 if n > 0 else -1
                num = [(a - sign * b) % p for a, b in zip(sy, y2)]
                den = [(a - b) % p for a, b in zip(sx, x2)]
                gamma = mul(S, num, inv(S, den))
                gamma_x = mul(S, gamma, x2)
                gT = HE.host_ext_mul_const(S, gamma, self.twist)
                c1 = [(a - b * xp - sign * c) % p
                      for a, b, c in zip(gamma_x, gT, y2)]
                f = self._fmul(f, py_tw2 + c1)
                nx = [(a - b - c) % p for a, b, c in zip(
                    mul(S, gamma, gamma), sx, x2)]
                ny = [(a - b) % p for a, b in zip(
                    mul(S, gamma, [(i - j) % p for i, j in zip(sx, nx)]),
                    sy)]
                sx, sy = nx, ny
        if self.ate_is_neg:
            f = self._fconj(f)
        return f

    def final_exponentiation(self, f):
        """The easy part elt = f^(q^k - 1) (k = ``easy_frob``), raised to
        q + 1 for MNT6, then elt^(w1*q) * elt^(+-w0)."""
        f_inv = self._finv(f)

        def first(a, ai):
            t = self._fmul(self._ffrob(a, self.easy_frob), ai)
            if self.easy_mul_q_plus_1:
                t = self._fmul(self._ffrob(t, 1), t)
            return t

        elt, elt_inv = first(f, f_inv), first(f_inv, f)
        w1p = self._ffrob(elt, 1)
        if self.w1 != 1:
            w1p = self._fpow(w1p, self.w1)
        w0p = self._fpow(elt_inv if self.w0_is_neg else elt, self.w0_abs)
        return self._fmul(w1p, w0p)


def host_mnt4753_pairing() -> HostMNTPairing:
    c = CG.MNT4753
    p = PP.MNT4753_FQ.modulus
    _, fq2, fq4 = HE.build_mnt4_host_towers(p, TG.MNT4753_FQ2["nonresidue"])
    return HostMNTPairing(
        p, fq2, fq4, c["g2_a"], c["wnaf"], c["ate_is_loop_count_neg"],
        c["final_exponent_last_chunk_1"],
        c["final_exponent_last_chunk_abs_of_w0"],
        c["final_exponent_last_chunk_w0_is_neg"], 2, False)


def host_mnt6753_pairing() -> HostMNTPairing:
    c = CG.MNT6753
    p = PP.MNT6753_FQ.modulus
    _, fq3, fq6 = HE.build_mnt6_host_towers(p, TG.MNT6753_FQ3["nonresidue"])
    return HostMNTPairing(
        p, fq3, fq6, c["g2_a"], c["wnaf"], c["ate_is_loop_count_neg"],
        c["final_exponent_last_chunk_1"],
        c["final_exponent_last_chunk_abs_of_w0"],
        c["final_exponent_last_chunk_w0_is_neg"], 3, True)


# FINAL_EXPONENT_LAST_CHUNK_W1 of SW6 (curves/sw6/mod.rs:227-239); w0 and
# the rest of the curve's constants are in the extracted tables
SW6_W1 = 86482221941698704497288378992285180119495364068003923046442785886272123124361700722982503222189455144364945735564951562986


def _host_mnt6(fq, tw3, c, w1) -> HostMNTPairing:
    from .instances import find_wnaf
    p = fq.modulus
    _, fq3, fq6 = HE.build_mnt6_host_towers(p, tw3["nonresidue"])
    return HostMNTPairing(
        p, fq3, fq6, c["g2_a"], find_wnaf(c["ate_loop_count"]),
        c["ate_is_loop_count_neg"], w1,
        c["final_exponent_last_chunk_abs_of_w0"],
        c["final_exponent_last_chunk_w0_is_neg"], 3, True)


def host_sw6_pairing() -> HostMNTPairing:
    """SW6 (CP6-782): its engine is MNT6-shaped (Fq3 twist (0, 1, 0), lines
    in Fq6 = Fq3[Y], easy part (q^3 - 1)(q + 1), hard part
    elt^(w1 q) elt^(+-w0)), so the MNT ladder runs it, over the loop count
    in NAF form.  The loop count is the decoded [u64; 13] limbs that the
    reference's engine iterates, 782 bits; its doc comment (curves/sw6/
    mod.rs:183-184) states a 388-bit value, which gives another (still
    bilinear) pairing.  The JAX package's oracle makes the same choice and
    pins its GT (tests/test_pairing.py::test_sw6_gt_vector)."""
    return _host_mnt6(PP.SW6_FQ, TG.SW6_FQ3, CG.SW6, SW6_W1)


def host_mnt6298_pairing() -> HostMNTPairing:
    c = CG.MNT6298
    return _host_mnt6(PP.MNT6298_FQ, TG.MNT6298_FQ3, c,
                      c["final_exponent_last_chunk_1"])


class HostBls12Pairing(_HostGT):
    """The BLS12 ate pairing in python ints: the loop over the bits of x
    with homogeneous-projective G2 line coefficients (bls12/g2.rs:115-165),
    the 2016/130 Table-1 final exponentiation (bls12/mod.rs:148-205).
    ``twist_type``: "D" (BLS12-377) or "M" (BLS12-381)."""

    def __init__(self, p: int, fq2: HE.HostTower, fq12: HE.HostTower,
                 g2_b_host, x: int, x_is_neg: bool, twist_type: str):
        self.p = p
        self.S = fq2                  # the twist's field
        self.F = fq12
        self.g2_b = [v % p for v in HE.flatten(g2_b_host)]
        self.x = x
        self.x_is_neg = x_is_neg
        self.twist_type = twist_type
        self.two_inv = pow(2, -1, p)

    def _exp_by_x(self, f):
        g = self._fpow(f, self.x)
        return self._fconj(g) if self.x_is_neg else g

    def _prepare_g2(self, q_xy):
        """The line coefficients (c0, c1, c2) of every step, in Fq2."""
        S, p = self.S, self.p
        qx, qy = list(q_xy[0]), list(q_xy[1])

        def m(a, b):
            return HE.host_ext_mul(S, a, b)

        def addl(a, b):
            return [(i + j) % p for i, j in zip(a, b)]

        def subl(a, b):
            return [(i - j) % p for i, j in zip(a, b)]

        def scale(a, k):
            return [i * k % p for i in a]

        def neg(a):
            return [(-v) % p for v in a]

        rx, ry, rz = list(qx), list(qy), [1] + [0] * (S.K - 1)
        coeffs = []
        for bit in bin(self.x)[3:]:          # MSB skipped
            # doubling step
            a = scale(m(rx, ry), self.two_inv)
            b = m(ry, ry)
            c = m(rz, rz)
            e = m(self.g2_b, scale(c, 3))
            f = scale(e, 3)
            g = scale(addl(b, f), self.two_inv)
            h = subl(m(addl(ry, rz), addl(ry, rz)), addl(b, c))
            i_ = subl(e, b)
            j = m(rx, rx)
            e2 = m(e, e)
            rx = m(a, subl(b, f))
            ry = subl(m(g, g), scale(e2, 3))
            rz = m(b, h)
            coeffs.append((i_, scale(j, 3), neg(h)) if self.twist_type == "M"
                          else (neg(h), scale(j, 3), i_))
            if bit == "1":
                # addition step
                theta = subl(ry, m(qy, rz))
                lam = subl(rx, m(qx, rz))
                cc = m(theta, theta)
                d = m(lam, lam)
                ee = m(lam, d)
                ff = m(rz, cc)
                gg = m(rx, d)
                hh = subl(addl(ee, ff), scale(gg, 2))
                rx = m(lam, hh)
                ry = subl(m(theta, subl(gg, hh)), m(ee, ry))
                rz = m(rz, ee)
                jj = subl(m(theta, qx), m(lam, qy))
                coeffs.append((jj, neg(theta), lam)
                              if self.twist_type == "M"
                              else (lam, neg(theta), jj))
        return coeffs

    def _ell(self, f, coeff, px, py):
        """f times the sparse line (bls12/mod.rs ell): positions 0, 1, 4 of
        [1, v, v^2, w, vw, v^2 w] for the M-twist, 0, 3, 4 for D."""
        p = self.p
        c0, c1, c2 = coeff
        z = [0] * self.S.K
        if self.twist_type == "M":
            line = c0 + [v * px % p for v in c1] + z + z + \
                [v * py % p for v in c2] + z
        else:
            line = [v * py % p for v in c0] + z + z + \
                [v * px % p for v in c1] + c2 + z
        return self._fmul(f, line)

    def miller_loop(self, p_xy, q_xy):
        px, py = p_xy[0][0] % self.p, p_xy[1][0] % self.p
        it = iter(self._prepare_g2(q_xy))
        f = self._fone()
        for bit in bin(self.x)[3:]:
            f = self._ell(self._fmul(f, f), next(it), px, py)
            if bit == "1":
                f = self._ell(f, next(it), px, py)
        return self._fconj(f) if self.x_is_neg else f

    def final_exponentiation(self, f):
        # easy part: f^((p^6 - 1)(p^2 + 1))
        r = self._fmul(self._fconj(f), self._finv(f))
        r = self._fmul(self._ffrob(r, 2), r)
        # hard part, 2016/130 Table 1 (bls12/mod.rs:148-205)
        y0 = self._fconj(self._fmul(r, r))
        y5 = self._exp_by_x(r)
        y1 = self._fmul(y5, y5)
        y3 = self._fmul(y0, y5)
        y0 = self._exp_by_x(y3)
        y2 = self._exp_by_x(y0)
        y4 = self._fmul(self._exp_by_x(y2), y1)
        y1 = self._exp_by_x(y4)
        y1 = self._fmul(self._fmul(y1, self._fconj(y3)), r)
        y0 = self._ffrob(self._fmul(y0, r), 3)
        y4 = self._ffrob(self._fmul(y4, self._fconj(r)), 1)
        y5 = self._ffrob(self._fmul(y5, y2), 2)
        return self._fmul(self._fmul(self._fmul(y5, y0), y4), y1)


def _host_bls12(c, fq, tw2, tw6, twist: str) -> HostBls12Pairing:
    _, fq2, _, fq12 = HE.build_bls12_host_towers(
        fq.modulus, tw2["nonresidue"], tw6["nonresidue"])
    return HostBls12Pairing(fq.modulus, fq2, fq12, c["g2_b"], c["x"],
                            c["x_is_negative"], twist)


def host_bls12_377_pairing() -> HostBls12Pairing:
    return _host_bls12(CG.BLS12_377, PP.BLS12_377_FQ, TG.BLS12_377_FQ2,
                       TG.BLS12_377_FQ6, "D")


def host_bls12_381_pairing() -> HostBls12Pairing:
    return _host_bls12(CG.BLS12_381, PP.BLS12_381_FQ, TG.BLS12_381_FQ2,
                       TG.BLS12_381_FQ6, "M")
