"""Host (python-int) MNT ate pairings: the exact oracle of the port's
pairing.

Counterpart of ``gingerlib_tpu/curves/pairing_host.py`` (``HostMNTPairing``,
``host_mnt4753_pairing``, ``host_mnt6753_pairing``): the reference's affine
Miller ladder (mnt4/mod.rs:100-224, mnt6/mod.rs) over the host tower
arithmetic of ``fields/host_ext.py``, and the final exponentiation by pow
chains.  Elements
are flat lists of standard-form ints.  ``chip_smoke.py`` and the tests hold
the device pairing (``curves/pairing_mnt.py``) to it.
"""

from __future__ import annotations

from .. import params as PP
from ..fields import host_ext as HE
from ..params._gen import curves_gen as CG, towers_gen as TG


class HostMNTPairing:
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

    # -- GT helpers --

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
        k = self.S.K
        return a[:k] + [(-v) % self.p for v in a[k:]]

    # -- pairing --

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

    def pairing(self, p_xy, q_xy):
        return self.final_exponentiation(self.miller_loop(p_xy, q_xy))


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
