"""In-circuit BLS12 ate pairing (r1cs/gadgets/std/src/pairing/bls12);
counterpart of ``gingerlib_tpu/gadgets/std/pairing_bls12.py``.

Affine-slope Miller loop over the bits of X: inversion is one constraint
in-circuit, so each G2 step allocates the slope λ ∈ Fq2 with

    doubling:  λ·2y = 3x²            (a = 0 on BLS12 G2)
    addition:  λ·(x − x₂) = y − y₂

Lines are the sparse Fq12 elements (basis [1, v, v², w, vw, v²w]):

    D-twist (377): l = y_P − (λ·x_P)·w + (λ·x' − y')·w³     (positions 0,3,4)
    M-twist (381): l = (λ·x' − y') − (λ·x_P)·v + y_P·vw     (positions 0,1,4)

Any common Fq2 scale factor of a line dies in the easy part of the final
exponentiation, so affine normalization is safe (the MNT gadget's
argument, gadgets/std/pairing.py).  Final exponentiation is the 2016/130
Table-1 chain with in-circuit square-and-multiply for f^X.
"""

from __future__ import annotations

from .fp import FpG
from .groups import SWGroupGadget, AffinePointG, _host_ext_mul, \
    _host_ext_inv
from .pairing import _pow_gadget


class Bls12PairingGadget:
    def __init__(self, fq_params, fq2_ops, fq12_ops, g2_gadget: SWGroupGadget,
                 x: int, x_is_neg: bool, twist_type: str):
        self.fq = fq_params
        self.sub = fq2_ops
        self.fqk = fq12_ops
        self.g2 = g2_gadget
        self.x = x
        self.x_is_neg = x_is_neg
        self.twist_type = twist_type
        self.x_bits = bin(x)[3:]

    def _p(self):
        return self.fq.modulus

    # -- slope allocations (witness values via host Fq2 math) --

    def _slope_dbl(self, cs, x, y, name):
        S = self.sub
        p = self._p()
        gv = nxv = nyv = None
        if all(w.value is not None for w in x + y):
            xv = [w.value for w in x]
            yv = [w.value for w in y]
            num = [3 * a % p for a in _host_ext_mul(S, xv, xv)]
            den = [2 * a % p for a in yv]
            gv = _host_ext_mul(S, num, _host_ext_inv(S, den))
            nxv = [(a - 2 * b) % p for a, b in zip(
                _host_ext_mul(S, gv, gv), xv)]
            nyv = [(a - b) % p for a, b in zip(
                _host_ext_mul(S, gv, [(i - j) % p for i, j in zip(xv, nxv)]),
                yv)]
        lam = S.alloc(cs, gv, f"{name}/lam")
        x2 = S.sqr(cs, x, f"{name}/x2")
        rhs = S.add(cs, S.double(cs, x2), x2)      # 3x²
        prod = S.mul(cs, lam, S.double(cs, y), f"{name}/l2y")
        S.enforce_equal(cs, prod, rhs, f"{name}/slope")
        l2 = S.sqr(cs, lam, f"{name}/lsq")
        new_x = S.sub(cs, l2, S.double(cs, x))
        new_y = S.sub(cs, S.mul(cs, lam, S.sub(cs, x, new_x),
                                f"{name}/ly"), y)
        return lam, new_x, new_y

    def _slope_add(self, cs, x, y, x2, y2, name):
        S = self.sub
        p = self._p()
        gv = nxv = nyv = None
        if all(w.value is not None for w in x + y + x2 + y2):
            xv = [w.value for w in x]
            yv = [w.value for w in y]
            x2v = [w.value for w in x2]
            y2v = [w.value for w in y2]
            num = [(a - b) % p for a, b in zip(yv, y2v)]
            den = [(a - b) % p for a, b in zip(xv, x2v)]
            gv = _host_ext_mul(S, num, _host_ext_inv(S, den))
            nxv = [(a - b - c) % p for a, b, c in zip(
                _host_ext_mul(S, gv, gv), xv, x2v)]
            nyv = [(a - b) % p for a, b in zip(
                _host_ext_mul(S, gv, [(i - j) % p for i, j in zip(xv, nxv)]),
                yv)]
        lam = S.alloc(cs, gv, f"{name}/lam")
        prod = S.mul(cs, lam, S.sub(cs, x, x2), f"{name}/ldx")
        S.enforce_equal(cs, prod, S.sub(cs, y, y2), f"{name}/slope")
        l2 = S.sqr(cs, lam, f"{name}/lsq")
        new_x = S.sub(cs, S.sub(cs, l2, x), x2)
        new_y = S.sub(cs, S.mul(cs, lam, S.sub(cs, x, new_x),
                                f"{name}/ly"), y)
        return lam, new_x, new_y

    def prepare_g2(self, cs, q: AffinePointG, name="prep"):
        """-> list of (λ, c) with c = λ·x_anchor − y_anchor (the line's
        constant part), anchor = the point the line passes through."""
        S = self.sub
        coeffs = []
        x, y = q.x, q.y
        for i, bit in enumerate(self.x_bits):
            lam, nx, ny = self._slope_dbl(cs, x, y, f"{name}/d{i}")
            c = S.sub(cs, S.mul(cs, lam, x, f"{name}/d{i}/lx"), y)
            coeffs.append((lam, c))
            x, y = nx, ny
            if bit == "1":
                lam, nx2, ny2 = self._slope_add(cs, x, y, q.x, q.y,
                                                f"{name}/a{i}")
                c = S.sub(cs, S.mul(cs, lam, q.x, f"{name}/a{i}/lx"), q.y)
                coeffs.append((lam, c))
                x, y = nx2, ny2
        return coeffs

    def _line_fqk(self, cs, xw: FpG, yw: FpG, lam, c, name):
        """flat Fq12 wire list for the sparse line."""
        S = self.sub
        k2 = S.K
        zero2 = [FpG.constant(cs, 0) for _ in range(k2)]
        # −λ·x_P  (Fq2 scaled by the Fp wire x_P)
        neg_lxp = [w.mul(xw, f"{name}/lx{j}").neg()
                   for j, w in enumerate(lam)]
        if self.twist_type == "D":
            # positions 0,3,4: [yp, 0, 0, −λxp, λx−y, 0]
            pos0 = [yw] + [FpG.constant(cs, 0)] * (k2 - 1)
            return pos0 + zero2 + zero2 + neg_lxp + c + zero2
        # M: positions 0,1,4: [λx−y, −λxp, 0, 0, yp, 0]
        pos4 = [yw] + [FpG.constant(cs, 0)] * (k2 - 1)
        return c + neg_lxp + zero2 + zero2 + pos4 + zero2

    def miller_loop(self, cs, g1_points, g2_coeffs, name="miller"):
        F = self.fqk
        f = F.one(cs)
        idx = [0] * len(g2_coeffs)
        first = True
        for step, bit in enumerate(self.x_bits):
            if not first:
                f = F.sqr(cs, f, f"{name}/s{step}/f2")
            for pi, (p1, coeffs) in enumerate(zip(g1_points, g2_coeffs)):
                lam, c = coeffs[idx[pi]]
                idx[pi] += 1
                line = self._line_fqk(cs, p1.x[0], p1.y[0], lam, c,
                                      f"{name}/s{step}/p{pi}")
                f = F.mul(cs, f, line, f"{name}/s{step}/p{pi}/mul")
            if bit == "1":
                for pi, (p1, coeffs) in enumerate(zip(g1_points, g2_coeffs)):
                    lam, c = coeffs[idx[pi]]
                    idx[pi] += 1
                    line = self._line_fqk(cs, p1.x[0], p1.y[0], lam, c,
                                          f"{name}/s{step}/q{pi}")
                    f = F.mul(cs, f, line, f"{name}/s{step}/q{pi}/mul")
            first = False
        if self.x_is_neg:
            f = F.unitary_inverse(cs, f)
        return f

    def _exp_by_x(self, cs, f, name):
        g = _pow_gadget(self.fqk, cs, f, self.x, name)
        return self.fqk.unitary_inverse(cs, g) if self.x_is_neg else g

    def final_exponentiation(self, cs, f, name="fexp"):
        F = self.fqk
        f1 = F.unitary_inverse(cs, f)           # f^(p^6)
        f2 = F.inv(cs, f, f"{name}/inv")
        r = F.mul(cs, f1, f2, f"{name}/easy1")
        f2 = r
        r = F.mul(cs, F.frob(cs, r, 2), f2, f"{name}/easy2")
        y0 = F.unitary_inverse(cs, F.sqr(cs, r, f"{name}/r2"))
        y5 = self._exp_by_x(cs, r, f"{name}/y5")
        y1 = F.sqr(cs, y5, f"{name}/y1")
        y3 = F.mul(cs, y0, y5, f"{name}/y3")
        y0 = self._exp_by_x(cs, y3, f"{name}/y0")
        y2 = self._exp_by_x(cs, y0, f"{name}/y2")
        y4 = self._exp_by_x(cs, y2, f"{name}/y4")
        y4 = F.mul(cs, y4, y1, f"{name}/y4b")
        y1 = self._exp_by_x(cs, y4, f"{name}/y1b")
        y3 = F.unitary_inverse(cs, y3)
        y1 = F.mul(cs, F.mul(cs, y1, y3, f"{name}/m1"), r, f"{name}/m2")
        y3 = F.unitary_inverse(cs, r)
        y0 = F.mul(cs, y0, r, f"{name}/m3")
        y0 = F.frob(cs, y0, 3)
        y4 = F.mul(cs, y4, y3, f"{name}/m4")
        y4 = F.frob(cs, y4, 1)
        y5 = F.mul(cs, y5, y2, f"{name}/m5")
        y5 = F.frob(cs, y5, 2)
        y5 = F.mul(cs, y5, y0, f"{name}/m6")
        y5 = F.mul(cs, y5, y4, f"{name}/m7")
        return F.mul(cs, y5, y1, f"{name}/out")

    def pairing_product(self, cs, g1_points, g2_points, name="pairing"):
        coeffs = [self.prepare_g2(cs, q, f"{name}/prep{i}")
                  for i, q in enumerate(g2_points)]
        f = self.miller_loop(cs, g1_points, coeffs, f"{name}/miller")
        return self.final_exponentiation(cs, f, f"{name}/fexp")


def bls12_377_pairing_gadget():
    from ... import params as PP
    from ...params._gen import towers_gen as TG, curves_gen as CG
    from .ext_fields import build_bls12_tower_gadgets
    c = CG.BLS12_377
    base, fq2, fq6, fq12 = build_bls12_tower_gadgets(
        PP.BLS12_377_FQ, TG.BLS12_377_FQ2["nonresidue"],
        TG.BLS12_377_FQ6["nonresidue"])
    g2 = SWGroupGadget(fq2, c["g2_a"], c["g2_b"])
    return Bls12PairingGadget(
        PP.BLS12_377_FQ, fq2, fq12, g2, c["x"], c["x_is_negative"],
        "D"), base, fq2, fq12


def bls12_381_pairing_gadget():
    from ... import params as PP
    from ...params._gen import towers_gen as TG, curves_gen as CG
    from .ext_fields import build_bls12_tower_gadgets
    c = CG.BLS12_381
    base, fq2, fq6, fq12 = build_bls12_tower_gadgets(
        PP.BLS12_381_FQ, TG.BLS12_381_FQ2["nonresidue"],
        TG.BLS12_381_FQ6["nonresidue"])
    g2 = SWGroupGadget(fq2, c["g2_a"], c["g2_b"])
    return Bls12PairingGadget(
        PP.BLS12_381_FQ, fq2, fq12, g2, c["x"], c["x_is_negative"],
        "M"), base, fq2, fq12
