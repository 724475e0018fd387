"""In-circuit ate pairing for MNT4/MNT6 curves
(r1cs/gadgets/std/src/pairing/{mnt4,mnt6} + groups/.../mnt prepared gadgets);
counterpart of ``gingerlib_tpu/gadgets/std/pairing.py``.

Inside a circuit, field inversion costs ONE constraint, so unlike the
device pairing (curves/pairing_mnt.py, projective) the gadget follows the
reference's *affine* ladder exactly:

  prepare_g2:  per WNAF step allocate the slope γ with
               γ·2y = 3x²+a'  (doubling)  /  γ·(x−x₂) = y∓y₂  (addition),
               then the new point coordinates are derived linearly from γ²
               (doubling_step_for_flipped_miller_loop,
               groups/.../mnt/mnt4/mod.rs:114-229).
  miller_loop: f ← f²·g_RR(P) with
               g_RR = (y_P·T², γ·x' − γ·T·x_P − y'),
  final exp:   easy part via Frobenius (free) + one inversion; hard part
               m₁ = 1 on both 753 curves so it is frob(elt,1) · elt^{±m₀}
               by in-circuit square-and-multiply.
"""

from __future__ import annotations

from .ext_fields import _flatten
from .groups import SWGroupGadget, AffinePointG, _host_ext_mul, \
    _host_ext_inv, _host_ext_mul_const


class MNTPairingGadget:
    def __init__(self, fq_params, sub_ops, fqk_ops, g2_gadget: SWGroupGadget,
                 wnaf, ate_is_neg: bool, w1: int, w0_abs: int,
                 w0_is_neg: bool, easy_frob: int, easy_mul_q_plus_1: bool):
        self.fq = fq_params
        self.sub = sub_ops          # Fq2 / Fq3 gadget ops
        self.fqk = fqk_ops          # Fq4 / Fq6 gadget ops
        self.g2 = g2_gadget
        self.wnaf = list(reversed(wnaf))  # MSB->LSB
        self.ate_is_neg = ate_is_neg
        self.w1 = w1
        self.w0_abs = w0_abs
        self.w0_is_neg = w0_is_neg
        self.easy_frob = easy_frob
        self.easy_mul_q_plus_1 = easy_mul_q_plus_1
        # twist T = (0, 1[, 0]) in the sub tower; T² host constant
        K = sub_ops.K
        t = [0] * K
        t[1] = 1
        self.twist = t
        self.twist_sq = _host_ext_mul_const(sub_ops, t, t)
        self.twist_a = g2_gadget.a  # host components of a'

    # ------------------------------------------------------------------
    # host mirrors (witness computation)
    # ------------------------------------------------------------------

    def _p(self):
        return self.fq.modulus

    # ------------------------------------------------------------------
    # prepared gadgets
    # ------------------------------------------------------------------

    def prepare_g1(self, cs, p: AffinePointG):
        """-> (x_P wire, y_P wire, py_twist_squared sub-element wires).

        py·T² is linear in y (T² is constant), so it costs nothing.
        """
        S = self.sub
        xw, yw = p.x[0], p.y[0]
        py_tw2 = [yw.mul_by_constant(c) for c in self.twist_sq]
        return (xw, yw, py_tw2)

    def _alloc_slope_dbl(self, cs, x, y, name):
        """γ with γ·2y = 3x²+a'; returns (γ, new_x, new_y)."""
        S = self.sub
        # witness values
        gv = nxv = nyv = None
        if all(w.value is not None for w in x + y):
            p = self._p()
            xv = [w.value for w in x]
            yv = [w.value for w in y]
            num = [(3 * a + b) % p for a, b in zip(
                _host_ext_mul(S, xv, xv),
                [v % p for v in _flatten(self.twist_a)])]
            den = [(2 * a) % p for a in yv]
            gv = _host_ext_mul(S, num, _host_ext_inv(S, den))
            nxv = [(a - 2 * b) % p for a, b in zip(
                _host_ext_mul(S, gv, gv), xv)]
            nyv = [(a - b) % p for a, b in zip(
                _host_ext_mul(S, gv, [(i - j) % p for i, j in zip(xv, nxv)]),
                yv)]
        gamma = S.alloc(cs, gv, f"{name}/gamma")
        two_y = S.double(cs, y)
        x2 = S.sqr(cs, x, f"{name}/x2")
        rhs = S.add(cs, S.add(cs, S.double(cs, x2), x2),
                    S.const(cs, self.twist_a))
        prod = S.mul(cs, gamma, two_y, f"{name}/g2y")
        S.enforce_equal(cs, prod, rhs, f"{name}/slope")
        # new point
        g2_ = S.sqr(cs, gamma, f"{name}/gsq")
        new_x = S.sub(cs, g2_, S.double(cs, x))
        t = S.mul(cs, gamma, S.sub(cs, x, new_x), f"{name}/gy")
        new_y = S.sub(cs, t, y)
        return gamma, new_x, new_y

    def _alloc_slope_add(self, cs, x, y, x2, y2, sign: int, name):
        """chord slope through S=(x,y) and ±Q=(x2,y2):
        γ·(x−x₂) = y − (±y₂); returns (γ, new_x, new_y)."""
        S = self.sub
        p = self._p()
        gv = nxv = nyv = None
        if all(w.value is not None for w in x + y + x2 + y2):
            xv = [w.value for w in x]
            yv = [w.value for w in y]
            x2v = [w.value for w in x2]
            y2v = [w.value for w in y2]
            num = [(a - sign * b) % p for a, b in zip(yv, y2v)]
            den = [(a - b) % p for a, b in zip(xv, x2v)]
            gv = _host_ext_mul(S, num, _host_ext_inv(S, den))
            nxv = [(a - b - c) % p for a, b, c in zip(
                _host_ext_mul(S, gv, gv), xv, x2v)]
            nyv = [(a - b) % p for a, b in zip(
                _host_ext_mul(S, gv, [(i - j) % p for i, j in zip(xv, nxv)]),
                yv)]
        gamma = S.alloc(cs, gv, f"{name}/gamma")
        dx = S.sub(cs, x, x2)
        q_y = y2 if sign > 0 else S.neg(cs, y2)
        dy = S.sub(cs, y, q_y)
        prod = S.mul(cs, gamma, dx, f"{name}/gdx")
        S.enforce_equal(cs, prod, dy, f"{name}/slope")
        g2_ = S.sqr(cs, gamma, f"{name}/gsq")
        new_x = S.sub(cs, S.sub(cs, g2_, x), x2)
        t = S.mul(cs, gamma, S.sub(cs, x, new_x), f"{name}/gy")
        new_y = S.sub(cs, t, y)
        return gamma, new_x, new_y

    def prepare_g2(self, cs, q: AffinePointG, name="prep_g2"):
        """Full WNAF ladder -> list of (r_y, gamma, gamma_x[, q_y_sign])."""
        S = self.sub
        coeffs = []
        x, y = q.x, q.y
        for i, n in enumerate(self.wnaf):
            gamma, nx, ny = self._alloc_slope_dbl(cs, x, y, f"{name}/d{i}")
            gamma_x = S.mul(cs, gamma, x, f"{name}/d{i}/gx")
            coeffs.append(("dbl", y, gamma, gamma_x))
            x, y = nx, ny
            if n != 0:
                sign = 1 if n > 0 else -1
                gamma, nx, ny = self._alloc_slope_add(
                    cs, x, y, q.x, q.y, sign, f"{name}/a{i}")
                gamma_x = S.mul(cs, gamma, q.x, f"{name}/a{i}/gx")
                coeffs.append(("add", sign, gamma, gamma_x))
                x, y = nx, ny
        return {"q": q, "coeffs": coeffs}

    # ------------------------------------------------------------------
    # miller loop + final exponentiation
    # ------------------------------------------------------------------

    def _line_fqk(self, cs, py_tw2, c1):
        return py_tw2 + c1

    def miller_loop(self, cs, g1_preps, g2_preps, name="miller"):
        """Product of Miller loops over prepared pairs
        (pairing/mnt4/mod.rs:18-60)."""
        S = self.sub
        F = self.fqk
        f = F.one(cs)
        idx = [0] * len(g2_preps)
        for step, n in enumerate(self.wnaf):
            f = F.sqr(cs, f, f"{name}/s{step}/f2")
            for pi, (g1p, g2p) in enumerate(zip(g1_preps, g2_preps)):
                xw, yw, py_tw2 = g1p
                kind, r_y, gamma, gamma_x = g2p["coeffs"][idx[pi]]
                assert kind == "dbl"
                idx[pi] += 1
                # γ·T (rotation by the twist) then scale by x_P
                gT = _mul_by_twist_gadget(S, cs, gamma, self.twist)
                gT_x = [w.mul(xw, f"{name}/s{step}/p{pi}/gtx{j}")
                        for j, w in enumerate(gT)]
                c1 = S.sub(cs, S.sub(cs, gamma_x, gT_x), r_y)
                line = self._line_fqk(cs, py_tw2, c1)
                f = F.mul(cs, f, line, f"{name}/s{step}/p{pi}/mul")
            if n != 0:
                for pi, (g1p, g2p) in enumerate(zip(g1_preps, g2_preps)):
                    xw, yw, py_tw2 = g1p
                    kind, sign, gamma, gamma_x = g2p["coeffs"][idx[pi]]
                    assert kind == "add"
                    idx[pi] += 1
                    gT = _mul_by_twist_gadget(S, cs, gamma, self.twist)
                    gT_x = [w.mul(xw, f"{name}/s{step}/q{pi}/gtx{j}")
                            for j, w in enumerate(gT)]
                    qy = g2p["q"].y
                    qy_t = qy if sign > 0 else S.neg(cs, qy)
                    c1 = S.sub(cs, S.sub(cs, gamma_x, gT_x), qy_t)
                    line = self._line_fqk(cs, py_tw2, c1)
                    f = F.mul(cs, f, line, f"{name}/s{step}/q{pi}/mul")
        if self.ate_is_neg:
            f = self.fqk.unitary_inverse(cs, f)
        return f

    def final_exponentiation(self, cs, f, name="finexp"):
        F = self.fqk
        f_inv = F.inv(cs, f, f"{name}/inv")

        def first_chunk(a, a_inv, nm):
            t = F.mul(cs, F.frob(cs, a, self.easy_frob), a_inv, nm)
            if self.easy_mul_q_plus_1:
                t = F.mul(cs, F.frob(cs, t, 1), t, nm + "/q1")
            return t

        elt = first_chunk(f, f_inv, f"{name}/e")
        elt_inv = first_chunk(f_inv, f, f"{name}/ei")
        # hard part: elt^(m1·q) · (elt or elt_inv)^m0
        w1 = F.frob(cs, elt, 1)
        if self.w1 != 1:
            w1 = _pow_gadget(F, cs, w1, self.w1, f"{name}/w1")
        base0 = elt_inv if self.w0_is_neg else elt
        w0 = _pow_gadget(F, cs, base0, self.w0_abs, f"{name}/w0")
        return F.mul(cs, w1, w0, f"{name}/out")

    def pairing_product(self, cs, g1_points, g2_points, name="pairing"):
        g1_preps = [self.prepare_g1(cs, p) for p in g1_points]
        g2_preps = [self.prepare_g2(cs, q, f"{name}/prep{i}")
                    for i, q in enumerate(g2_points)]
        f = self.miller_loop(cs, g1_preps, g2_preps, f"{name}/miller")
        return self.final_exponentiation(cs, f, f"{name}/fexp")


def _mul_by_twist_gadget(S, cs, v, twist):
    """v * T where T = (0,1[,0]) — component rotation with nonresidue
    (free: constant multiplications on LCs)."""
    return S.mul_by_const(cs, v, twist)


def _pow_gadget(F, cs, x, e: int, name):
    """square-and-multiply x^e, MSB first."""
    bits = bin(e)[2:]
    r = x
    for i, b in enumerate(bits[1:]):
        r = F.sqr(cs, r, f"{name}/s{i}")
        if b == "1":
            r = F.mul(cs, r, x, f"{name}/m{i}")
    return r


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def mnt4753_pairing_gadget():
    from ... import params as PP
    from ...params._gen import towers_gen as TG, curves_gen as CG
    from .ext_fields import build_mnt4_tower_gadgets
    c = CG.MNT4753
    base, fq2, fq4 = build_mnt4_tower_gadgets(
        PP.MNT4753_FQ, TG.MNT4753_FQ2["nonresidue"])
    g2 = SWGroupGadget(fq2, c["g2_a"], c["g2_b"])
    return MNTPairingGadget(
        PP.MNT4753_FQ, fq2, fq4, g2,
        wnaf=c["wnaf"], ate_is_neg=c["ate_is_loop_count_neg"],
        w1=c["final_exponent_last_chunk_1"],
        w0_abs=c["final_exponent_last_chunk_abs_of_w0"],
        w0_is_neg=c["final_exponent_last_chunk_w0_is_neg"],
        easy_frob=2, easy_mul_q_plus_1=False), base, fq2, fq4


def mnt6753_pairing_gadget():
    from ... import params as PP
    from ...params._gen import towers_gen as TG, curves_gen as CG
    from .ext_fields import build_mnt6_tower_gadgets
    c = CG.MNT6753
    base, fq3, fq6 = build_mnt6_tower_gadgets(
        PP.MNT6753_FQ, TG.MNT6753_FQ3["nonresidue"])
    g2 = SWGroupGadget(fq3, c["g2_a"], c["g2_b"])
    return MNTPairingGadget(
        PP.MNT6753_FQ, fq3, fq6, g2,
        wnaf=c["wnaf"], ate_is_neg=c["ate_is_loop_count_neg"],
        w1=c["final_exponent_last_chunk_1"],
        w0_abs=c["final_exponent_last_chunk_abs_of_w0"],
        w0_is_neg=c["final_exponent_last_chunk_w0_is_neg"],
        easy_frob=3, easy_mul_q_plus_1=True), base, fq3, fq6
