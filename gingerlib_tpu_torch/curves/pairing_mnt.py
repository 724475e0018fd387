"""The MNT4 and MNT6 ate pairings on tensors.

Counterpart of ``gingerlib_tpu/curves/pairing_mnt.py``, generic over the
tower as the JAX class is: MNT4 (GT in Fq4 = Fq2[Y]/(Y^2 - X)) and MNT6 (GT
in Fq6 = Fq3[Y]/(Y^2 - X)), with the same prepared Miller loop and values
digit for digit: ``prepare_g2`` runs the reference's affine ladder
(mnt4/mod.rs:100-154; mnt6/mod.rs the same over Fq3) for one G2 point on
the host in python ints, where an inversion a step costs nothing, and
``miller_loop_prepared`` multiplies f by sparse affine lines (``mul_by_023``
over Fq4, ``mul_by_2345`` over Fq6) on the device.  Every line depends
only on the ladder and x_P, so all lines of a loop are formed in three
launches before it.  The final exponentiation's easy part is q^2 - 1 for
MNT4 and (q^3 - 1)(q + 1) for MNT6.  GT is
unique, so this loop computes every pairing: setup's e(alpha, beta) as well
as the verifier's product over gamma, delta and the proof's B.

The loop digits (WNAF) and the exponents are host constants: a step makes
its addition only where its digit is non-zero, a branch on the host where
the JAX package's scan selects.  A batch of pairs runs one loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import fp as fpmod
from ..fields import host_ext
from ..fields import towers as T
from .sw import SWCurveOps


class MNTPairing:
    def __init__(self, name: str, g1: SWCurveOps, g2: SWCurveOps, fqk,
                 wnaf, ate_is_neg: bool, w1: int, w0_abs: int,
                 w0_is_neg: bool, easy_frob: int, easy_mul_q_plus_1: bool):
        """fqk: GT's field as a ``QuadExtOps`` over g2's field (Fq4 over
        Fq2, Fq6 over Fq3).  wnaf: the loop digits LSB first with the top
        digit trimmed, as the curve constants store them; easy_frob: 2 for
        MNT4 (f^(q^2 - 1)), 3 for MNT6 (f^(q^3 - 1)); easy_mul_q_plus_1:
        MNT6 raises the easy part to q + 1 as well; w1, w0: the hard part's
        exponent w1*q + w0."""
        if g1.device != g2.device:
            raise ValueError(f"G1 on {g1.device}, G2 on {g2.device}")
        S = fqk.sf
        if not isinstance(S, (T.QuadExtOps, T.CubicExtOps)) or \
                not isinstance(S.sf, T.FpOps):
            raise NotImplementedError(
                "the port's MNT pairings are MNT4's and MNT6's: Fq4 over "
                "Fq2 or Fq6 over Fq3, over Fq")
        self.name = name
        self.g1 = g1
        self.g2 = g2
        self.device = g1.device
        self.fqk = fqk
        self.sub = S
        self.fp = g1.fp
        self.wnaf = list(reversed(wnaf))       # the loop runs MSB -> LSB
        self.ate_is_neg = ate_is_neg
        self.w1 = w1
        self.w0_abs = w0_abs
        self.w0_is_neg = w0_is_neg
        self.easy_frob = easy_frob
        self.easy_mul_q_plus_1 = easy_mul_q_plus_1
        # twist T = X, the subfield's generator; an affine line's c0 =
        # T^2*y_P is one base-field element: T^2 = (nr, 0) over Fq2 (c0 =
        # y_P*nr, ``mul_by_023``), T^2 = (0, 0, 1) over Fq3 (c0 = y_P X^2,
        # ``mul_by_2345``).  Checked here on the device's own arithmetic.
        K = S.K
        t = [0] * K
        t[1] = 1
        twist = torch.from_numpy(S.const(t)).to(self.device)
        nr = S.tensor("nonresidue", self.device)
        z = torch.zeros_like(nr)
        sparse = torch.cat([nr, z]) if K == 2 else torch.cat(
            [z, z, S.sf.tensor("one", self.device)])
        if not torch.equal(S.mul(twist, twist), sparse):
            raise ValueError(f"{name}: T^2 is not sparse")
        self._nr = fpmod.fp_to_int(self.fp, nr[0])
        self._twist_a_ints = fpmod.fp_to_ints(self.fp, g2.a)

    # ------------------------------------------------------------------
    # the Miller loop
    # ------------------------------------------------------------------

    def _ynr(self, yp):
        """y_P*nr from G1 y coordinates [..., 1, n] -> [..., n]."""
        return fpmod.mont_mul(self.fp, yp[..., 0, :],
                              self.sub.tensor("nonresidue", yp.device)[0])

    def prepare_g2(self, q_affine):
        """The host affine ladder (mnt4/mod.rs:100-154) for one G2 point.

        q_affine: (x2, y2) Montgomery digits [K, n] (tensors or arrays; K =
        2 over Fq2, 3 over Fq3).  Returns tensors on the pairing's device,
        one row a loop step (the addition rows zero where the step has no
        addition): ``dbl_ry, dbl_gx, dbl_gt, add_gx, add_gt`` [steps, K,
        n] and ``q_y`` [K, n], where gt = gamma*T, so that a line on the
        device only scales it by x_P."""
        p = self.fp.modulus
        nr = self._nr
        K = self.sub.K
        hmul, hinv = host_ext.ext_ops(p, nr, K)

        def htwist(a):   # a * X
            return [nr * a[-1] % p] + a[:-1]

        qx = fpmod.fp_to_ints(self.fp, q_affine[0])
        qy = fpmod.fp_to_ints(self.fp, q_affine[1])
        a_tw = self._twist_a_ints
        sx, sy = qx, qy
        rows = {k: [] for k in ("dbl_ry", "dbl_gx", "dbl_gt", "add_gx",
                                "add_gt")}
        for n in self.wnaf:                    # MSB -> LSB
            sxx = hmul(sx, sx)
            num = [(3 * u + v) % p for u, v in zip(sxx, a_tw)]
            gamma = hmul(num, hinv([2 * v % p for v in sy]))
            rows["dbl_ry"].append(sy)
            rows["dbl_gx"].append(hmul(gamma, sx))
            rows["dbl_gt"].append(htwist(gamma))
            nx = [(u - 2 * v) % p for u, v in zip(hmul(gamma, gamma), sx)]
            ny = [(u - v) % p for u, v in zip(
                hmul(gamma, [(i - j) % p for i, j in zip(sx, nx)]), sy)]
            sx, sy = nx, ny
            if n != 0:
                sgn = 1 if n > 0 else -1
                num = [(u - sgn * v) % p for u, v in zip(sy, qy)]
                gamma = hmul(num, hinv([(u - v) % p for u, v in zip(sx, qx)]))
                rows["add_gx"].append(hmul(gamma, qx))
                rows["add_gt"].append(htwist(gamma))
                nx = [(u - v - w) % p
                      for u, v, w in zip(hmul(gamma, gamma), sx, qx)]
                ny = [(u - v) % p for u, v in zip(
                    hmul(gamma, [(i - j) % p for i, j in zip(sx, nx)]), sy)]
                sx, sy = nx, ny
            else:
                rows["add_gx"].append([0] * K)
                rows["add_gt"].append([0] * K)
        rows["q_y"] = [qy]
        nd = self.fp.n_digits
        out = {}
        for k, r in rows.items():
            d = fpmod.fp_from_ints(self.fp, [v for row in r for v in row])
            out[k] = torch.from_numpy(d.reshape(len(r), K, nd)).to(
                self.device)
        out["q_y"] = out["q_y"][0]
        return out

    def miller_loop_prepared(self, p_affine, prep):
        """The Miller loop from prepared lines (mnt4/mod.rs:156-224).
        p_affine: (x, y) [..., 1, n]; prep: ``prepare_g2``'s tensors with
        a matching batch shape in front ([..., steps, K, n]; q_y
        [..., K, n]).  The f*line products are sparse: an affine line's c0
        = T^2*y_P is one base-field element (``mul_by_023`` over Fq4 with
        y_P*nr, ``mul_by_2345`` over Fq6 with y_P)."""
        S, F = self.sub, self.fqk
        K = S.K
        xp, yp = p_affine
        xcol = xp[..., None, :, :]             # broadcast over the steps
        if K == 2:
            a_c0 = self._ynr(yp)

            def line(f, c1):
                return F.mul_by_023(f, a_c0, c1)
        else:
            a_c0, a_nr = yp[..., 0, :], self._ynr(yp)

            def line(f, c1):
                return F.mul_by_2345(f, a_c0, c1, a_nr)
        # every line of the loop at once: doubling c1 = gx - gt*x_P - r_y,
        # addition c1 = gx - gt*x_P -+ q_y (the sign is the digit's)
        lines = S.sub(torch.cat([prep["dbl_gx"], prep["add_gx"]], dim=-3),
                      fpmod.mont_mul(self.fp, torch.cat(
                          [prep["dbl_gt"], prep["add_gt"]], dim=-3), xcol))
        steps = len(self.wnaf)
        c1_dbl = S.sub(lines[..., :steps, :, :], prep["dbl_ry"])
        q_y = prep["q_y"][..., None, :, :]
        c1_add = torch.cat([S.sub(lines[..., steps:, :, :], q_y),
                            S.add(lines[..., steps:, :, :], q_y)], dim=-2)
        batch = q_y.shape[:-3]
        f = F.tensor("one", xp.device).expand(
            batch + (F.K, self.fp.n_digits))
        for i, n in enumerate(self.wnaf):
            f = line(F.sqr(f), c1_dbl[..., i, :, :])
            if n > 0:
                f = line(f, c1_add[..., i, :K, :])
            elif n < 0:
                f = line(f, c1_add[..., i, K:, :])
        if self.ate_is_neg:
            f = F.conjugate(f)
        return f

    # ------------------------------------------------------------------
    # product, final exponentiation
    # ------------------------------------------------------------------

    def product_of_miller(self, f_batch):
        """Multiply Miller values along axis 0 (a tree of products)."""
        return T.ext_product(self.fqk, f_batch)

    def final_exponentiation(self, f):
        """f^((q^k - 1)/r): the easy part elt = f^(q^2 - 1) for MNT4,
        f^((q^3 - 1)(q + 1)) for MNT6 (one Fqk inversion, one K2 launch),
        and its inverse, both in one stacked chain, then the hard part
        elt^(w1*q) * elt^(+-w0) by two cyclotomic power chains."""
        F = self.fqk
        f_inv = F.inv(f)
        both = torch.stack([f, f_inv])
        easy = F.mul(F.frob(both, self.easy_frob), both.flip(0))
        if self.easy_mul_q_plus_1:
            easy = F.mul(F.frob(easy, 1), easy)
        elt, elt_inv = easy[0], easy[1]
        w1_part = T.ext_cyclotomic_pow_const(F, F.frob(elt, 1), self.w1)
        base0 = elt_inv if self.w0_is_neg else elt
        w0_part = T.ext_cyclotomic_pow_const(F, base0, self.w0_abs)
        return F.mul(w1_part, w0_part)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def gt_one(self) -> np.ndarray:
        """The GT identity (host constant)."""
        return self.fqk.one()

    def pairing_prepared(self, p_affine, prep):
        return self.final_exponentiation(self.miller_loop_prepared(
            p_affine, prep))

    def product_of_pairings_prepared(self, p_affines, preps):
        """k pairs, each against a prepared G2 point (a list of
        ``prepare_g2`` results): one prepared loop over the batch of k, the
        product and one final exponentiation."""
        stacked = {k: torch.stack([pr[k] for pr in preps]) for k in preps[0]}
        return self.final_exponentiation(self.product_of_miller(
            self.miller_loop_prepared(p_affines, stacked)))

    def pairing(self, p_affine, q_affine):
        """e(P, Q) for one pair: Q through the host ladder."""
        return self.pairing_prepared(p_affine, self.prepare_g2(q_affine))

    def product_of_pairings(self, p_affines, q_affines):
        """k pairs stacked on axis 0, as ``Bls12Pairing``'s: each G2 point
        through the host ladder, then ``product_of_pairings_prepared``."""
        return self.product_of_pairings_prepared(p_affines, [
            self.prepare_g2((x, y)) for x, y in zip(*q_affines)])
