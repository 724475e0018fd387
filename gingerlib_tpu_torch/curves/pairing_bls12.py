"""The BLS12 ate pairing on tensors (curves/models/bls12/{mod,g1,g2}.rs).

Counterpart of ``gingerlib_tpu/curves/pairing_bls12.py``, the same values
digit for digit: the G2 line coefficients on the device in homogeneous
projective coordinates (``_prepare_g2``: doubling_step / addition_step,
bls12/g2.rs:115-165), the Miller loop over the bits of x, f times each
line by the sparse Fq12 multiplies (``mul_by_034`` for the D-twist of
BLS12-377, ``mul_by_014`` for the M-twist of BLS12-381; basis [1, v, v^2,
w, vw, v^2 w]), the conjugate where x is negative (BLS12-381), and the
final exponentiation of eprint 2016/130, Table 1 (bls12/mod.rs:148-205),
its five powers by x through ``ext_cyclotomic_pow_const`` (Granger-Scott
squares).

Launches: a doubling step makes its Fq2 products in three stacked Fq2
products, an addition step in four; all lines of a loop are scaled by
x_P and y_P in one launch before it, and each f * line is one Fq2 product
of 13 elements (``QuadExtOps.mul_by_014`` / ``mul_by_034``).  The bits of
x are host constants: a step makes its addition only where its bit is
set, a branch on the host.  Everything batches over leading axes: a batch
of pairs runs one loop.
"""

from __future__ import annotations

import torch

from ..fields import fp as fpmod
from ..fields import towers as T
from .sw import SWCurveOps


class Bls12Pairing:
    def __init__(self, name: str, g1: SWCurveOps, g2: SWCurveOps, fq6, fq12,
                 x: int, x_is_neg: bool, twist_type: str):
        """fq6, fq12: GT's tower over g2's Fq2 (``build_bls12_towers``);
        x: the curve's parameter |x|, ``x_is_neg`` its sign; twist_type
        "D" (BLS12-377) or "M" (BLS12-381)."""
        if g1.device != g2.device:
            raise ValueError(f"G1 on {g1.device}, G2 on {g2.device}")
        if twist_type not in ("D", "M"):
            raise ValueError(f"twist type {twist_type!r}")
        self.name = name
        self.g1 = g1
        self.g2 = g2
        self.device = g1.device
        self.fqk = fq12
        self.fq6 = fq6
        self.sub = g2.F            # Fq2
        self.fp = g1.fp
        self.x = x
        self.x_is_neg = x_is_neg
        self.twist_type = twist_type
        self.x_bits = bin(x)[3:]   # the loop's bits, MSB skipped
        p = self.fp.modulus
        self._two_inv = torch.from_numpy(fpmod.fp_from_int(
            self.fp, pow(2, -1, p))).to(self.device)

    # ------------------------------------------------------------------
    # G2 line coefficients
    # ------------------------------------------------------------------

    def _prepare_g2(self, q_affine):
        """The line coefficients (c0, c1, c2) of every step of the loop, in
        the order the loop uses them: [..., steps, 3, 2, n] for G2 points
        q_affine = (x, y) [..., 2, n]."""
        S = self.sub
        qx, qy = torch.broadcast_tensors(*q_affine)
        rx, ry = qx, qy
        rz = S.tensor("one", qx.device).expand(qx.shape)
        b2 = self.g2.b
        two_inv = self._two_inv
        M = self.twist_type == "M"

        def st(*xs):
            return torch.stack(torch.broadcast_tensors(*xs), dim=-3)

        def dstep(rx, ry, rz):
            # rx ry, ry^2, rz^2, rx^2, (ry + rz)^2
            ryz = S.add(ry, rz)
            v = S.mul(st(rx, ry, rz, rx, ryz), st(ry, ry, rz, rx, ryz))
            rxry, b, c, j, s = v.unbind(-3)
            c3 = S.add(S.double(c), c)
            e = S.mul(b2, c3)
            f = S.add(S.double(e), e)
            a = S.scale_fp(rxry, two_inv)
            g = S.scale_fp(S.add(b, f), two_inv)
            h = S.sub(s, S.add(b, c))
            i_ = S.sub(e, b)
            # e^2, a (b - f), g^2, b h
            w = S.mul(st(e, a, g, b), st(e, S.sub(b, f), g, h))
            e2, nx, g2_, nz = w.unbind(-3)
            ny = S.sub(g2_, S.add(S.double(e2), e2))
            j3 = S.add(S.double(j), j)
            co = (i_, j3, S.neg(h)) if M else (S.neg(h), j3, i_)
            return (nx, ny, nz), st(*co)

        def astep(rx, ry, rz):
            u = S.mul(st(qy, qx), st(rz, rz))
            theta = S.sub(ry, u[..., 0, :, :])
            lam = S.sub(rx, u[..., 1, :, :])
            # theta^2, lam^2, theta qx, lam qy
            v = S.mul(st(theta, lam, theta, lam), st(theta, lam, qx, qy))
            cc, d, tqx, lqy = v.unbind(-3)
            w = S.mul(st(lam, rz, rx), st(d, cc, d))
            e, f, g = w.unbind(-3)
            h = S.sub(S.add(e, f), S.double(g))
            # lam h, theta (g - h), e ry, rz e
            y = S.mul(st(lam, theta, e, rz), st(h, S.sub(g, h), ry, e))
            nx, t1, t2, nz = y.unbind(-3)
            ny = S.sub(t1, t2)
            j = S.sub(tqx, lqy)
            nt = S.neg(theta)
            co = (j, nt, lam) if M else (lam, nt, j)
            return (nx, ny, nz), st(*co)

        coeffs = []
        for bit in self.x_bits:
            (rx, ry, rz), co = dstep(rx, ry, rz)
            coeffs.append(co)
            if bit == "1":
                (rx, ry, rz), co = astep(rx, ry, rz)
                coeffs.append(co)
        return torch.stack(coeffs, dim=-4)

    # ------------------------------------------------------------------
    # the Miller loop, the final exponentiation
    # ------------------------------------------------------------------

    def miller_loop(self, p_affine, q_affine):
        """p_affine: (x, y) [..., 1, n] of G1; q_affine: (x, y) [..., 2, n]
        of G2; leading axes broadcast.  Returns f [..., 12, n]."""
        F, fp = self.fqk, self.fp
        px, py = p_affine[0][..., 0, :], p_affine[1][..., 0, :]
        co = self._prepare_g2(q_affine)           # [..., steps, 3, 2, n]
        # every line of the loop scaled at once: (c1 x_P, c2 y_P) for the
        # M-twist, (c0 y_P, c1 x_P) for D
        idx, by = ([1, 2], (px, py)) if self.twist_type == "M" else \
            ([0, 1], (py, px))
        scaled = fpmod.mont_mul(fp, co[..., idx, :, :], torch.stack(
            torch.broadcast_tensors(*by), dim=-2)[..., None, :, None, :])
        c = list(co.unbind(-3))
        for j, i in enumerate(idx):
            c[i] = scaled[..., j, :, :]
        line = F.mul_by_014 if self.twist_type == "M" else F.mul_by_034
        batch = torch.broadcast_shapes(*(ci.shape[:-3] for ci in c))
        f = F.tensor("one", px.device).expand(batch + (F.K, fp.n_digits))
        k = 0
        for bit in self.x_bits:
            f = line(F.sqr(f), *(ci[..., k, :, :] for ci in c))
            k += 1
            if bit == "1":
                f = line(f, *(ci[..., k, :, :] for ci in c))
                k += 1
        return F.conjugate(f) if self.x_is_neg else f

    def _exp_by_x(self, f):
        """f^x for unitary f (every input of the hard part is): NAF digits
        with Granger-Scott squarings."""
        g = T.ext_cyclotomic_pow_const(self.fqk, f, self.x)
        return self.fqk.conjugate(g) if self.x_is_neg else g

    def final_exponentiation(self, f):
        """f^((q^12 - 1)/r): the easy part f^((q^6 - 1)(q^2 + 1)) (one
        Fq12 inversion, one K2 launch) and the hard part of 2016/130,
        Table 1."""
        F = self.fqk
        r = F.mul(F.conjugate(f), F.inv(f))
        r = F.mul(F.frob(r, 2), r)
        y0 = F.conjugate(F.cyclotomic_square(r))
        y5 = self._exp_by_x(r)
        y1 = F.cyclotomic_square(y5)
        y3 = F.mul(y0, y5)
        y0 = self._exp_by_x(y3)
        y2 = self._exp_by_x(y0)
        y4 = F.mul(self._exp_by_x(y2), y1)
        y1 = F.mul(F.mul(self._exp_by_x(y4), F.conjugate(y3)), r)
        y0 = F.frob(F.mul(y0, r), 3)
        y4 = F.frob(F.mul(y4, F.conjugate(r)), 1)
        y5 = F.frob(F.mul(y5, y2), 2)
        return F.mul(F.mul(F.mul(y5, y0), y4), y1)

    # ------------------------------------------------------------------
    # public API (that of the JAX package's Bls12Pairing)
    # ------------------------------------------------------------------

    def pairing(self, p_affine, q_affine):
        return self.final_exponentiation(self.miller_loop(p_affine,
                                                          q_affine))

    def product_of_miller(self, f_batch):
        """Multiply Miller values along axis 0 (a tree of products)."""
        return T.ext_product(self.fqk, f_batch)

    def product_of_pairings(self, p_affines, q_affines):
        """k pairs stacked on axis 0: one Miller loop over the batch, the
        product and one final exponentiation."""
        return self.final_exponentiation(self.product_of_miller(
            self.miller_loop(p_affines, q_affines)))
