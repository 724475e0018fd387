"""Short-Weierstrass curves over any ported tower field, batch-first.

Counterpart of ``gingerlib_tpu/curves/sw.py``: one homogeneous-projective
model in mask-select (branch-free) form.

* a point is a tuple (X, Y, Z) of field elements [..., K, n_digits]
  (infinity = (0, 1, 0)),
* addition is unified: the incomplete add is always evaluated, the
  doubling whenever some lane holds equal operands, and the right result
  is selected per lane with ``torch.where``,
* scalar multiplication is a fixed-length MSB-first double-and-add loop
  with a per-lane select; in eager PyTorch its wall time hardly depends on
  the number of lanes, so callers batch independent lanes into one call,
* projective -> affine shares one field inversion across the batch.

The formulas and the order of selects are those of the JAX package, so the
projective coordinates agree with it digit for digit, not just the points.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..fields import towers as T
from ..ops import ec_kernels, limbs
from ..ops import ec_rns as ER


class SWCurveOps:
    """y^2 z = x^3 + a x z^2 + b z^3 over a tower field ``F``.

    ``ec_rns=True`` asks for the RNS multiplies in ``batch_affine_add``
    (``ops/ec_rns.py``; the JAX package's ``GINGERLIB_EC_RNS``).  It exists
    for curves over the base field whose RNS context has at most 64 channels
    a base, and construction raises for any other curve."""

    def __init__(self, name: str, field_ops, a_host, b_host,
                 generator_host=None, cofactor: int = 1,
                 scalar_field=None, cofactor_inv: int | None = None,
                 device=None, ec_rns: bool = False):
        self.device = resolve_device(device)
        self.name = name
        self.F = field_ops
        self.fp = field_ops.fp
        if ec_rns and not ER.supports(self):
            raise NotImplementedError(
                f"{name}: the RNS affine addition covers curves over the "
                f"base field with at most {ER.RK.B_ROW} channels a base")
        self.ec_rns = ec_rns
        a_np = field_ops.const(a_host)
        self.a = torch.from_numpy(a_np).to(self.device)
        self.b = torch.from_numpy(field_ops.const(b_host)).to(self.device)
        self.a_host = a_host
        self.generator_host = generator_host
        self.a_is_zero = not a_np.any()
        self.cofactor = cofactor
        self.cofactor_inv = cofactor_inv
        self.scalar_field = scalar_field  # FpParams of Fr
        if generator_host is not None:
            self.generator_affine = self.affine_from_ints(*generator_host)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    def _shape(self, batch_shape):
        return tuple(batch_shape) + (self.F.K, self.fp.n_digits)

    def zero(self, batch_shape=()):
        shape = self._shape(batch_shape)
        z = self.F.tensor("zero", self.device).expand(shape)
        return (z, self.F.tensor("one", self.device).expand(shape), z)

    def generator(self, batch_shape=()):
        gx, gy = self.generator_affine
        shape = self._shape(batch_shape)
        return (gx.expand(shape), gy.expand(shape),
                self.F.tensor("one", self.device).expand(shape))

    def from_affine(self, x, y):
        return (x, y, self.F.tensor("one", x.device).expand(x.shape))

    def affine_from_ints(self, x_comps, y_comps):
        return (torch.from_numpy(self.F.const(x_comps)).to(self.device),
                torch.from_numpy(self.F.const(y_comps)).to(self.device))

    # ------------------------------------------------------------------
    # predicates
    # ------------------------------------------------------------------

    def is_zero(self, P):
        return self.F.is_zero(P[2])

    def eq(self, P, Q):
        """Projective equality (cross-multiplied), including infinity."""
        F = self.F
        x1, y1, z1 = P
        x2, y2, z2 = Q
        both_zero = self.is_zero(P) & self.is_zero(Q)
        one_zero = self.is_zero(P) ^ self.is_zero(Q)
        ex = F.eq(F.mul(x1, z2), F.mul(x2, z1))
        ey = F.eq(F.mul(y1, z2), F.mul(y2, z1))
        return both_zero | (ex & ey & ~one_zero)

    # ------------------------------------------------------------------
    # group law (branch-free)
    # ------------------------------------------------------------------

    def neg(self, P):
        x, y, z = P
        return (x, self.F.neg(y), z)

    def double(self, P):
        """dbl-2007-bl homogeneous doubling; infinity and points with
        Y = 0 are masked to the canonical infinity."""
        F = self.F
        X1, Y1, Z1 = P
        XX = F.sqr(X1)
        ZZ = F.sqr(Z1)
        three_xx = F.add(F.double(XX), XX)
        if self.a_is_zero:
            w = three_xx
        else:
            w = F.add(F.mul(self.a, ZZ), three_xx)
        s = F.double(F.mul(Y1, Z1))
        ss = F.sqr(s)
        sss = F.mul(s, ss)
        R = F.mul(Y1, s)
        RR = F.sqr(R)
        B = F.sub(F.sub(F.sqr(F.add(X1, R)), XX), RR)
        h = F.sub(F.sqr(w), F.double(B))
        X3 = F.mul(h, s)
        Y3 = F.sub(F.mul(w, F.sub(B, h)), F.double(RR))
        Z3 = sss
        inf = self.is_zero(P) | F.is_zero(Y1)
        return self._select(inf, self.zero(X1.shape[:-2]), (X3, Y3, Z3))

    def add(self, P, Q):
        """Unified addition: right for all inputs via per-lane select."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        # add-1998-cmo-2 incomplete path
        Y1Z2 = F.mul(Y1, Z2)
        X1Z2 = F.mul(X1, Z2)
        Z1Z2 = F.mul(Z1, Z2)
        u = F.sub(F.mul(Y2, Z1), Y1Z2)
        v = F.sub(F.mul(X2, Z1), X1Z2)
        uu = F.sqr(u)
        vv = F.sqr(v)
        vvv = F.mul(v, vv)
        Rv = F.mul(vv, X1Z2)
        A = F.sub(F.sub(F.mul(uu, Z1Z2), vvv), F.double(Rv))
        X3 = F.mul(v, A)
        Y3 = F.sub(F.mul(u, F.sub(Rv, A)), F.mul(vvv, Y1Z2))
        Z3 = F.mul(vvv, Z1Z2)

        same_x = F.is_zero(v)
        same_y = F.is_zero(u)
        p_inf = self.is_zero(P)
        out = self._select_doubled(same_x & same_y, p_inf, P, (X3, Y3, Z3))
        out = self._select(same_x & ~same_y,
                           self.zero(X1.shape[:-2]), out)          # P == -Q
        out = self._select(self.is_zero(Q), P, out)
        out = self._select(p_inf, Q, out)
        return out

    def add_mixed(self, P, xy):
        """P + affine(x, y), which saves the Z2 multiplications.  The affine
        point must not be infinity (callers mask that case themselves)."""
        F = self.F
        X1, Y1, Z1 = P
        x2, y2 = xy
        u = F.sub(F.mul(y2, Z1), Y1)
        v = F.sub(F.mul(x2, Z1), X1)
        uu = F.sqr(u)
        vv = F.sqr(v)
        vvv = F.mul(v, vv)
        Rv = F.mul(vv, X1)
        A = F.sub(F.sub(F.mul(uu, Z1), vvv), F.double(Rv))
        X3 = F.mul(v, A)
        Y3 = F.sub(F.mul(u, F.sub(Rv, A)), F.mul(vvv, Y1))
        Z3 = F.mul(vvv, Z1)

        same_x = F.is_zero(v)
        same_y = F.is_zero(u)
        p_inf = self.is_zero(P)
        out = self._select_doubled(same_x & same_y, p_inf, P, (X3, Y3, Z3))
        out = self._select(same_x & ~same_y,
                           self.zero(X1.shape[:-2]), out)
        out = self._select(p_inf, self.from_affine(x2, y2), out)
        return out

    def _select_doubled(self, mask, p_inf, P, out):
        """Lanes of ``mask`` (the operands were equal) take 2P.  The
        doubling is as dear as the addition itself and almost never
        wanted, so it is evaluated only if some lane asks for it -- eager
        PyTorch may branch on data; the price is one read-back of a flag.
        Lanes where P is infinity also raise ``mask`` (both cross products
        vanish) but are overwritten by the caller's later select on
        ``p_inf``, so they do not count as asking.  The values are those of
        the always-evaluated form."""
        if not bool((mask & ~p_inf).any()):
            return out
        return self._select(mask, self.double(P), out)

    def batch_affine_add(self, a_pt, b_pt):
        """Pairwise affine addition with ONE shared inversion for the whole
        batch: about 4 multiplies an addition plus 3 for the inversion tree,
        against 14 for the unified projective form.

        a_pt, b_pt: ((x, y), inf) with x, y [N, K, nd] and inf [N] bool;
        infinity is the flag, with (0, 0) as coordinates.  Right for equal
        points, opposite points and infinity on either side.  Returns
        ((x3, y3), inf3).

        Curves over the base field go through the fused kernels on a GPU
        (pre, inversion tree, post: ``ops/ec_kernels.py``, or with
        ``ec_rns`` the RNS kernels of ``ops/ec_rns.py``) and through their
        plain versions on the CPU; curves over an extension field (G2) run
        the array form on either device."""
        if self.ec_rns:
            return ER.batch_affine_add_rns(self, a_pt, b_pt)
        if self.F.K == 1:
            return ec_kernels.batch_affine_add(self, a_pt, b_pt)
        return ec_kernels.batch_affine_add_plain(self, a_pt, b_pt)

    def _select(self, mask, A, B):
        m = mask[..., None, None]
        return tuple(torch.where(m, a, b) for a, b in zip(A, B))

    select = _select

    # ------------------------------------------------------------------
    # scalar multiplication
    # ------------------------------------------------------------------

    def mul_bits(self, P, bits):
        """[k]P with per-lane scalars given as bits [..., nbits], MSB
        first.  Fixed-trip double-and-add."""
        acc = self.zero(P[0].shape[:-2])
        for bit in bits.unbind(-1):
            acc = self.double(acc)
            acc = self._select(bit != 0, self.add(acc, P), acc)
        return acc

    def mul_scalar_digits(self, P, scalar_digits):
        """[k]P where k is a standard-form digit tensor [..., nd]: one step
        per scalar bit, 16*nd in all."""
        return self.mul_bits(P, limbs.scalar_bits_msb_first(scalar_digits))

    def mul_const(self, P, k: int):
        """[k]P for a fixed host integer k."""
        if k == 0:
            return self.zero(P[0].shape[:-2])
        bits = torch.from_numpy(limbs.bits_msb_first(k, k.bit_length()))
        bits = bits.to(P[0].device).expand(P[0].shape[:-2] + bits.shape)
        return self.mul_bits(P, bits)

    # ------------------------------------------------------------------
    # normalization / conversion
    # ------------------------------------------------------------------

    def to_affine(self, P):
        """Projective -> affine, (0, 0) for infinity.  A batch shares ONE
        field inversion through the product tree."""
        F = self.F
        X, Y, Z = P
        batch = Z.shape[:-2]
        if batch and Z.numel() > Z.shape[-1] * Z.shape[-2]:
            flat = Z.reshape((-1,) + Z.shape[-2:])
            zinv = T.ext_batch_inverse_tree(F, flat).reshape(Z.shape)
        else:
            zinv = F.inv(Z)  # 0 -> 0
        return F.mul(X, zinv), F.mul(Y, zinv)

    def on_curve(self, x, y):
        """Affine curve membership: y^2 == x^3 + ax + b."""
        F = self.F
        lhs = F.sqr(y)
        rhs = F.add(F.mul(F.add(F.sqr(x), self.a), x), self.b)
        return F.eq(lhs, rhs)
