"""Twisted-Edwards curves (Jubjub, Edwards-BLS12, Edwards-SW6), batch-first.

Counterpart of ``gingerlib_tpu/curves/twisted_edwards.py``: projective
(X : Y : Z) points with the complete add-2008-bbjlp and dbl-2008-bbjlp
formulas (complete where a is a square and d is not, which holds for these
curves), so no lane needs a select; the identity is (0 : 1 : 1).

* a point is a tuple (X, Y, Z) of base-field elements [..., 1, n_digits];
* the independent products of one formula go into ONE field multiply, the
  operands stacked on a new leading axis (as ``fields/towers.py`` stacks a
  tower's products): five multiply launches an addition and three a
  doubling where a = -1 (all three curves), one more each for another a.
  Every Montgomery product is canonical, so the coordinates are those of
  the JAX package's one-after-another calls, digit for digit;
* scalar multiplication: ``mul_bits`` / ``mul_scalar_digits`` /
  ``mul_const`` take the JAX package's scalars (bits, digits, one int)
  and run them, a scalar a lane, through ``points.mul_ints``: one loop of
  4-bit windows for the whole batch;
* projective -> affine shares one field inversion across a batch.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..fields import towers as T
from ..ops import limbs
from . import points


def products(F, pairs):
    """The products a_i * b_i of ``pairs`` as ONE multiply over ``F``: the
    operands broadcast to one shape and stacked on a new leading axis.
    Returns the products in order."""
    shape = torch.broadcast_shapes(*(t.shape for pair in pairs
                                     for t in pair))
    a = torch.stack([x.expand(shape) for x, _ in pairs])
    b = torch.stack([y.expand(shape) for _, y in pairs])
    return F.mul(a, b).unbind(0)


class TECurveOps:
    """a x^2 + y^2 = 1 + d x^2 y^2 over a prime field ``field_ops``
    (``towers.FpOps``), on ``device`` (``None``: the GPU).

    ``mont_a`` and ``mont_b`` are the birationally equivalent Montgomery
    curve's B y^2 = x^3 + A x^2 + x (MontgomeryModelParameters,
    models/mod.rs:104-120), kept for the in-circuit Montgomery-ladder
    allocation."""

    def __init__(self, name: str, field_ops, a_host: int, d_host: int,
                 generator_host=None, cofactor: int = 1,
                 scalar_field=None, cofactor_inv: int | None = None,
                 mont_a: int | None = None, mont_b: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.name = name
        self.F = field_ops
        self.fp = field_ops.fp
        p = self.fp.modulus
        self.a_host = a_host
        self.d_host = d_host
        self.a = torch.from_numpy(field_ops.const(a_host)).to(self.device)
        self.d = torch.from_numpy(field_ops.const(d_host)).to(self.device)
        # a = -1: a * x is a negation, not a product
        self.a_is_minus_one = a_host % p == p - 1
        self.cofactor = cofactor
        self.cofactor_inv = cofactor_inv
        self.scalar_field = scalar_field        # FpParams of Fr
        self.mont_a = mont_a
        self.mont_b = mont_b
        self.generator_host = generator_host
        if generator_host is not None:
            self.generator_affine = self.affine_from_ints(*generator_host)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    def _shape(self, batch_shape):
        return tuple(batch_shape) + (1, self.fp.n_digits)

    def _one(self, shape):
        return self.F.tensor("one", self.device).expand(shape)

    def zero(self, batch_shape=()):
        shape = self._shape(batch_shape)
        z = self.F.tensor("zero", self.device).expand(shape)
        return (z, self._one(shape), self._one(shape))

    def generator(self, batch_shape=()):
        gx, gy = self.generator_affine
        shape = self._shape(batch_shape)
        return (gx.expand(shape), gy.expand(shape), self._one(shape))

    def from_affine(self, x, y):
        return (x, y, self.F.tensor("one", x.device).expand(x.shape))

    def affine_from_ints(self, x: int, y: int):
        """Host ints (standard form) -> affine coordinates [1, nd]."""
        return (torch.from_numpy(self.F.const(x)).to(self.device),
                torch.from_numpy(self.F.const(y)).to(self.device))

    # ------------------------------------------------------------------
    # predicates
    # ------------------------------------------------------------------

    def is_zero(self, P):
        X, Y, Z = P
        return self.F.is_zero(X) & self.F.eq(Y, Z)

    def eq(self, P, Q):
        """Projective equality (cross-multiplied)."""
        x1, y1, z1 = P
        x2, y2, z2 = Q
        a, b, c, d = products(self.F, ((x1, z2), (x2, z1), (y1, z2),
                                       (y2, z1)))
        return self.F.eq(a, b) & self.F.eq(c, d)

    # ------------------------------------------------------------------
    # group law (complete)
    # ------------------------------------------------------------------

    def neg(self, P):
        X, Y, Z = P
        return (self.F.neg(X), Y, Z)

    def _times_a(self, x):
        return self.F.neg(x) if self.a_is_minus_one else \
            self.F.mul(self.a, x)

    def add(self, P, Q):
        """add-2008-bbjlp: complete."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        A, C, D, S = products(F, ((Z1, Z2), (X1, X2), (Y1, Y2),
                                  (F.add(X1, Y1), F.add(X2, Y2))))
        if self.a_is_minus_one:
            B, dC = products(F, ((A, A), (self.d, C)))
            aC = F.neg(C)
        else:
            B, dC, aC = products(F, ((A, A), (self.d, C), (self.a, C)))
        E = F.mul(dC, D)
        Fv = F.sub(B, E)
        G = F.add(B, E)
        AF, AG, Z3 = products(F, ((A, Fv), (A, G), (Fv, G)))
        X3, Y3 = products(F, ((AF, F.sub(F.sub(S, C), D)),
                              (AG, F.sub(D, aC))))
        return (X3, Y3, Z3)

    def double(self, P):
        """dbl-2008-bbjlp."""
        F = self.F
        X1, Y1, Z1 = P
        B, C, D, H = products(F, ((F.add(X1, Y1),) * 2, (X1, X1),
                                  (Y1, Y1), (Z1, Z1)))
        E = self._times_a(C)
        Fv = F.add(E, D)
        J = F.sub(Fv, F.double(H))
        X3, Y3, Z3 = products(F, ((F.sub(F.sub(B, C), D), J),
                                  (Fv, F.sub(E, D)), (Fv, J)))
        return (X3, Y3, Z3)

    def select(self, mask, A, B):
        m = mask[..., None, None]
        return tuple(torch.where(m, a, b) for a, b in zip(A, B))

    # ------------------------------------------------------------------
    # scalar multiplication
    # ------------------------------------------------------------------

    def _mul_lanes(self, P, ks, batch):
        """[k_i] P_i over a batch of shape ``batch`` (P broadcast to it),
        ``ks`` the host scalars in row-major lane order: ONE
        ``points.mul_ints`` loop for every lane."""
        flat = tuple(c.expand(batch + c.shape[-2:])
                     .reshape((-1,) + c.shape[-2:]) for c in P)
        out = points.mul_ints(self, flat, ks)
        return tuple(c.reshape(batch + c.shape[-2:]) for c in out)

    def mul_bits(self, P, bits):
        """[k]P with per-lane scalars given as bits [..., nbits], MSB
        first."""
        batch = torch.broadcast_shapes(P[0].shape[:-2], bits.shape[:-1])
        rows = bits.expand(batch + bits.shape[-1:]).reshape(
            -1, bits.shape[-1]).cpu().tolist()
        return self._mul_lanes(P, [int("".join(
            "1" if b else "0" for b in row) or "0", 2) for row in rows],
            batch)

    def mul_scalar_digits(self, P, scalar_digits):
        """[k]P where k is a standard-form digit tensor [..., nd]."""
        batch = torch.broadcast_shapes(P[0].shape[:-2],
                                       scalar_digits.shape[:-1])
        return self._mul_lanes(P, limbs.from_digits_batch(
            scalar_digits.expand(batch + scalar_digits.shape[-1:])), batch)

    def mul_const(self, P, k: int):
        """[k]P for a fixed host integer k >= 0, every lane of P."""
        batch = P[0].shape[:-2]
        return self._mul_lanes(P, [k] * batch.numel(), batch)

    # ------------------------------------------------------------------
    # normalization
    # ------------------------------------------------------------------

    def to_affine(self, P):
        """Projective -> affine.  A batch shares ONE field inversion (the
        product tree of ``towers.ext_batch_inverse_tree``)."""
        X, Y, Z = P
        if Z.shape[:-2] and Z.numel() > Z.shape[-1] * Z.shape[-2]:
            flat = Z.reshape((-1,) + Z.shape[-2:])
            zinv = T.ext_batch_inverse_tree(self.F, flat).reshape(Z.shape)
        else:
            zinv = self.F.inv(Z)
        return products(self.F, ((X, zinv), (Y, zinv)))

    def on_curve(self, x, y):
        """Affine membership: a x^2 + y^2 == 1 + d x^2 y^2."""
        F = self.F
        xx, yy = products(F, ((x, x), (y, y)))
        dxx = F.mul(self.d, xx)
        lhs = F.add(self._times_a(xx), yy)
        rhs = F.add(self._one(xx.shape), F.mul(dxx, yy))
        return F.eq(lhs, rhs)

