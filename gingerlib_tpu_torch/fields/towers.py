"""Extension-field towers as batched flat component tensors.

Counterpart of ``gingerlib_tpu/fields/towers.py``, as far as the proving path
needs it: the base field with a unit component axis (``FpOps``) and the
quadratic extension (``QuadExtOps``) that carries G2 of MNT4-753 and
BLS12-377.  The higher towers (Fq4, Fq3/Fq6, Fq12) and the cyclotomic and
sparse-line methods belong to the pairing and are not ported yet.

An element of a degree-K tower is an int64 tensor [..., K, n_digits] whose K
components are in Montgomery form.  Constants (``one()``, ``const()``) are
host numpy arrays; ``tensor(name, device)`` hands out cached device copies.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp as fpmod
from .fp import FpParams
from . import host_ext
from ..ops.limbs import NP_DTYPE


def _flatten_host(v):
    """Nested int tuple/list -> flat list of ints (depth-first)."""
    if isinstance(v, int):
        return [v]
    out = []
    for c in v:
        out.extend(_flatten_host(c))
    return out


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
        vs = _flatten_host(v)
        if len(vs) != self.K:
            raise ValueError(f"expected {self.K} components, got {len(vs)}")
        return fpmod.fp_from_ints(self.fp, vs)

    def tensor(self, name: str, device) -> torch.Tensor:
        """The host constant that method ``name`` returns (``zero``,
        ``one``, ...) as a cached tensor on ``device``."""
        key = (name, str(device))
        hit = self._tensors.get(key)
        if hit is None:
            hit = torch.from_numpy(getattr(self, name)()).to(device)
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

    def frob(self, a, i: int):
        return a


class QuadExtOps(_FieldBase):
    """Fp2 = Fp[X]/(X^2 - nonresidue): x = a0 + a1*X as [..., 2, n_digits].

    Only over the base field: the three base multiplies of a Karatsuba
    product (and of a square) are stacked into ONE Montgomery multiply of
    [..., 3, n_digits], a third of the launches of three separate calls and
    the same values.
    """

    def __init__(self, name, sub: FpOps, nonresidue_host, frob_c1_host):
        super().__init__()
        if not isinstance(sub, FpOps):
            raise NotImplementedError(
                "towers above the quadratic extension of the base field "
                "come with the pairing")
        self.name = name
        self.sf = sub
        self.fp = sub.fp
        self.K = 2
        self._nr_host = sub.const(nonresidue_host)           # [1, n]
        self._frob_c1_host = [sub.const(c) for c in frob_c1_host]

    def one(self) -> np.ndarray:
        z = self.zero()
        z[:1] = self.sf.one()
        return z

    def nonresidue(self) -> np.ndarray:
        return self._nr_host

    def _karatsuba(self, v, t):
        """(v0, v1, (a0+a1)(b0+b1)) -> (v0 + nr*v1, t - v0 - v1)."""
        v0, v1 = v[..., 0:1, :], v[..., 1:2, :]
        S = self.sf
        c0 = S.add(v0, S.mul(v1, self.tensor("nonresidue", v.device)))
        c1 = S.sub(S.sub(t, v0), v1)
        return torch.cat([c0, c1], dim=-2)

    def mul(self, x, y):
        S = self.sf
        x, y = torch.broadcast_tensors(x, y)
        xs = torch.cat([x, S.add(x[..., 0:1, :], x[..., 1:2, :])], dim=-2)
        ys = torch.cat([y, S.add(y[..., 0:1, :], y[..., 1:2, :])], dim=-2)
        v = S.mul(xs, ys)                       # v0, v1, t
        return self._karatsuba(v, v[..., 2:3, :])

    def sqr(self, x):
        S = self.sf
        xs = torch.cat([x, S.add(x[..., 0:1, :], x[..., 1:2, :])], dim=-2)
        v = S.mul(xs, xs)
        return self._karatsuba(v, v[..., 2:3, :])

    def inv(self, x):
        S = self.sf
        a0, a1 = x[..., 0:1, :], x[..., 1:2, :]
        sq = S.mul(x, x)                        # a0^2, a1^2
        norm = S.sub(sq[..., 0:1, :],
                     S.mul(sq[..., 1:2, :], self.tensor("nonresidue", x.device)))
        t = S.inv(norm)
        xt = S.mul(x, t)                        # a0*t, a1*t
        return torch.cat([xt[..., 0:1, :], S.neg(xt[..., 1:2, :])], dim=-2)

    def conjugate(self, x):
        return torch.cat([x[..., 0:1, :], self.sf.neg(x[..., 1:2, :])],
                         dim=-2)

    def frob(self, x, i: int):
        c = torch.from_numpy(self._frob_c1_host[i % 2]).to(x.device)
        return torch.cat([x[..., 0:1, :], self.sf.mul(x[..., 1:2, :], c)],
                         dim=-2)

    def mul_by_sub(self, x, s):
        """Multiply by a base-field element s [..., 1, n] (sparse)."""
        return self.sf.mul(x, s)


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


def build_quadratic_tower(fq_params: FpParams, nr2: int):
    """Fq -> Fq2 (X^2 = nr2): the part of the MNT4 and BLS12 towers that the
    G1/G2 arithmetic uses.  Returns (base, fq2)."""
    base = FpOps(fq_params)
    fq2 = QuadExtOps(f"{fq_params.name}2", base, nr2,
                     host_ext.frob_table_fp2(fq_params.modulus, nr2))
    return base, fq2


# The MNT4 tower Fq -> Fq2 -> Fq4 stops at Fq2 until the pairing is ported.
build_mnt4_towers = build_quadratic_tower
