"""What the port's twisted-Edwards, Pedersen and signature tests share on the
JAX side and in python ints.

* ``jax_te_ops(name)``: the JAX curve and ONE jit of its add, double, neg,
  eq, to_affine and on_curve on 4 lanes -- each XLA compile of a 255-bit
  curve formula costs seconds on XLA:CPU, so every JAX comparison of the
  three files goes through this one function;
* ``JaxLanes``: the JAX curve with its add, double and neg run through that jit
  (a batch cut into 4-lane pieces, the last one padded with the identity;
  the formulas act lane by lane, so no value changes), handed to the JAX
  package's Pedersen and Bowe-Hopwood classes as their curve;
* host points and chains through the TE gadget's ``_host_add`` and
  ``_host_double`` (the python-int twisted-Edwards arithmetic), and digit
  arrays of the JAX package's layout (uint32 Montgomery digits) made from
  them with numpy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gingerlib_tpu.curves import instances as JCI
from gingerlib_tpu.fields import fp as jfp

LANES = 4


@functools.lru_cache()
def jax_te_ops(name: str):
    """(JAX curve, jit of (P, Q) -> its ops on 4 lanes)."""
    te = getattr(JCI, name)()

    @jax.jit
    def ops(P, Q):
        x, y = te.to_affine(P)
        return {"add": te.add(P, Q), "double": te.double(P),
                "neg": te.neg(P), "eq": te.eq(P, Q), "x": x, "y": y,
                "on_curve": te.on_curve(x, y)}

    return te, ops


class JaxLanes:
    """A JAX TE curve whose add, double and neg go through
    ``jax_te_ops``."""

    def __init__(self, name: str):
        self.te, self.ops = jax_te_ops(name)

    def __getattr__(self, attr):
        return getattr(self.te, attr)

    def add(self, P, Q):
        return self._run("add", P, Q)

    def double(self, P):
        return self._run("double", P, P)

    def neg(self, P):
        return self._run("neg", P, P)

    def _run(self, key, P, Q):
        if P[0].ndim == 2:             # one point: a batch of one
            out = self._run(key, *(tuple(c[None] for c in X)
                                   for X in (P, Q)))
            return tuple(c[0] for c in out)
        n = P[0].shape[0]
        out = []
        for i in range(0, n, LANES):
            m = min(LANES, n - i)
            pad = self.te.zero((LANES - m,))
            p, q = (tuple(jnp.concatenate([c[i:i + m], z]) for c, z in
                          zip(X, pad)) for X in (P, Q))
            out.append(tuple(c[:m] for c in self.ops(p, q)[key]))
        return tuple(jnp.concatenate(c) for c in zip(*out))


def host_mul(gg, P, k: int):
    """[k] P in python ints (double-and-add over the TE gadget's host
    helpers), P affine (x, y)."""
    acc = (0, 1)
    for bit in bin(k)[2:]:
        acc = gg._host_double(acc)
        if bit == "1":
            acc = gg._host_add(acc, P)
    return acc


def host_chain(gg, base, length: int, doublings: int):
    """base, 2^d base, 2^2d base ... (length points)."""
    out, cur = [], base
    for _ in range(length):
        out.append(cur)
        for _ in range(doublings):
            cur = gg._host_double(cur)
    return out


def jax_points(fparams, xys, zs=None):
    """Affine host points -> a projective triple of the JAX package's
    layout ([n, 1, nd] uint32 Montgomery digits), scaled by ``zs`` (host
    ints) where given."""
    p = fparams.modulus
    zs = zs or [1] * len(xys)
    cols = [[x * z % p for (x, _), z in zip(xys, zs)],
            [y * z % p for (_, y), z in zip(xys, zs)], zs]
    return tuple(np.asarray(jfp.fp_from_ints(fparams, c)).reshape(
        len(xys), 1, -1) for c in cols)


def affine_of(fparams, P):
    """A projective triple (numpy or tensor digits, [n, 1, nd]) -> host
    affine pairs."""
    p = fparams.modulus

    def ints(c):
        return jfp.fp_to_ints(fparams, np.asarray(c).astype(np.uint32)
                              .reshape(-1, np.asarray(c).shape[-1]))
    X, Y, Z = (ints(c) for c in P)
    return [(x * pow(z, -1, p) % p, y * pow(z, -1, p) % p)
            for x, y, z in zip(X, Y, Z)]
