"""Commitment schemes (primitives/src/commitment/*).

Counterpart of ``gingerlib_tpu/primitives/commitment.py``:

* ``PedersenCommitment``: CRH(input) + [randomness] G_r over any curve ops
  (commitment/pedersen/mod.rs): setup adds a random generator's doubling
  chain, one power a bit of the scalar field, to the CRH's parameters;
* the injective-map compressors (injective_map/mod.rs): a twisted-Edwards
  point -> its affine x, and the Pedersen CRH followed by that map.
"""

from __future__ import annotations

from ..curves.points import affine_ints
from .pedersen import (PedersenCRH, PedersenWindow, _bases, _chains, _mask,
                       tree_sum)


class PedersenCommitment:
    def __init__(self, curve, window: PedersenWindow):
        self.g = curve
        self.crh = PedersenCRH(curve, window)
        self.rand_powers = None      # the doubling chain of G_r
        self.rand_base_host = None   # G_r, affine ints

    def setup(self, rng):
        """The CRH's generators, then one more random generator (drawn
        after the CRH's) and its chain of ``modulus_bits`` powers: the
        generators as lanes of one loop, their chains walked side by
        side."""
        g = self.g
        nw, nbits = self.crh.w.num_windows, g.scalar_field.modulus_bits
        bases = _bases(g, rng, nw + 1)
        chains = _chains(g, bases, max(self.crh.w.window_size, nbits), 1)
        self.crh._set(tuple(c[:nw] for c in bases),
                      tuple(c[:nw] for c in chains))
        xs, ys = affine_ints(g, tuple(c[nw:] for c in bases))
        self.rand_base_host = (xs[0], ys[0])
        self.rand_powers = tuple(c[nw, :nbits] for c in chains)
        return self

    def commit(self, data: bytes, randomness: int):
        """CRH(data) + [randomness] G_r; the randomness is a scalar of at
        most ``modulus_bits`` bits (an element of Fr)."""
        g = self.g
        nbits = g.scalar_field.modulus_bits
        if not 0 <= randomness < 1 << nbits:
            raise ValueError(f"randomness must be below 2^{nbits}")
        base = self.crh.evaluate(data)
        bits = [(randomness >> i) & 1 for i in range(nbits)]
        sel = g.select(_mask(bits, nbits, g.device), self.rand_powers,
                       g.zero((nbits,)))
        return g.add(base, tree_sum(g, sel))


class TECompressor:
    """The twisted-Edwards injective map (x, y) -> x
    (injective_map/mod.rs)."""

    @staticmethod
    def injective_map(curve, pt):
        x, _ = curve.to_affine(pt)
        return x


class PedersenCRHCompressor:
    """The Pedersen CRH followed by the x-coordinate compression."""

    def __init__(self, curve, window: PedersenWindow):
        self.crh = PedersenCRH(curve, window)
        self.g = curve

    def setup(self, rng):
        self.crh.setup(rng)
        return self

    def evaluate(self, data: bytes):
        return TECompressor.injective_map(self.g, self.crh.evaluate(data))
