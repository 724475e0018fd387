"""Pedersen and Bowe-Hopwood CRHs over any curve ops
(primitives/src/crh/{pedersen,bowe_hopwood}/mod.rs).

Counterpart of ``gingerlib_tpu/primitives/pedersen.py``.  The generator
powers are one projective batch ``params`` (window-major: window w's
powers at rows w * window_size ...); an evaluation is a masked select and a
tree of batched point additions, one level a group of launches, instead of
the reference's per-bit loop.  Setup draws one random multiplier a window,
multiplies the generator by all of them as lanes of ONE double-and-add
loop, and walks the windows' doubling chains side by side.  The draws are
the JAX package's, in its order, so a seeded setup gives the same
generators (the same points; the projective coordinates may differ).

``BoweHopwoodCRH`` sums the input's chunks only, as the host hash
(``group_hash_host.py``), its gadget and the Rust reference do.  The JAX
package's device class pads the input to the whole window, and each padded
all-zero chunk adds 1 * base_i (``gingerlib_tpu/primitives/pedersen.py``,
``BoweHopwoodCRH.evaluate_bits``), so the two agree on inputs that fill the
windows and nowhere else.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves import points


def _bytes_to_bits(data: bytes):
    """LSB-first per byte (primitives/src/lib.rs:97-106 pushes
    (byte >> i) & 1 for i in 0..8)."""
    out = []
    for byte in data:
        for i in range(8):
            out.append((byte >> i) & 1)
    return out


class PedersenWindow:
    def __init__(self, window_size: int, num_windows: int):
        self.window_size = window_size
        self.num_windows = num_windows


def tree_sum(curve, pts):
    """The sum of a point batch [n] by a tree of batched additions (an odd
    level takes the identity as its last operand); the identity for n = 0."""
    n = pts[0].shape[0]
    if n == 0:
        return curve.zero(())
    while n > 1:
        if n % 2:
            pts = tuple(torch.cat([c, z]) for c, z in
                        zip(pts, curve.zero((1,))))
            n += 1
        pts = curve.add(tuple(c[0::2] for c in pts),
                        tuple(c[1::2] for c in pts))
        n //= 2
    return tuple(c[0] for c in pts)


def _bases(curve, rng, count: int):
    """``count`` random multiples of the generator, multipliers drawn from
    ``rng`` in [1, r), as lanes of one loop: a batch [count]."""
    r = curve.scalar_field.modulus
    ks = [rng.randrange(1, r) for _ in range(count)]
    return points.mul_ints(curve, curve.generator(()), ks)


def _chains(curve, bases, length: int, doublings: int):
    """Each lane's chain b, 2^d b, 2^2d b ... of ``length`` points, the
    lanes walked side by side: a batch [lanes, length]."""
    rows, cur = [], bases
    for i in range(length):
        rows.append(cur)
        if i + 1 < length:
            for _ in range(doublings):
                cur = curve.double(cur)
    return tuple(torch.stack([row[c] for row in rows], dim=1)
                 for c in range(3))


def _mask(bits, total: int, device):
    mask = np.zeros(total, dtype=bool)
    mask[:len(bits)] = np.asarray(bits, dtype=bool)
    return torch.from_numpy(mask).to(device)


class PedersenCRH:
    """Bit-windowed Pedersen hash: sum over windows and bits of
    bit * (2^i g_w)."""

    def __init__(self, curve, window: PedersenWindow):
        self.g = curve
        self.w = window
        self.params = None            # (X, Y, Z) [num_windows*window_size]
        self.generators_host = None   # each window's g_w, affine ints

    def setup(self, rng):
        """A random generator a window and its doubling chain
        (pedersen/mod.rs:30-53)."""
        self._set(_bases(self.g, rng, self.w.num_windows))
        return self

    def _set(self, bases, chains=None):
        """The parameters from the windows' generators [num_windows] (and
        their chains [num_windows, >= window_size], where made already)."""
        g = self.g
        self.generators_host = list(zip(*points.affine_ints(g, bases)))
        if chains is None:
            chains = _chains(g, bases, self.w.window_size, 1)
        self.params = tuple(c[:, :self.w.window_size].flatten(0, 1)
                            for c in chains)

    def evaluate_bits(self, bits):
        """bits: 0/1, at most window_size * num_windows of them."""
        total = self.w.window_size * self.w.num_windows
        if len(bits) > total:
            raise ValueError("input too long for window parameters")
        g = self.g
        sel = g.select(_mask(bits, total, g.device), self.params,
                       g.zero((total,)))
        return tree_sum(g, sel)

    def evaluate(self, data: bytes):
        return self.evaluate_bits(_bytes_to_bits(data))


class BoweHopwoodCRH:
    """3-bit-chunk signed Pedersen variant (bowe_hopwood/mod.rs): chunk i
    (b0, b1, b2) adds (1 + b0 + 2 b1)(1 - 2 b2) base_i, where base_i =
    16^j g_w for the j-th chunk of window w; ``window_size`` counts
    chunks."""

    CHUNK_SIZE = 3

    def __init__(self, curve, window: PedersenWindow):
        self.g = curve
        self.w = window
        self.params = None

    def setup(self, rng):
        g = self.g
        bases = _bases(g, rng, self.w.num_windows)
        # x16 between chunks: 2 bits of magnitude and the sign's headroom
        self.params = tuple(c.flatten(0, 1) for c in _chains(
            g, bases, self.w.window_size, 4))
        return self

    def evaluate_bits(self, bits):
        """bits: LSB-first 0/1 stream, padded with zeros to whole chunks;
        only its chunks are summed."""
        bits = list(bits)
        bits += [0] * (-len(bits) % self.CHUNK_SIZE)
        n = len(bits) // self.CHUNK_SIZE
        if n > self.w.window_size * self.w.num_windows:
            raise ValueError("input too long for window parameters")
        g = self.g
        if n == 0:
            return g.zero(())
        chunks = np.asarray(bits, dtype=np.int64).reshape(n, 3)
        scalars = torch.from_numpy(1 + chunks[:, 0] + 2 * chunks[:, 1]).to(
            g.device)
        signs = torch.from_numpy(chunks[:, 2] != 0).to(g.device)
        base = tuple(c[:n] for c in self.params)
        doubled = g.double(base)
        tripled = g.add(doubled, base)
        quad = g.double(doubled)
        cur = g.select(scalars == 2, doubled, base)
        cur = g.select(scalars == 3, tripled, cur)
        cur = g.select(scalars == 4, quad, cur)
        cur = g.select(signs, g.neg(cur), cur)
        return tree_sum(g, cur)

    def evaluate(self, data: bytes):
        return self.evaluate_bits(_bytes_to_bits(data))
