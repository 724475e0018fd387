"""Batches of projective points (X, Y, Z), any curve model: one point of
batch shape () has coordinates [K, nd], a batch [N] has [N, K, nd]; the
scalar multiplication by host ints that the primitives run (``mul_ints``);
and the host view of points over a prime field (``affine_ints``,
``affine_host``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import fp as fpmod

WINDOW = 4   # bits of a window of ``mul_ints``


def lanes(P, n: int):
    """A point of batch shape () broadcast to a batch of n lanes; a batch
    is returned as it is."""
    return tuple(c.expand((n,) + c.shape[-2:]) if c.dim() == 2 else c
                 for c in P)


def stack(points):
    """Points of batch shape () -> one batch [len(points)]."""
    return tuple(torch.stack(c) for c in zip(*points))


def unstack(P):
    """A batch [N] -> N points of batch shape ()."""
    return list(zip(*(c.unbind(0) for c in P)))


def affine_ints(curve, P):
    """A batch of points [N] (or one point) over a prime field -> lists of
    host ints (xs, ys), one shared inversion."""
    x, y = curve.to_affine(P)
    nd = curve.fp.n_digits
    return (fpmod.fp_to_ints(curve.fp, x.reshape(-1, nd).cpu()),
            fpmod.fp_to_ints(curve.fp, y.reshape(-1, nd).cpu()))


def affine_host(curve, P):
    """One point over a prime field -> its host affine int pair."""
    xs, ys = affine_ints(curve, P)
    return xs[0], ys[0]


def mul_ints(curve, P, ks):
    """[k_i] P_i for host ints ``ks`` >= 0: lane i of a batch [len(ks)] (a
    point of batch shape () serves every lane), ONE loop for all lanes,
    whatever their scalars.  Fixed windows of 4 bits: a table of each
    lane's multiples 0..15 (14 additions and doublings), then a window
    at a time 4 doublings and the addition of the multiple its digit picks
    (a gather a lane), so a b-bit scalar costs b doublings and b / 4
    additions where ``mul_bits`` takes b of each.  ``curve``: any curve ops
    whose ``add`` is complete or unified (the identity and equal operands
    in any lane), as ``SWCurveOps`` and ``TECurveOps`` are."""
    if any(k < 0 for k in ks):
        raise ValueError("scalars must be non-negative")
    n = len(ks)
    P = lanes(P, n)
    table = [curve.zero((n,)), P]
    for j in range(2, 1 << WINDOW):
        table.append(curve.double(table[j // 2]) if j % 2 == 0
                     else curve.add(table[j - 1], P))
    table = tuple(torch.stack([t[c] for t in table]) for c in range(3))
    nwin = max(1, -(-max(k.bit_length() for k in ks) // WINDOW))
    mask = (1 << WINDOW) - 1
    digits = torch.from_numpy(np.array(
        [[(k >> (WINDOW * (nwin - 1 - w))) & mask for w in range(nwin)]
         for k in ks], dtype=np.int64)).to(P[0].device)
    rows = torch.arange(n, device=P[0].device)
    acc = tuple(c[digits[:, 0], rows] for c in table)
    for w in range(1, nwin):
        for _ in range(WINDOW):
            acc = curve.double(acc)
        acc = curve.add(acc, tuple(c[digits[:, w], rows] for c in table))
    return acc
