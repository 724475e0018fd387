"""Bowe-Hopwood CRH gadget (r1cs/gadgets/crypto/src/crh/bowe_hopwood).

Counterpart of ``gingerlib_tpu/gadgets/crypto/bowe_hopwood.py``.  A 3-bit
chunk's +-{1, 2, 3, 4} base multiples are host constants; the x coordinate
is a 2-bit lookup, the y coordinate a 3-bit sign-conditional lookup
(select.rs:21, 46), then one incomplete affine addition a chunk.
"""

from __future__ import annotations

from ...primitives.group_hash_host import CHUNK_SIZE, BoweHopwoodHost
from ...relations.r1cs import ConstraintSystem
from ..std.boolean import Boolean
from ..std.fp import FpG
from ..std.groups import AffinePointG, SWGroupGadget


class BoweHopwoodGadget:
    def __init__(self, group: SWGroupGadget, host: BoweHopwoodHost):
        self.g = group
        self.host = host
        # the multiples 1..4 of each chunk's base, as host constants
        self.tables = []
        for w in range(host.num_windows):
            for j in range(host.window_size):
                base = host.generators[w][j]
                multiples = [host.curve.mul(base, k) for k in (1, 2, 3, 4)]
                xt = [m[0][0] for m in multiples]
                yt = [m[1][0] for m in multiples]
                self.tables.append((xt, yt))

    def check_evaluation(self, cs: ConstraintSystem, bits_le,
                         name="bh") -> AffinePointG:
        """bits_le: LSB-first Boolean list; returns the hash point."""
        bits = list(bits_le)
        bits += [Boolean.const(False)] * (-len(bits) % CHUNK_SIZE)
        nchunks = len(bits) // CHUNK_SIZE
        if nchunks > len(self.tables):
            raise ValueError("input too long for window parameters")
        acc = None
        for i in range(nchunks):
            b0, b1, b2 = bits[3 * i:3 * i + 3]
            xt, yt = self.tables[i]
            x = FpG.two_bit_lookup(cs, (b0, b1), xt, f"{name}/x{i}")
            b0b1 = b0.and_(cs, b1)
            y = FpG.three_bit_cond_neg_lookup(cs, (b0, b1, b2), b0b1, yt,
                                              f"{name}/y{i}")
            pt = AffinePointG([x], [y])
            acc = pt if acc is None else self.g.add(cs, acc, pt,
                                                    f"{name}/add{i}")
        return acc
