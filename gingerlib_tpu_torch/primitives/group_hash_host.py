"""Host (python-int) Bowe-Hopwood group hash: the parameters and the oracle
of the device hash (``pedersen.BoweHopwoodCRH``) and of its gadget
(``gadgets/crypto/bowe_hopwood.py``), so that all three hash to the same
curve points.

Counterpart of ``gingerlib_tpu/primitives/group_hash_host.py``, on the
port's python-int curve ``proofs/groth16_host.HostCurve``.
"""

from __future__ import annotations

from ..proofs.groth16_host import HostCurve, HostField

CHUNK_SIZE = 3


class BoweHopwoodHost:
    """``window_size`` counts 3-bit chunks a segment (bowe_hopwood/mod.rs)
    over y^2 = x^3 + a x + b with generator ``gen_xy``."""

    def __init__(self, modulus: int, a_coeff: int, gen_xy, fr_modulus: int,
                 window_size: int, num_windows: int):
        self.curve = HostCurve(HostField(modulus), (a_coeff % modulus,),
                               ([gen_xy[0]], [gen_xy[1]]))
        self.fr_modulus = fr_modulus
        self.window_size = window_size
        self.num_windows = num_windows
        self.generators = None  # [num_windows][window_size] host points

    def setup(self, rng):
        c = self.curve
        gens = []
        for _ in range(self.num_windows):
            k = rng.randrange(1, self.fr_modulus)
            cur = c.mul(c.gen, k)
            row = []
            for _ in range(self.window_size):
                row.append(cur)
                for _ in range(4):  # x16 between chunks
                    cur = c.double(cur)
            gens.append(row)
        self.generators = gens
        return self

    def evaluate_bits(self, bits_le):
        """bits: LSB-first stream, cut into 3-bit signed digits; the
        input's chunks only (None for no chunk: infinity)."""
        bits_le = list(bits_le)
        bits_le += [0] * (-len(bits_le) % CHUNK_SIZE)
        chunks = [bits_le[i:i + 3] for i in range(0, len(bits_le), 3)]
        if len(chunks) > self.window_size * self.num_windows:
            raise ValueError("input too long for window parameters")
        c = self.curve
        acc = None
        for i, (b0, b1, b2) in enumerate(chunks):
            w, j = divmod(i, self.window_size)
            pt = c.mul(self.generators[w][j], 1 + b0 + 2 * b1)
            acc = c.add(acc, c.neg(pt) if b2 else pt)
        return acc

    def evaluate(self, data: bytes):
        bits = []
        for byte in data:
            for i in range(8):
                bits.append((byte >> i) & 1)
        return self.evaluate_bits(bits)


def mnt6753_g1_group_hash(window_size=2, num_windows=2) -> BoweHopwoodHost:
    """The group hash over MNT6-753 G1, the VRF's curve."""
    from .. import params as PP
    from ..params._gen import curves_gen as CG
    c = CG.MNT6753
    return BoweHopwoodHost(PP.MNT6753_FQ.modulus, c["a"],
                           (c["g1_x"], c["g1_y"]), PP.MNT6753_FR.modulus,
                           window_size, num_windows)
