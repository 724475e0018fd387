"""Python-int oracles of the field-based signatures: ``HostSchnorr`` and
``HostVrf`` over MNT6-753 G1 with Poseidon over MNT4-753 Fr (= MNT6-753
Fq), the reference tests' cycle wiring.  What the tests and
``chip_smoke.py`` hold ``primitives/schnorr.py`` and ``vrf.py`` to, on the
port's ``proofs/groth16_host.HostCurve`` and ``poseidon_host.PoseidonHost``.

The port's own copies of the oracles of the JAX package's tests
(``tests/test_schnorr.py``, ``tests/test_vrf.py``).

``_trunc`` is the cross-field truncation (compute_truncation_size,
primitives/src/lib.rs:75): the leading bits of a value of ``from_bits``
that must be zero for it to go over to a field of ``to_bits``.
"""

from __future__ import annotations

from .. import params as PP
from ..proofs.groth16_host import host_curves
from .poseidon_host import PoseidonHost


def _trunc(from_bits: int, to_bits: int) -> int:
    d = from_bits - to_bits
    return d + 1 if d > 0 else (1 if d == 0 else 0)


def _fits(value: int, from_bits: int, to_bits: int) -> bool:
    """Whether ``value`` has the leading zero bits that ``_trunc`` asks."""
    return from_bits - value.bit_length() >= _trunc(from_bits, to_bits)


class _HostMNT6:
    """MNT6-753 G1 and MNT4-753-Fr Poseidon in python ints."""

    def __init__(self):
        self.curve = host_curves("mnt6753")[0]
        self.h = PoseidonHost.mnt4753()
        self.fbits = PP.MNT4753_FR.modulus_bits
        self.r = PP.MNT6753_FR.modulus
        self.rbits = PP.MNT6753_FR.modulus_bits

    def keygen(self, rng):
        sk = rng.randrange(1, self.r)
        return self.curve.mul(self.curve.gen, sk), sk


class HostSchnorr(_HostMNT6):
    """The signer (field_based_schnorr.rs): points are (x, y) of component
    lists, signatures (e, s)."""

    def sign(self, pk, sk, message, rng):
        c = self.curve
        while True:
            k = rng.randrange(1, self.r)
            R = c.mul(c.gen, k)
            e = self.h.evaluate(list(message) + [R[0][0], R[1][0],
                                                 pk[0][0]])
            if not _fits(e, self.fbits, self.rbits):
                continue
            s = (k + e * sk) % self.r
            if not _fits(s, self.rbits, self.fbits):
                continue
            return (e, s)

    def verify(self, pk, message, sig):
        c = self.curve
        e, s = sig
        R = c.add(c.mul(c.gen, s), c.neg(c.mul(pk, e)))
        return self.h.evaluate(list(message) + [R[0][0], R[1][0],
                                                pk[0][0]]) == e


class HostVrf(_HostMNT6):
    """The EC-VRF (vrf/ecvrf/mod.rs) over the group hash ``gh``
    (``group_hash_host.BoweHopwoodHost``); proofs are (gamma, c, s)."""

    def __init__(self, gh):
        super().__init__()
        self.gh = gh

    def _msg_to_curve(self, message):
        width = 8 * (-(-self.fbits // 64))
        data = b"".join(int(m).to_bytes(width, "little") for m in message)
        return self.gh.evaluate(data)

    def prove(self, pk, sk, message, rng):
        c = self.curve
        mh = self._msg_to_curve(message)
        gamma = c.mul(mh, sk)
        while True:
            r = rng.randrange(1, self.r)
            a, b = c.mul(c.gen, r), c.mul(mh, r)
            ch = self.h.evaluate(list(message) + [pk[0][0], a[0][0],
                                                  b[0][0]])
            if not _fits(ch, self.fbits, self.rbits):
                continue
            s = (r + sk * ch) % self.r
            if not _fits(s, self.rbits, self.fbits):
                continue
            return (gamma, ch, s)

    def proof_to_hash(self, pk, message, proof):
        c = self.curve
        gamma, ch, s = proof
        mh = self._msg_to_curve(message)
        u = c.add(c.mul(c.gen, s), c.neg(c.mul(pk, ch)))
        v = c.add(c.mul(mh, s), c.neg(c.mul(gamma, ch)))
        if self.h.evaluate(list(message) + [pk[0][0], u[0][0],
                                            v[0][0]]) != ch:
            raise ValueError("VRF verification failed")
        return self.h.evaluate(list(message) + [gamma[0][0], gamma[1][0]])
