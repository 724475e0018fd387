"""Field-based Schnorr signatures on the MNT cycle
(primitives/src/signature/schnorr/field_based_schnorr.rs).

Counterpart of ``gingerlib_tpu/primitives/schnorr.py``.  sign: loop { k <-
rand; R = kG; e = Poseidon(m || R.x || R.y || pk.x); retry unless e and s
= k + e sk have the leading zero bits of the cross-field truncation
(``signatures_host._trunc``) }; the signature is (e, s), both read in the
hash field.

The rejection loop is host code (its trip count depends on the data;
SURVEY.md section 7 (e)); the group operations run on the curve's device
and the hash is ``poseidon.PoseidonHash`` (one Poseidon kernel launch a
permutation on a GPU).  The loop's tries run ``TRIES_A_LOOP`` at a time:
their scalars are the lanes of one multiply loop and their hashes one
batch, and the first try that passes is taken, as one try at a time would
take it; the draws past it are given back (``_tries``), so a seeded
``random.Random`` ends where the JAX package's loop leaves it.
``verify``'s s G and e pk are two lanes of one loop.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..curves import points
from .signatures_host import _fits


@dataclass
class SchnorrSignature:
    e: int  # in F (the hash field)
    s: int


def _draw(rng, modulus: int) -> int:
    """A scalar in [1, modulus): from ``rng`` if given, else from the
    system's randomness."""
    if rng is not None:
        return rng.randrange(1, modulus)
    return secrets.randbelow(modulus - 1) + 1


# the tries of a rejection loop that run as lanes of one multiply loop: a
# try passes with probability ~0.32 on the MNT cycle (both e and s below
# 2^752), so 16 miss all with probability ~0.002
TRIES_A_LOOP = 16


def _tries(rng, modulus: int):
    """The scalars of a rejection loop's tries, ``TRIES_A_LOOP`` at a time:
    yields (scalars, settle), where ``settle(used)`` leaves a seeded ``rng``
    (a ``random.Random``) as drawing this batch's first ``used`` scalars one
    at a time would: its state before the batch, then ``used`` draws."""
    while True:
        state = None if rng is None else rng.getstate()
        ks = [_draw(rng, modulus) for _ in range(TRIES_A_LOOP)]

        def settle(used, state=state):
            if state is not None:
                rng.setstate(state)
                for _ in range(used):
                    rng.randrange(1, modulus)
        yield ks, settle


class FieldBasedSchnorr:
    def __init__(self, curve, hasher):
        """curve: an ``SWCurveOps`` whose base field is the hasher's field
        (the cycle wiring: sign over G with Poseidon over G's base field),
        both on one device."""
        if curve.fp.modulus != hasher.F.modulus:
            raise ValueError("the curve's base field must be the hash field")
        if curve.device != hasher.device:
            raise ValueError(f"the curve lives on {curve.device}, the hash "
                             f"on {hasher.device}")
        self.g = curve
        self.h = hasher
        self.F = hasher.F                       # hash / base field
        self.Fr = curve.scalar_field            # scalar field

    # -- helpers --

    def _hash_ints(self, ints) -> int:
        return self.h.evaluate_ints([list(ints)])[0]

    def _mul_gen(self, k: int):
        g = self.g
        return tuple(c[0] for c in points.mul_ints(g, g.generator(()), [k]))

    # -- api (signature/mod.rs:54-84) --

    def keygen(self, rng=None):
        sk = _draw(rng, self.Fr.modulus)
        return self._mul_gen(sk), sk

    def get_public_key(self, sk: int):
        return self._mul_gen(sk)

    def sign(self, pk, sk: int, message, rng=None) -> SchnorrSignature:
        fbits, rbits = self.F.modulus_bits, self.Fr.modulus_bits
        g, r = self.g, self.Fr.modulus
        pk_x = points.affine_ints(g, pk)[0][0]
        for ks, settle in _tries(rng, r):
            xs, ys = points.affine_ints(g, points.mul_ints(
                g, g.generator(()), ks))
            es = self.h.evaluate_ints([list(message) + [x, y, pk_x]
                                       for x, y in zip(xs, ys)])
            for i, (k, e) in enumerate(zip(ks, es)):
                s = (k + e * sk) % r
                if _fits(e, fbits, rbits) and _fits(s, rbits, fbits):
                    settle(i + 1)
                    return SchnorrSignature(e=e, s=s)

    def verify(self, pk, message, sig: SchnorrSignature) -> bool:
        fbits, rbits = self.F.modulus_bits, self.Fr.modulus_bits
        if not _fits(sig.e, fbits, rbits):
            raise ValueError("signature.e too long")
        if not _fits(sig.s, rbits, fbits):
            raise ValueError("signature.s too long")
        g = self.g
        # R' = s G - e pk
        sG, e_pk = points.unstack(points.mul_ints(
            g, points.stack([g.generator(()), pk]), [sig.s, sig.e]))
        r_prime = g.add(sG, g.neg(e_pk))
        xs, ys = points.affine_ints(g, points.stack([r_prime, pk]))
        return self._hash_ints(list(message) + [xs[0], ys[0], xs[1]]) \
            == sig.e

    def keyverify(self, pk) -> bool:
        """pk on the curve and in the prime-order subgroup: [r] pk = 0."""
        g = self.g
        on = bool(g.on_curve(*g.to_affine(pk)))
        z = points.mul_ints(g, pk, [self.Fr.modulus])
        return on and bool(g.is_zero(z)[0])
