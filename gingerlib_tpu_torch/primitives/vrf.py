"""Field-based EC-VRF (primitives/src/vrf/ecvrf/mod.rs).

Counterpart of ``gingerlib_tpu/primitives/vrf.py``.  prove: mh =
BoweHopwood(message bytes); gamma = sk mh; loop { r <- rand; a = r G; b =
r mh; c = Poseidon(m || pk.x || a.x || b.x); retry unless c and s = r + c
sk have the leading zero bits of the cross-field truncation } -> (gamma, c,
s).  proof_to_hash: the length and subgroup checks on gamma; u = s G - c
pk; v = s mh - c gamma; c' must equal c; the output is Poseidon(m ||
gamma.x || gamma.y).

The group operations run on the curve's device, the independent
multiplies of a call as lanes of one multiply loop: prove's gamma and the
a and b of ``schnorr.TRIES_A_LOOP`` tries (taken in order, the draws past
the accepted one given back, as ``FieldBasedSchnorr.sign`` does);
proof_to_hash's s G, c pk, s mh and c gamma.  ``_msg_to_curve`` is the
port's ``pedersen.BoweHopwoodCRH``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import points
from .schnorr import _draw, _tries
from .signatures_host import _fits


def in_prime_subgroup(curve, P) -> bool:
    """P (batch shape (), Z = 1: ``from_affine``) on the curve and in its
    prime-order subgroup.  Where the cofactor is 1 (MNT6-753 G1) every
    point of the curve is in the subgroup and the on-curve check is the
    whole check; elsewhere [r] P must be 0, r the full modulus.  (The JAX
    package multiplies gamma by r reduced mod r, i.e. by 0, and so checks
    nothing beyond the curve; gingerlib_tpu/primitives/vrf.py:66, :116.)"""
    if not bool(curve.on_curve(P[0], P[1])):
        return False
    if curve.cofactor == 1:
        return True
    rP = points.mul_ints(curve, P, [curve.scalar_field.modulus])
    return bool(curve.is_zero(rP)[0])


@dataclass
class EcVrfProof:
    gamma: tuple   # affine (x, y), host ints
    c: int
    s: int


class FieldBasedEcVrf:
    def __init__(self, curve, hasher, group_hash):
        """curve: an ``SWCurveOps``; hasher: a ``PoseidonHash`` over the
        curve's base field; group_hash: a ``BoweHopwoodCRH`` over the
        curve; all three on one device."""
        if curve.fp.modulus != hasher.F.modulus:
            raise ValueError("the curve's base field must be the hash field")
        if not curve.device == hasher.device == group_hash.g.device:
            raise ValueError("the curve, the hash and the group hash must "
                             "live on one device")
        self.g = curve
        self.h = hasher
        self.gh = group_hash
        self.F = hasher.F
        self.Fr = curve.scalar_field

    # -- helpers --

    def _hash_ints(self, ints) -> int:
        return self.h.evaluate_ints([list(ints)])[0]

    def _msg_to_curve(self, message):
        """Field elements -> the reference's ToBytes bytes -> the group
        hash."""
        width = 8 * (-(-self.F.modulus_bits // 64))
        data = b"".join(int(m).to_bytes(width, "little") for m in message)
        return self.gh.evaluate(data)

    # -- api --

    def keygen(self, rng=None):
        sk = _draw(rng, self.Fr.modulus)
        g = self.g
        pk = points.mul_ints(g, g.generator(()), [sk])
        return tuple(c[0] for c in pk), sk

    def prove(self, pk, sk: int, message, rng=None) -> EcVrfProof:
        fbits, rbits = self.F.modulus_bits, self.Fr.modulus_bits
        for m in message:
            if not 0 <= m < self.F.modulus:
                raise ValueError("message element out of range")
        g, r = self.g, self.Fr.modulus
        mh = self._msg_to_curve(message)
        pk_x = points.affine_ints(g, pk)[0][0]
        gamma = None
        for rs, settle in _tries(rng, r):
            n = len(rs)
            pts, ks = [g.generator(())] * n + [mh] * n, rs + rs
            if gamma is None:            # the first loop takes sk mh along
                pts.append(mh)
                ks.append(sk)
            out = points.unstack(points.mul_ints(g, points.stack(pts),
                                                 ks))
            gamma = out[2 * n] if gamma is None else gamma
            xs, ys = points.affine_ints(
                g, points.stack(out[:2 * n] + [gamma]))
            cs = self.h.evaluate_ints(
                [list(message) + [pk_x, xs[i], xs[n + i]] for i in range(n)])
            for i, (rv, c) in enumerate(zip(rs, cs)):
                s = (rv + sk * c) % r
                if _fits(c, fbits, rbits) and _fits(s, rbits, fbits):
                    settle(i + 1)
                    return EcVrfProof(gamma=(xs[-1], ys[-1]), c=c, s=s)

    def proof_to_hash(self, pk, message, proof: EcVrfProof) -> int:
        fbits, rbits = self.F.modulus_bits, self.Fr.modulus_bits
        if not _fits(proof.c, fbits, rbits):
            raise ValueError("proof.c too long")
        if not _fits(proof.s, rbits, fbits):
            raise ValueError("proof.s too long")
        g = self.g
        gx, gy = proof.gamma
        gamma_pt = g.from_affine(*g.affine_from_ints([gx], [gy]))
        if not in_prime_subgroup(g, gamma_pt):
            raise ValueError("gamma not in prime-order subgroup")
        mh = self._msg_to_curve(message)
        sG, c_pk, s_mh, c_gamma = points.unstack(points.mul_ints(
            g, points.stack([g.generator(()), pk, mh, gamma_pt]),
            [proof.s, proof.c, proof.s, proof.c]))
        # u = s G - c pk and v = s mh - c gamma as one addition of 2 lanes
        uv = g.add(points.stack([sG, s_mh]),
                   g.neg(points.stack([c_pk, c_gamma])))
        u, v = points.unstack(uv)
        xs, _ = points.affine_ints(g, points.stack([pk, u, v]))
        if self._hash_ints(list(message) + xs) != proof.c:
            raise ValueError("VRF verification failed")
        return self._hash_ints(list(message) + [gx, gy])
