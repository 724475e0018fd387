"""Field-based Schnorr verification gadget
(r1cs/gadgets/crypto/src/signature/schnorr/field_based_schnorr.rs:91-239).

Counterpart of ``gingerlib_tpu/gadgets/crypto/schnorr.py``.  R' = s G - e
pk is recomputed with the reference's hardcoded-generator offset (the
e-chain's accumulator starts at G, which is taken off after) to keep clear
of the incomplete addition's exceptional cases; e' = Poseidon(m || R'.x ||
R'.y || pk.x) is enforced equal to e (hard) or compared into a Boolean
(verdict).
"""

from __future__ import annotations

from ...primitives.signatures_host import _trunc
from ..std.boolean import Boolean
from ..std.fp import FpG
from ..std.groups import AffinePointG, SWGroupGadget
from .poseidon import PoseidonGadget

__all__ = ["SchnorrVerificationGadget", "mnt4753_schnorr_gadget", "_trunc"]


class SchnorrVerificationGadget:
    def __init__(self, group: SWGroupGadget, hasher: PoseidonGadget,
                 generator_xy, scalar_field_bits: int):
        self.g = group
        self.h = hasher
        self.gen_xy = generator_xy  # host affine components
        self.rbits = scalar_field_bits

    def alloc_signature(self, cs, sig=None, name="sig"):
        e = FpG.alloc(cs, None if sig is None else sig[0], f"{name}/e")
        s = FpG.alloc(cs, None if sig is None else sig[1], f"{name}/s")
        return (e, s)

    def _computation(self, cs, pk: AffinePointG, sig, message, name):
        e, s = sig
        fbits = self.h.field.modulus_bits
        # e's bits (big-endian, truncated)
        skip_e = _trunc(fbits, self.rbits)
        e_bits = e.to_bits_with_length_restriction(skip_e, f"{name}/e_bits")
        # G hardcoded as the accumulator's offset
        # (field_based_schnorr.rs:136-141)
        g_const = self.g.constant(cs, self.gen_xy)
        acc = self.g.mul_bits(cs, pk, g_const, list(reversed(e_bits)),
                              f"{name}/e_pk")
        e_pk = self.g.add(cs, acc, self.g.neg(cs, g_const),
                          f"{name}/sub_g")
        neg_e_pk = self.g.neg(cs, e_pk)
        # s's bits
        skip_s = max(0, fbits - self.rbits) + _trunc(self.rbits, fbits)
        s_bits = s.to_bits_with_length_restriction(skip_s, f"{name}/s_bits")
        r_prime = self.g.mul_bits_const_base(
            cs, self.gen_xy, list(reversed(s_bits)), neg_e_pk,
            f"{name}/sG")
        inputs = list(message) + [r_prime.x[0], r_prime.y[0], pk.x[0]]
        return self.h.evaluate(cs, inputs, f"{name}/eprime")

    def enforce_signature_verification(self, cs, pk, sig, message,
                                       name="schnorr"):
        e_prime = self._computation(cs, pk, sig, message, name)
        sig[0].enforce_equal(e_prime, f"{name}/e_eq")

    def enforce_signature_verdict(self, cs, pk, sig, message,
                                  name="schnorr") -> Boolean:
        e_prime = self._computation(cs, pk, sig, message, name)
        return sig[0].is_eq(e_prime, f"{name}/verdict")


def mnt4753_schnorr_gadget():
    """Schnorr over MNT6-753 G1, whose base field MNT6-753 Fq is MNT4-753
    Fr, hashed with Poseidon over that field (the reference tests'
    wiring)."""
    from ... import params as PP
    from ...params._gen import curves_gen as CG
    from ..std.ext_fields import FpGOps
    c = CG.MNT6753
    base = FpGOps(PP.MNT6753_FQ)
    group = SWGroupGadget(base, [c["a"]], [c["b"]])
    return SchnorrVerificationGadget(
        group, PoseidonGadget.mnt4753(), ([c["g1_x"]], [c["g1_y"]]),
        PP.MNT6753_FR.modulus_bits)
