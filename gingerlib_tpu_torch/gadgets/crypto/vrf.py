"""EC-VRF proof-to-hash verification gadget
(r1cs/gadgets/crypto/src/vrf/ecvrf/mod.rs:143-300).

Counterpart of ``gingerlib_tpu/gadgets/crypto/vrf.py``.  mh =
BoweHopwood(message bytes) in the circuit (strict byte depacking); u = s G
- c pk and v = s mh - c gamma with the hardcoded-generator offset; c =
Poseidon(m || pk.x || u.x || v.x) enforced; the output is Poseidon(m ||
gamma.x || gamma.y).
"""

from __future__ import annotations

from ...primitives.signatures_host import _trunc
from ..std.boolean import Boolean
from ..std.fp import FpG
from ..std.groups import AffinePointG, SWGroupGadget
from .bowe_hopwood import BoweHopwoodGadget
from .poseidon import PoseidonGadget


class EcVrfVerificationGadget:
    def __init__(self, group: SWGroupGadget, hasher: PoseidonGadget,
                 group_hash: BoweHopwoodGadget, generator_xy,
                 scalar_field_bits: int):
        self.g = group
        self.h = hasher
        self.gh = group_hash
        self.gen_xy = generator_xy
        self.rbits = scalar_field_bits

    def alloc_proof(self, cs, proof=None, name="vrf_proof"):
        """proof: (gamma_xy, c, s) host values or None."""
        gamma = self.g.alloc_checked(
            cs, None if proof is None else proof[0], f"{name}/gamma")
        c = FpG.alloc(cs, None if proof is None else proof[1], f"{name}/c")
        s = FpG.alloc(cs, None if proof is None else proof[2], f"{name}/s")
        return (gamma, c, s)

    def _msg_bits_le(self, cs, message, name):
        """Strict depacking: big-endian bits reversed into an LSB-first
        stream padded to the full byte width (to_bytes_strict, ecvrf
        gadget :196)."""
        fbits = self.h.field.modulus_bits
        # the reference's byte width: 8 bytes a u64 limb
        total_bits = 8 * (-(-fbits // 64)) * 8
        bits = []
        for i, m in enumerate(message):
            be = m.to_bits_strict(f"{name}/m{i}")
            le = list(reversed(be))
            le += [Boolean.const(False)] * (total_bits - len(le))
            bits.extend(le)
        return bits

    def enforce_proof_to_hash_verification(self, cs, pk: AffinePointG,
                                           proof, message,
                                           name="vrf") -> FpG:
        gamma, c, s = proof
        fbits = self.h.field.modulus_bits

        mh = self.gh.check_evaluation(
            cs, self._msg_bits_le(cs, message, name), f"{name}/mh")

        skip_c = _trunc(fbits, self.rbits)
        c_bits = c.to_bits_with_length_restriction(skip_c, f"{name}/c_bits")
        skip_s = max(0, fbits - self.rbits) + _trunc(self.rbits, fbits)
        s_bits = s.to_bits_with_length_restriction(skip_s, f"{name}/s_bits")
        c_le = list(reversed(c_bits))
        s_le = list(reversed(s_bits))

        g_const = self.g.constant(cs, self.gen_xy)

        # u = s G - c pk
        acc = self.g.mul_bits(cs, pk, g_const, c_le, f"{name}/c_pk")
        c_pk = self.g.add(cs, acc, self.g.neg(cs, g_const), f"{name}/cpk_sub")
        u = self.g.mul_bits_const_base(cs, self.gen_xy, s_le,
                                       self.g.neg(cs, c_pk), f"{name}/sG")

        # v = s mh - c gamma
        acc2 = self.g.mul_bits(cs, gamma, g_const, c_le, f"{name}/c_gamma")
        c_gamma = self.g.add(cs, acc2, self.g.neg(cs, g_const),
                             f"{name}/cg_sub")
        v = self.g.mul_bits(cs, mh, self.g.neg(cs, c_gamma), s_le,
                            f"{name}/s_mh")

        c_prime = self.h.evaluate(
            cs, list(message) + [pk.x[0], u.x[0], v.x[0]], f"{name}/cprime")
        c.enforce_equal(c_prime, f"{name}/c_eq")

        return self.h.evaluate(
            cs, list(message) + [gamma.x[0], gamma.y[0]], f"{name}/out")


def mnt4753_vrf_gadget(group_hash_host):
    """The VRF over MNT6-753 G1 with MNT4-753-Fr Poseidon (the reference
    tests' wiring); group_hash_host: a ``BoweHopwoodHost`` after setup."""
    from ... import params as PP
    from ...params._gen import curves_gen as CG
    from ..std.ext_fields import FpGOps
    c = CG.MNT6753
    group = SWGroupGadget(FpGOps(PP.MNT6753_FQ), [c["a"]], [c["b"]])
    return EcVrfVerificationGadget(
        group, PoseidonGadget.mnt4753(),
        BoweHopwoodGadget(group, group_hash_host),
        ([c["g1_x"]], [c["g1_y"]]), PP.MNT6753_FR.modulus_bits)
