"""Pedersen CRH, commitment and injective-map gadgets over TE curves.

Counterpart of ``gingerlib_tpu/gadgets/crypto/pedersen.py``; mirrors
r1cs/gadgets/crypto/src/crh/pedersen/mod.rs (FixedLengthCRHGadget),
commitment/pedersen.rs and crh/injective_map/mod.rs: the hash is the sum
over windows and bits of bit_{w,i} (2^i g_w), computed with the TE group
gadget's fixed-base 2-bit-lookup multiplication (the constant doubling
chains live on the host); the commitment adds [randomness] G_r the same
way, and the injective map outputs the x coordinate (TECompressor).
"""

from __future__ import annotations

from ..std.boolean import Boolean
from ..std.te_groups import TEGroupGadget, TEPointG


def bytes_to_bit_gadgets(cs, data: bytes, name="msg"):
    """The input bytes as Boolean wires, LSB-first a byte (as
    ``primitives/pedersen._bytes_to_bits``; primitives/src/lib.rs:97-106)."""
    bits = []
    for bi, byte in enumerate(data):
        for i in range(8):
            bits.append(Boolean.alloc(cs, bool((byte >> i) & 1),
                                      f"{name}/b{bi}_{i}"))
    return bits


class PedersenCRHGadget:
    def __init__(self, group_gadget: TEGroupGadget, window,
                 generators_host):
        """generators_host: each window's affine host int pair, from
        ``primitives/pedersen.PedersenCRH.setup``."""
        self.gg = group_gadget
        self.w = window
        self.gens = generators_host

    def check_evaluation(self, cs, input_bits, name="pedersen") -> TEPointG:
        total = self.w.window_size * self.w.num_windows
        if len(input_bits) > total:
            raise ValueError("input too long for window parameters")
        bits = list(input_bits) + \
            [Boolean.const(False)] * (total - len(input_bits))
        result = self.gg.zero(cs)
        ws = self.w.window_size
        for w in range(self.w.num_windows):
            result = self.gg.mul_bits_fixed_base(
                cs, self.gens[w], bits[w * ws:(w + 1) * ws],
                f"{name}/w{w}", acc=result)
        return result


class PedersenCommitmentGadget:
    def __init__(self, group_gadget: TEGroupGadget, window,
                 generators_host, rand_base_host):
        self.crh = PedersenCRHGadget(group_gadget, window, generators_host)
        self.gg = group_gadget
        self.rand_base = rand_base_host

    def check_commitment(self, cs, input_bits, randomness_bits,
                         name="pedcomm") -> TEPointG:
        """commit = CRH(input) + [randomness] G_r; randomness_bits are
        LSB-first Boolean wires (commitment/pedersen.rs)."""
        base = self.crh.check_evaluation(cs, input_bits, f"{name}/crh")
        return self.gg.mul_bits_fixed_base(
            cs, self.rand_base, randomness_bits, f"{name}/rand", acc=base)


class PedersenCRHCompressorGadget:
    """The Pedersen CRH, then the injective TE -> x map (crh/injective_map
    gadget)."""

    def __init__(self, group_gadget: TEGroupGadget, window, generators_host):
        self.crh = PedersenCRHGadget(group_gadget, window, generators_host)

    def check_evaluation(self, cs, input_bits, name="pedcomp"):
        pt = self.crh.check_evaluation(cs, input_bits, name)
        return pt.x
