"""Groth16 and GM17 verifier gadgets — one step of recursive composition
(r1cs/gadgets/crypto/src/nizk/groth16/mod.rs:106-184, nizk/gm17/mod.rs).

Counterpart of ``gingerlib_tpu/gadgets/crypto/nizk.py``: over the
MNT4-753 / MNT6-753 cycle, and the BLS12-377 Groth16 verifier (circuit
field BLS12-377 Fq = SW6 Fr).

The circuit field is the inner curve's Fq (= the outer curve's Fr on the
MNT4/6-753 cycle), so a proof over MNT4-753 is verified inside a circuit
that is then proven over MNT6-753 — exactly the reference's recursion step
(tests at nizk/groth16/mod.rs:517,605).
"""

from __future__ import annotations

from ..std.boolean import Boolean
from ..std.groups import SWGroupGadget
from ..std.pairing import MNTPairingGadget


class Groth16VerifierGadget:
    def __init__(self, pairing_gadget: MNTPairingGadget,
                 g1_gadget: SWGroupGadget, g2_gadget: SWGroupGadget,
                 fqk_ops):
        self.pg = pairing_gadget
        self.g1 = g1_gadget
        self.g2 = g2_gadget
        self.fqk = fqk_ops

    # -- allocation of vk / proof from host values --

    def alloc_vk(self, cs, vk_host, name="vk"):
        """vk_host: dict with alpha_g1_beta_g2 (flat fqk component ints),
        gamma_g2 / delta_g2 ((x comps, y comps)), gamma_abc (list of (x, y)
        single-component tuples)."""
        agbg = self.fqk.alloc(cs, vk_host["alpha_g1_beta_g2"],
                              f"{name}/agbg")
        gamma = self.g2.alloc_checked(cs, vk_host["gamma_g2"],
                                      f"{name}/gamma_g2")
        delta = self.g2.alloc_checked(cs, vk_host["delta_g2"],
                                      f"{name}/delta_g2")
        abc = [self.g1.alloc_checked(cs, xy, f"{name}/abc{i}")
               for i, xy in enumerate(vk_host["gamma_abc"])]
        return {"alpha_g1_beta_g2": agbg, "gamma_g2": gamma,
                "delta_g2": delta, "gamma_abc": abc}

    def alloc_proof(self, cs, proof_host, name="proof"):
        a = self.g1.alloc_checked(cs, proof_host["a"], f"{name}/a")
        b = self.g2.alloc_checked(cs, proof_host["b"], f"{name}/b")
        c = self.g1.alloc_checked(cs, proof_host["c"], f"{name}/c")
        return {"a": a, "b": b, "c": c}

    def alloc_input_bits(self, cs, value: int | None, nbits: int,
                         name="input"):
        """public input as little-endian booleans (the reference feeds
        inputs as bit vectors, alloc_input_vec boolean.rs:430)."""
        bits = []
        for i in range(nbits):
            v = None if value is None else (value >> i) & 1
            bits.append(Boolean.alloc(cs, v, f"{name}/b{i}"))
        return bits

    # -- verification circuit --

    def check_verify(self, cs, vk, public_input_bits, proof, name="g16v"):
        """public_input_bits: list (per input) of little-endian Boolean
        lists; enforces the pairing equation."""
        # g_ic accumulation: g_ic = abc0; then mul_bits with variable base
        g_ic = vk["gamma_abc"][0]
        assert len(public_input_bits) == len(vk["gamma_abc"]) - 1
        for i, bits in enumerate(public_input_bits):
            base = vk["gamma_abc"][i + 1]
            g_ic = self.g1.mul_bits(cs, base, g_ic, bits, f"{name}/in{i}")

        neg_gamma = self.g2.neg(cs, vk["gamma_g2"])
        neg_delta = self.g2.neg(cs, vk["delta_g2"])

        gt = self.pg.pairing_product(
            cs,
            [proof["a"], g_ic, proof["c"]],
            [proof["b"], neg_gamma, neg_delta],
            f"{name}/pp")
        self.fqk.enforce_equal(cs, gt, vk["alpha_g1_beta_g2"],
                               f"{name}/gt_eq")



class Gm17VerifierGadget:
    """GM17 verifier circuit (nizk/gm17/mod.rs): two pairing equations

        e(A+α, B+β) = e(α,β) · e(ψ, γ_h2) · e(C, h)     (test1)
        e(A, γ_h2)  = e(γ_g1, B)                         (test2)

    enforced as pairing-product-vs-constant checks with negated right sides,
    exactly mirroring the host verifier (proofs/gm17_host.py verify)."""

    def __init__(self, pairing_gadget: MNTPairingGadget,
                 g1_gadget: SWGroupGadget, g2_gadget: SWGroupGadget,
                 fqk_ops):
        self.pg = pairing_gadget
        self.g1 = g1_gadget
        self.g2 = g2_gadget
        self.fqk = fqk_ops

    def alloc_vk(self, cs, vk_host, name="vk"):
        """vk_host: h_g2 / h_beta_g2 / h_gamma_g2 ((x comps, y comps) G2),
        g_alpha_g1 / g_gamma_g1 (single-component (x, y)), query (list of
        G1 pairs), g_alpha_h_beta (flat fqk ints of e(g^α, h^β))."""
        return {
            "h_g2": self.g2.alloc_checked(cs, vk_host["h_g2"], f"{name}/h"),
            "g_alpha_g1": self.g1.alloc_checked(
                cs, vk_host["g_alpha_g1"], f"{name}/g_alpha"),
            "h_beta_g2": self.g2.alloc_checked(
                cs, vk_host["h_beta_g2"], f"{name}/h_beta"),
            "g_gamma_g1": self.g1.alloc_checked(
                cs, vk_host["g_gamma_g1"], f"{name}/g_gamma"),
            "h_gamma_g2": self.g2.alloc_checked(
                cs, vk_host["h_gamma_g2"], f"{name}/h_gamma"),
            "query": [self.g1.alloc_checked(cs, xy, f"{name}/q{i}")
                      for i, xy in enumerate(vk_host["query"])],
            "g_alpha_h_beta": self.fqk.alloc(
                cs, vk_host["g_alpha_h_beta"], f"{name}/gahb"),
        }

    def alloc_proof(self, cs, proof_host, name="proof"):
        a = self.g1.alloc_checked(cs, proof_host["a"], f"{name}/a")
        b = self.g2.alloc_checked(cs, proof_host["b"], f"{name}/b")
        c = self.g1.alloc_checked(cs, proof_host["c"], f"{name}/c")
        return {"a": a, "b": b, "c": c}

    def alloc_input_bits(self, cs, value: int | None, nbits: int,
                         name="input"):
        bits = []
        for i in range(nbits):
            v = None if value is None else (value >> i) & 1
            bits.append(Boolean.alloc(cs, v, f"{name}/b{i}"))
        return bits

    def check_verify(self, cs, vk, public_input_bits, proof, name="gm17v"):
        g_psi = vk["query"][0]
        assert len(public_input_bits) == len(vk["query"]) - 1
        for i, bits in enumerate(public_input_bits):
            base = vk["query"][i + 1]
            g_psi = self.g1.mul_bits(cs, base, g_psi, bits, f"{name}/in{i}")

        a_alpha = self.g1.add(cs, proof["a"], vk["g_alpha_g1"],
                              f"{name}/a_alpha")
        b_beta = self.g2.add(cs, proof["b"], vk["h_beta_g2"],
                             f"{name}/b_beta")
        neg_h_gamma = self.g2.neg(cs, vk["h_gamma_g2"])
        neg_h = self.g2.neg(cs, vk["h_g2"])

        # test1:  e(A+α, B+β) · e(ψ, −γ_h2) · e(C, −h) == e(α, β)
        t1 = self.pg.pairing_product(
            cs, [a_alpha, g_psi, proof["c"]],
            [b_beta, neg_h_gamma, neg_h], f"{name}/t1")
        self.fqk.enforce_equal(cs, t1, vk["g_alpha_h_beta"],
                               f"{name}/t1_eq")

        # test2:  e(A, γ_h2) · e(−γ_g1, B) == 1
        neg_g_gamma = self.g1.neg(cs, vk["g_gamma_g1"])
        t2 = self.pg.pairing_product(
            cs, [proof["a"], neg_g_gamma],
            [vk["h_gamma_g2"], proof["b"]], f"{name}/t2")
        self.fqk.enforce_equal(cs, t2, self.fqk.one(cs), f"{name}/t2_eq")


def mnt4753_verifier_gadget():
    """Verifier for MNT4-753 proofs; circuit field mnt4753 Fq (= MNT6 Fr)."""
    from ..std.pairing import mnt4753_pairing_gadget
    from ...params._gen import curves_gen as CG
    pg, base, fq2, fq4 = mnt4753_pairing_gadget()
    c = CG.MNT4753
    g1 = SWGroupGadget(base, [c["a"]], [c["b"]])
    g2 = pg.g2
    return Groth16VerifierGadget(pg, g1, g2, fq4)


def mnt6753_verifier_gadget():
    from ..std.pairing import mnt6753_pairing_gadget
    from ...params._gen import curves_gen as CG
    pg, base, fq3, fq6 = mnt6753_pairing_gadget()
    c = CG.MNT6753
    g1 = SWGroupGadget(base, [c["a"]], [c["b"]])
    g2 = pg.g2
    return Groth16VerifierGadget(pg, g1, g2, fq6)


def mnt4753_gm17_verifier_gadget():
    """GM17 verifier for MNT4-753 proofs; circuit field mnt4753 Fq."""
    from ..std.pairing import mnt4753_pairing_gadget
    from ...params._gen import curves_gen as CG
    pg, base, fq2, fq4 = mnt4753_pairing_gadget()
    c = CG.MNT4753
    g1 = SWGroupGadget(base, [c["a"]], [c["b"]])
    return Gm17VerifierGadget(pg, g1, pg.g2, fq4)


def mnt6753_gm17_verifier_gadget():
    from ..std.pairing import mnt6753_pairing_gadget
    from ...params._gen import curves_gen as CG
    pg, base, fq3, fq6 = mnt6753_pairing_gadget()
    c = CG.MNT6753
    g1 = SWGroupGadget(base, [c["a"]], [c["b"]])
    return Gm17VerifierGadget(pg, g1, pg.g2, fq6)


def bls12_377_verifier_gadget():
    """Groth16 verifier for BLS12-377 proofs; circuit field = BLS12-377 Fq
    (= SW6 Fr) -- the reference's third recursion configuration
    (nizk/groth16/mod.rs:431)."""
    from ..std.pairing_bls12 import bls12_377_pairing_gadget
    from ...params._gen import curves_gen as CG
    pg, base, fq2, fq12 = bls12_377_pairing_gadget()
    c = CG.BLS12_377
    g1 = SWGroupGadget(base, [c["a"]], [c["b"]])
    return Groth16VerifierGadget(pg, g1, pg.g2, fq12)
