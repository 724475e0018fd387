"""Circuits for driving the prover.

``benchmark_circuit`` is the chained-multiplication circuit of ginger-lib's
snark-scalability example, the circuit of the package's headline
configuration (Groth16 over MNT4-753 at about 2^10 constraints).
``mul_circuit`` is the one-constraint a * b = c whose proof the recursion
verifies, and ``groth16_verifier_circuit`` the recursion's outer circuit:
an MNT4-753 Groth16 verifier over MNT4-753's Fq (= MNT6-753's Fr), one step
of the MNT4/MNT6 cycle (nizk/groth16/mod.rs:517), or a BLS12-377 Groth16
verifier over BLS12-377's Fq (= SW6's Fr; nizk/groth16/mod.rs:431).
``schnorr_verification_circuit`` verifies a field-based Schnorr signature
over MNT6-753 G1 in a circuit over MNT4-753 Fr, and
``pedersen_commitment_circuit`` opens a Pedersen commitment over
Edwards-BLS12 in a circuit over BLS12-377 Fr.
"""

from __future__ import annotations

import random

from . import params as PP
from .gadgets.crypto.nizk import (bls12_377_verifier_gadget,
                                  mnt4753_verifier_gadget)
from .gadgets.crypto.pedersen import (PedersenCommitmentGadget,
                                      bytes_to_bit_gadgets)
from .gadgets.crypto.schnorr import mnt4753_schnorr_gadget
from .gadgets.std.boolean import Boolean
from .gadgets.std.fp import FpG
from .gadgets.std.te_groups import TEGroupGadget, TEPointG
from .relations.r1cs import ConstraintSystem, LinearCombination


def benchmark_circuit(fr, num_inputs: int, num_constraints: int,
                      with_values: bool = True, seed: int = 12345):
    """Inputs x_1..x_k, then constraints c_i = c_{i-1} * x_{(i mod k)+1}.
    Returns (constraint system, the public input values)."""
    p = fr.modulus
    rng = random.Random(seed)
    xs = [rng.randrange(1, p) for _ in range(num_inputs)]
    cs = ConstraintSystem(fr)
    in_vars = [cs.alloc_input(f"x{i}", xs[i] if with_values else None)
               for i in range(num_inputs)]
    prev_val = xs[0]
    prev = in_vars[0]
    for i in range(num_constraints):
        j = i % num_inputs
        new_val = prev_val * xs[j] % p
        new = cs.alloc(f"c{i}", new_val if with_values else None)
        cs.enforce(LinearCombination.of(prev),
                   LinearCombination.of(in_vars[j]),
                   LinearCombination.of(new), f"mul{i}")
        prev, prev_val = new, new_val
    return cs, xs


def mul_circuit(fr, a: int, b: int) -> ConstraintSystem:
    """c = a * b with c the one public input, then a and b."""
    cs = ConstraintSystem(fr)
    c = cs.alloc_input("c", a * b % fr.modulus)
    va = cs.alloc("a", a)
    vb = cs.alloc("b", b)
    cs.enforce(LinearCombination.of(va), LinearCombination.of(vb),
               LinearCombination.of(c), "a*b=c")
    return cs


# the verifier gadget of each inner curve, the circuit's field (the inner
# curve's Fq) and the inner curve's Fr
_VERIFIERS = {
    "mnt4753": (mnt4753_verifier_gadget, PP.MNT4753_FQ, PP.MNT4753_FR),
    "bls12_377": (bls12_377_verifier_gadget, PP.BLS12_377_FQ,
                  PP.BLS12_377_FR),
}


def groth16_verifier_circuit(vk_host: dict, proof_host: dict, inputs,
                             family: str = "mnt4753") -> ConstraintSystem:
    """The circuit over the inner curve's Fq that verifies a Groth16 proof
    over ``family`` (MNT4-753 or BLS12-377) of the statement ``inputs``
    (python ints): each input as its little-endian bits (753 or 253), the
    circuit's public inputs (``Boolean.alloc_input``, the reference's
    ``alloc_input_vec``), so that an outer proof states the inner
    statement; then the vk and the proof allocated as witnesses from their
    host dicts (``utils.convert``'s ``groth16_vk_to_host`` and
    ``proof_to_host``), and ``check_verify``.  The bits come first, as
    every input precedes the witnesses."""
    gadget, fq, fr = _VERIFIERS[family]
    vg = gadget()
    cs = ConstraintSystem(fq)
    nbits = fr.modulus_bits
    names = ["x" if j == 0 else f"x{j}" for j in range(len(inputs))]
    bits = [[Boolean.alloc_input(cs, (x >> i) & 1, f"{name}/b{i}")
             for i in range(nbits)] for x, name in zip(inputs, names)]
    vk = vg.alloc_vk(cs, vk_host)
    proof = vg.alloc_proof(cs, proof_host)
    vg.check_verify(cs, vk, bits, proof)
    return cs


def schnorr_verification_circuit(pk, sig, message) -> ConstraintSystem:
    """The circuit over MNT4-753 Fr (= MNT6-753 Fq) that a Schnorr
    signature ``sig`` = (e, s) on ``message`` (field elements) verifies
    under ``pk`` (affine ([x], [y]) over MNT6-753 G1): the message's
    elements, then pk's coordinates, are the public inputs (pk checked on
    the curve, as ``alloc_checked`` does); e and s are witnesses, and
    ``enforce_signature_verification`` holds e to Poseidon(m || R'.x ||
    R'.y || pk.x)."""
    vg = mnt4753_schnorr_gadget()
    cs = ConstraintSystem(PP.MNT4753_FR)
    msg = [FpG.alloc_input(cs, m, f"m{i}") for i, m in enumerate(message)]
    pkg = vg.g.alloc_input(cs, pk, "pk")
    vg.g.enforce_on_curve(cs, pkg, "pk/on_curve")
    vg.enforce_signature_verification(cs, pkg, vg.alloc_signature(cs, sig),
                                      msg)
    return cs


def pedersen_commitment_circuit(comm, data: bytes, randomness: int,
                                commitment) -> ConstraintSystem:
    """The opening of a Pedersen commitment over the twisted-Edwards curve
    of ``comm`` (a ``primitives/commitment.PedersenCommitment`` after setup;
    only its host values are read), in a circuit over the curve's base
    field: the commitment's affine (x, y) are the public inputs, enforced
    equal to ``check_commitment`` of the data's bits and the randomness's
    ``modulus_bits`` bits (LSB first), both witnesses."""
    g = comm.g
    gg = TEGroupGadget.for_curve(g)
    cs = ConstraintSystem(g.fp)
    out = TEPointG(FpG.alloc_input(cs, commitment[0], "commitment/x"),
                   FpG.alloc_input(cs, commitment[1], "commitment/y"))
    gadget = PedersenCommitmentGadget(gg, comm.crh.w,
                                      comm.crh.generators_host,
                                      comm.rand_base_host)
    bits = bytes_to_bit_gadgets(cs, data)
    rbits = [Boolean.alloc(cs, bool((randomness >> i) & 1), f"r{i}")
             for i in range(g.scalar_field.modulus_bits)]
    gg.enforce_equal(cs, gadget.check_commitment(cs, bits, rbits), out,
                     "opening")
    return cs
