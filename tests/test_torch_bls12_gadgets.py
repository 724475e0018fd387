"""Port vs JAX package: the BLS12 gadgets -- the tower gadgets Fq2, Fq6 =
Fq2[V]/(V^3 - xi), Fq12 (``gadgets/std/ext_fields.build_bls12_tower_
gadgets``), the pairing gadget (``gadgets/std/pairing_bls12``) and the
BLS12-377 Groth16 verifier circuit (``gadgets/crypto/nizk.bls12_377_
verifier_gadget``, ``circuits.groth16_verifier_circuit(..., "bls12_377")``)
-- against ``gingerlib_tpu/gadgets`` on the same inputs, over BLS12-377 Fq
and BLS12-381 Fq.  Host code in python ints: every case builds one
circuit through both packages and holds them equal entry for entry (the
constraint count, the names, the three matrices and the whole
``assignment()``), checks the values against the port's python-int towers
and pairing, and that the port's system is satisfied and refuses a lie.
Tolerance 0.

Fast tier (~10 s in one process): the tower gadgets on both curves; one
pairing gadget each (the D- and the M-twist) whose GT equals
``HostBls12Pairing``'s.  ``slow``: the 42,006-constraint verifier circuit
of a BLS12-377 proof of 7 * 11 = 77 (its 253 bits public inputs, 254 with
the ONE) against the JAX gadget fed the same bits, satisfied, and the
input 78 refused (~20 s).
"""

import random

import pytest

from gingerlib_tpu import params as JP
from gingerlib_tpu.gadgets.crypto import nizk as jnizk
from gingerlib_tpu.gadgets.std import pairing_bls12 as jpb
from gingerlib_tpu.gadgets.std.boolean import Boolean as JBoolean
from gingerlib_tpu.relations import r1cs as jr1cs
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.circuits import (groth16_verifier_circuit,
                                          mul_circuit)
from gingerlib_tpu_torch.curves import pairing_host as TPH
from gingerlib_tpu_torch.fields import host_ext as HE
from gingerlib_tpu_torch.gadgets.std import pairing_bls12 as tpb
from gingerlib_tpu_torch.params._gen import curves_gen as CG, \
    towers_gen as TG
from gingerlib_tpu_torch.proofs.groth16_host import (host_curves,
                                                     host_groth16_bls12_377)
from test_torch_gadgets import JAX, PORT, both, lie
from test_torch_recursion import BLIND, TOXIC, same_system

FIELDS = ["BLS12_377_FQ", "BLS12_381_FQ"]


def tower_args(field):
    up = field[:-3]
    return (getattr(TG, f"{up}_FQ2")["nonresidue"],
            getattr(TG, f"{up}_FQ6")["nonresidue"])


@pytest.mark.parametrize("field", FIELDS)
def test_tower_gadgets(field):
    """Fq2, Fq6 and Fq12: mul, sqr, inv (checked in the circuit), frob
    at 1, 2 and 3, mul_by_const and the Fq12 conjugate, every value
    against the port's host towers; the gadgets' own host multiply and
    inverse against them too."""
    nr2, xi = tower_args(field)
    p = getattr(TP, field).modulus
    H = HE.build_bls12_host_towers(p, nr2, xi)[1:]

    def build(pkg, cs):
        rng = random.Random(field)
        gadgets = pkg.EF.build_bls12_tower_gadgets(getattr(pkg.PP, field),
                                                   nr2, xi)[1:]
        outs = []
        for G, T in zip(gadgets, H):
            av = [rng.randrange(p) for _ in range(G.K)]
            bv = [rng.randrange(p) for _ in range(G.K)]
            a, b = G.alloc(cs, av), G.alloc(cs, bv)
            prod = G.mul(cs, a, b)
            assert G.value(prod) == HE.host_ext_mul(T, av, bv)
            assert G.value(G.sqr(cs, a)) == HE.host_ext_mul(T, av, av)
            inv = G.inv(cs, a)
            assert G.value(inv) == HE.host_ext_inv(T, av)
            G.enforce_equal(cs, G.mul(cs, a, inv), G.one(cs))
            for i in (1, 2, 3):
                assert G.value(G.frob(cs, a, i)) == \
                    HE.host_ext_frob(T, av, i)
            assert G.value(G.mul_by_const(cs, a, bv)) == \
                HE.host_ext_mul(T, av, bv)
            if G.degree == 2:
                G.conjugate(cs, a)
            assert pkg.G._host_ext_mul(G, av, bv) == \
                HE.host_ext_mul(T, av, bv)
            assert pkg.G._host_ext_inv(G, av) == HE.host_ext_inv(T, av)
            outs.append(prod)
        return outs

    cs, outs = both(build, field)
    lie(cs, next(iter(outs[-1][0].lc.terms)))


PAIRING_GADGETS = {"BLS12_377_FQ": ("bls12_377", CG.BLS12_377),
                   "BLS12_381_FQ": ("bls12_381", CG.BLS12_381)}


@pytest.mark.parametrize("field", FIELDS)
def test_pairing_gadget(field):
    """e([5]G, [7]H) in the circuit: prepare_g2 (the affine slopes), the
    Miller loop over the bits of x (the conjugate where x < 0) and the
    final exponentiation, equal to ``HostBls12Pairing``'s GT."""
    family, c = PAIRING_GADGETS[field]
    g1h, g2h, _ = host_curves(family)
    P1, Q1 = g1h.mul(g1h.gen, 5), g2h.mul(g2h.gen, 7)
    want = getattr(TPH, f"host_{family}_pairing")().pairing(P1, Q1)

    def build(pkg, cs):
        mod = jpb if pkg is JAX else tpb
        pg, base, _, fqk = getattr(mod, f"{family}_pairing_gadget")()
        g1 = pkg.G.SWGroupGadget(base, [c["a"]], [c["b"]])
        gt = pg.pairing_product(cs, [g1.alloc_checked(cs, P1, "aG")],
                                [pg.g2.alloc_checked(cs, Q1, "bH")], "e")
        assert fqk.value(gt) == want
        return gt

    cs, gt = both(build, field)
    lie(cs, cs.num_inputs)       # aG.x, in the first constraints


@pytest.fixture(scope="module")
def inner_bls():
    """The BLS12-377 proof of 7 * 11 = 77 by the port's host Groth16, with
    the toxic waste of tests/test_torch_recursion.py."""
    H = host_groth16_bls12_377()
    cs = mul_circuit(TP.BLS12_377_FR, 7, 11)
    params = H.setup(cs, **TOXIC)
    proof = H.prove(cs, params, **BLIND)
    assert H.verify(params, proof, [77]) and not H.verify(params, proof,
                                                          [78])
    return params.vk, proof


def jax_bls12_circuit(vk, proof, x):
    """The JAX package's BLS12-377 verifier circuit with the statement's
    bits as public inputs (``Boolean.alloc_input``), allocated first."""
    vg = jnizk.bls12_377_verifier_gadget()
    cs = jr1cs.ConstraintSystem(JP.BLS12_377_FQ)
    bits = [JBoolean.alloc_input(cs, (x >> i) & 1, f"x/b{i}")
            for i in range(JP.BLS12_377_FR.modulus_bits)]
    vkg = vg.alloc_vk(cs, vk)
    proofg = vg.alloc_proof(cs, proof)
    vg.check_verify(cs, vkg, [bits], proofg)
    return cs


@pytest.mark.slow
@pytest.mark.parametrize("x", [77, 78])
def test_bls12_377_verifier_circuit_matches_jax(inner_bls, x):
    vk, proof = inner_bls
    tcs = groth16_verifier_circuit(vk, proof, [x], "bls12_377")
    same_system(tcs, jax_bls12_circuit(vk, proof, x))
    assert (tcs.num_constraints, tcs.num_inputs) == (42006, 254)
    assert (tcs.which_is_unsatisfied() is None) == (x == 77)
