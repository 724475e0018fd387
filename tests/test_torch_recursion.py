"""Port vs JAX package: one step of recursion over the MNT4-753 / MNT6-753
cycle (nizk/groth16/mod.rs:517).  An MNT4-753 Groth16 proof of 7 * 11 = 77
is verified inside a circuit over MNT4-753's Fq (= MNT6-753's Fr) built by
the ported gadgets.  Host code in python ints; tolerance 0.

Fast tier (~65 s in one process): the port's ``HostGroth16`` against the
JAX package's on the a*b=c circuit (every parameter, the proof, verify)
and against the closed-form ``expected_proof``; ``mul_circuit`` against
the JAX tests' circuit; the bridge from device tensors (on the CPU) to the
gadgets' host dicts; and the 61,407-constraint verifier circuit with the
statement's bits as public inputs (754 inputs), built once by each package
from the same host dicts (the JAX gadget fed ``Boolean.alloc_input``
bits), equal in its count, names, matrices and ``assignment()``, and
satisfied.

``slow``: the public inputs read back and the input 78 refused; the GM17
verifier circuit against the JAX package's; ``mnt6753_verifier_gadget``
at full size; the inner proof made by the device path on the CPU (setup
~2 min, prove minutes) equal to ``HostGroth16``'s through the bridge.
"""

import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.gadgets.crypto import nizk as jnizk
from gingerlib_tpu.gadgets.std.boolean import Boolean as JBoolean
from gingerlib_tpu.proofs import groth16_host as jgroth16_host
from gingerlib_tpu.relations import r1cs as jr1cs
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.circuits import (groth16_verifier_circuit,
                                          mul_circuit)
from gingerlib_tpu_torch.curves import instances as CI
from gingerlib_tpu_torch.gadgets.crypto import nizk as tnizk
from gingerlib_tpu_torch.proofs import gm17, gm17_host, groth16
from gingerlib_tpu_torch.proofs.groth16_host import (
    expected_proof, host_groth16_mnt4753, host_groth16_mnt6753)
from gingerlib_tpu_torch.relations import r1cs as tr1cs
from gingerlib_tpu_torch.utils import convert

torch.set_num_threads(1)
# the toxic waste and blinding of tests/test_recursion.py
TOXIC = dict(alpha=1234, beta=5678, gamma=9101, delta=1121, t=31415)
BLIND = dict(r=171717, s=282828)
NBITS = TP.MNT4753_FR.modulus_bits


def jax_mul_circuit(field, a_val, b_val):
    """tests/test_recursion.py's ``_mul_circuit``."""
    cs = jr1cs.ConstraintSystem(field)
    c = cs.alloc_input("c", a_val * b_val % field.modulus)
    a = cs.alloc("a", a_val)
    b = cs.alloc("b", b_val)
    cs.enforce(jr1cs.LinearCombination.of(a), jr1cs.LinearCombination.of(b),
               jr1cs.LinearCombination.of(c), "a*b=c")
    return cs


def vk_dict(params):
    return {k: params.vk[k] for k in ("alpha_g1_beta_g2", "gamma_g2",
                                      "delta_g2", "gamma_abc")}


def jax_verifier_circuit(vk, proof, x, public, gadget=None):
    """The JAX package's verifier circuit as tests/test_recursion.py
    builds it; with ``public`` the bits through ``Boolean.alloc_input``,
    allocated first."""
    vg = gadget or jnizk.mnt4753_verifier_gadget()
    cs = jr1cs.ConstraintSystem(vg.pg.fq)
    nbits = JP.MNT4753_FR.modulus_bits if vg.pg.fq is JP.MNT4753_FQ \
        else JP.MNT6753_FR.modulus_bits
    if public:
        bits = [JBoolean.alloc_input(cs, (x >> i) & 1, f"x/b{i}")
                for i in range(nbits)]
    vkg = vg.alloc_vk(cs, vk)
    proofg = vg.alloc_proof(cs, proof)
    if not public:
        bits = vg.alloc_input_bits(cs, x, nbits, "x")
    vg.check_verify(cs, vkg, [bits], proofg)
    return cs


def same_system(tcs, jcs):
    assert (tcs.num_constraints, tcs.num_inputs, tcs.num_aux) == \
        (jcs.num_constraints, jcs.num_inputs, jcs.num_aux)
    assert tcs.names == jcs.names
    assert (tcs.at, tcs.bt, tcs.ct) == (jcs.at, jcs.bt, jcs.ct)
    assert tcs.assignment() == jcs.assignment()


@pytest.fixture(scope="module")
def inner():
    """The inner proof of 7 * 11 = 77 by both packages' host Groth16."""
    H = host_groth16_mnt4753()
    cs = mul_circuit(TP.MNT4753_FR, 7, 11)
    params = H.setup(cs, **TOXIC)
    proof = H.prove(cs, params, **BLIND)
    J = jgroth16_host.host_groth16_mnt4753()
    jcs = jax_mul_circuit(JP.MNT4753_FR, 7, 11)
    jparams = J.setup(jcs, **TOXIC)
    return H, cs, params, proof, jparams, J.prove(jcs, jparams, **BLIND)


def test_mul_circuit_matches_the_jax_tests():
    same_system(mul_circuit(TP.MNT4753_FR, 7, 11),
                jax_mul_circuit(JP.MNT4753_FR, 7, 11))


def test_host_groth16_matches_jax_and_the_oracle(inner):
    H, cs, params, proof, jparams, jproof = inner
    assert params.vk == jparams.vk
    for name in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
                 "a_query", "b_g1_query", "b_g2_query", "h_query",
                 "l_query", "num_inputs", "domain_size"):
        assert getattr(params, name) == getattr(jparams, name), name
    assert proof == jproof
    assert proof == expected_proof("mnt4753", cs, **TOXIC, **BLIND)
    assert H.verify(params, proof, [77])
    assert not H.verify(params, proof, [78])
    vk_only = H.setup_vk(cs, **TOXIC)
    assert vk_only.vk == params.vk and vk_only.a_query is None


def test_bridge_from_device_tensors(inner):
    """A vk and a proof held as the device's Montgomery tensors (here on
    the CPU) come back as the gadgets' host dicts, for Groth16 and GM17."""
    _, _, params, proof, _, _ = inner
    eng = CI.mnt4753_engine("cpu")
    g1, g2, F = eng.g1, eng.g2, eng.fqk

    def dev(curve, xy):
        return curve.affine_from_ints(*xy)

    def query(pts):
        xs, ys = zip(*(dev(g1, pt) for pt in pts))
        return torch.stack(xs), torch.stack(ys), None

    gt = torch.from_numpy(F.const(params.vk["alpha_g1_beta_g2"]))
    vk = groth16.VerifyingKey(
        alpha_g1_beta_g2=gt, gamma_g2=dev(g2, params.vk["gamma_g2"]),
        delta_g2=dev(g2, params.vk["delta_g2"]),
        gamma_abc_g1=query(params.vk["gamma_abc"])[:2])
    assert convert.groth16_vk_to_host(eng, vk) == vk_dict(params)
    dproof = groth16.Proof(a=dev(g1, proof["a"]), b=dev(g2, proof["b"]),
                           c=dev(g1, proof["c"]))
    assert convert.proof_to_host(eng, dproof) == proof
    pts = [params.alpha_g1, params.beta_g2, params.beta_g1,
           params.delta_g1, params.delta_g2]
    gvk = gm17.GM17VerifyingKey(
        h_g2=dev(g2, pts[1]), g_alpha_g1=dev(g1, pts[0]),
        h_beta_g2=dev(g2, pts[4]), g_gamma_g1=dev(g1, pts[2]),
        h_gamma_g2=dev(g2, pts[1]), query=query(pts[2:4]),
        g_alpha_h_beta=gt)
    assert convert.gm17_vk_to_host(eng, gvk) == {
        "h_g2": pts[1], "g_alpha_g1": pts[0], "h_beta_g2": pts[4],
        "g_gamma_g1": pts[2], "h_gamma_g2": pts[1], "query": pts[2:4],
        "g_alpha_h_beta": params.vk["alpha_g1_beta_g2"]}
    with pytest.raises(ValueError, match="alpha_g1_beta_g2"):
        convert.groth16_vk_to_host(eng, groth16.VerifyingKey(
            None, vk.gamma_g2, vk.delta_g2, vk.gamma_abc_g1))


@pytest.fixture(scope="module")
def circuits(inner):
    """The verifier circuit of the inner proof, both packages, the bits of
    77 as public inputs."""
    _, _, params, proof, _, _ = inner
    return (groth16_verifier_circuit(vk_dict(params), proof, [77]),
            jax_verifier_circuit(vk_dict(params), proof, 77, public=True))


def test_verifier_circuit_matches_jax_and_is_satisfied(circuits):
    tcs, jcs = circuits
    assert (tcs.num_constraints, tcs.num_variables, tcs.num_inputs) == \
        (61407, 61418, 1 + NBITS)
    same_system(tcs, jcs)
    assert tcs.which_is_unsatisfied() is None
    # the matrices' density sets the COO compile's cost: B's 13.3 million
    # terms share 4,744 distinct coefficients
    assert [sum(map(len, m)) for m in (tcs.at, tcs.bt, tcs.ct)] == \
        [2624057, 13327911, 54637]
    assert len({k for row in tcs.bt for _, k in row}) == 4744


@pytest.mark.slow
def test_public_input_circuit_matches_jax(inner, circuits):
    """The statement's 753 bits are the public inputs, in order; the same
    circuit over the bits of 78 is not satisfied."""
    _, _, params, proof, _, _ = inner
    tcs, jcs = circuits
    assert tcs.input_values[1:] == jcs.input_values[1:] == \
        [(77 >> i) & 1 for i in range(NBITS)]
    bad = groth16_verifier_circuit(vk_dict(params), proof, [78])
    assert bad.which_is_unsatisfied() is not None


@pytest.mark.slow
def test_gm17_verifier_circuit_matches_jax():
    """tests/test_gm17_recursion.py's setup: a GM17 proof over MNT4-753
    verified over MNT4-753 Fq, the port's gadget against the JAX one."""
    H = gm17_host.host_gm17_mnt4753()
    cs = mul_circuit(TP.MNT4753_FR, 7, 11)
    params = H.setup(cs, alpha=321, beta=654, t=24680)
    proof = H.prove(cs, params, d1=11, d2=22, r=333)
    assert H.verify(params, proof, [77])
    vk = {k: params.vk[k] for k in ("h_g2", "g_alpha_g1", "h_beta_g2",
                                    "g_gamma_g1", "h_gamma_g2", "query")}
    vk["g_alpha_h_beta"] = H.E.pairing(vk["g_alpha_g1"], vk["h_beta_g2"])
    systems = []
    for R, vg in ((tr1cs, tnizk.mnt4753_gm17_verifier_gadget()),
                  (jr1cs, jnizk.mnt4753_gm17_verifier_gadget())):
        cs = R.ConstraintSystem(vg.pg.fq)
        vkg, proofg = vg.alloc_vk(cs, vk), vg.alloc_proof(cs, proof)
        vg.check_verify(cs, vkg, [vg.alloc_input_bits(cs, 77, NBITS, "x")],
                        proofg)
        systems.append(cs)
    same_system(*systems)
    assert systems[0].which_is_unsatisfied() is None


@pytest.mark.slow
def test_mnt6753_verifier_gadget_at_full_size():
    """The cycle's other step: an MNT6-753 proof verified over MNT6-753 Fq
    (= MNT4-753 Fr), the port's gadget against the JAX one."""
    H = host_groth16_mnt6753()
    cs = mul_circuit(TP.MNT6753_FR, 7, 11)
    params = H.setup(cs, **TOXIC)
    proof = H.prove(cs, params, **BLIND)
    assert H.verify(params, proof, [77])
    vg = tnizk.mnt6753_verifier_gadget()
    tcs = tr1cs.ConstraintSystem(vg.pg.fq)
    vkg, proofg = vg.alloc_vk(tcs, vk_dict(params)), vg.alloc_proof(tcs,
                                                                    proof)
    vg.check_verify(tcs, vkg, [vg.alloc_input_bits(
        tcs, 77, TP.MNT6753_FR.modulus_bits, "x")], proofg)
    same_system(tcs, jax_verifier_circuit(
        vk_dict(params), proof, 77, False,
        jnizk.mnt6753_verifier_gadget()))
    assert tcs.which_is_unsatisfied() is None


@pytest.mark.slow
def test_inner_proof_on_the_device_path(inner):
    """The inner proof made by the device path (plain versions on the
    CPU), through the bridge: the vk and the proof equal to
    ``HostGroth16``'s; verify accepts 77 and refuses 78."""
    _, cs, params, proof, _, _ = inner
    eng = CI.mnt4753_engine("cpu")
    dparams = groth16.generate_parameters(eng, cs, **TOXIC, device="cpu")
    assert convert.groth16_vk_to_host(eng, dparams.vk) == vk_dict(params)
    dproof = groth16.create_proof(
        eng, dparams, tr1cs.compile_r1cs(cs, device="cpu"),
        cs.assignment(), **BLIND, device="cpu")
    assert convert.proof_to_host(eng, dproof) == proof
    assert groth16.verify_proof(eng, dparams.vk, dproof, [77])
    assert not groth16.verify_proof(eng, dparams.vk, dproof, [78])
