"""Port vs JAX package: field-based Schnorr and EC-VRF over MNT6-753 G1 with
Poseidon over MNT4-753 Fr (``gingerlib_tpu_torch/primitives/{schnorr,vrf,
signatures_host}.py``), the Poseidon, Schnorr and VRF gadgets and the
Schnorr verification circuit (``circuits.schnorr_verification_circuit``),
with the JAX tests' seeds (Schnorr ``random.Random(1231275789)``,
``tests/test_schnorr.py:67``; VRF ``random.Random(9174123)`` with the
64 x 4 group hash, ``tests/test_vrf.py:77-79``).  Tolerance 0.

Fast tier: the Poseidon gadget's constraint system against the JAX
gadget's; the Schnorr circuit against the same system built by the JAX
gadgets, satisfied, and unsatisfied with e + 1; an off-curve gamma
refused.  ``slow``: the JAX package's empty subgroup check
(``FieldBasedEcVrf.proof_to_hash`` multiplies gamma by r reduced mod r,
i.e. by 0) lets a BLS12-377 point outside the subgroup past it, and the
port's check refuses it; the python-int oracles against the JAX tests'
own; ``FieldBasedSchnorr`` and ``FieldBasedEcVrf`` end to end on
the CPU (753-step double-and-add loops, ~20 s each on a CPU) against the
oracles and the JAX classes; the VRF gadget circuit; the Schnorr circuit's
Groth16 proof over MNT4-753 and a Pedersen commitment opening's over
BLS12-377, made on the CPU and held to the closed-form oracle.
"""

import random
from types import SimpleNamespace

import pytest

from gingerlib_tpu import params as JP
from gingerlib_tpu.gadgets.crypto import poseidon as jpos
from gingerlib_tpu.gadgets.crypto import schnorr as jsch
from gingerlib_tpu.gadgets.std import fp as jfpg
from gingerlib_tpu.relations import r1cs as jr1cs
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.circuits import (pedersen_commitment_circuit,
                                          schnorr_verification_circuit)
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.gadgets.crypto import poseidon as tpos
from gingerlib_tpu_torch.gadgets.crypto import vrf as tvrf
from gingerlib_tpu_torch.gadgets.std import fp as tfpg
from gingerlib_tpu_torch.primitives import group_hash_host as tgh
from gingerlib_tpu_torch.primitives.pedersen import (BoweHopwoodCRH,
                                                     PedersenWindow)
from gingerlib_tpu_torch.primitives.poseidon import (PoseidonHash,
                                                     PoseidonParams)
from gingerlib_tpu_torch.primitives.poseidon_host import PoseidonHost
from gingerlib_tpu_torch.primitives.schnorr import (FieldBasedSchnorr,
                                                    SchnorrSignature)
from gingerlib_tpu_torch.primitives.signatures_host import (HostSchnorr,
                                                            HostVrf)
from gingerlib_tpu_torch.primitives.vrf import (EcVrfProof, FieldBasedEcVrf,
                                                in_prime_subgroup)
from gingerlib_tpu_torch.relations import r1cs as tr1cs

MESSAGE = [424242]
VRF_MESSAGE = [987654321]


@pytest.fixture(scope="module")
def signed():
    rng = random.Random(1231275789)
    hs = HostSchnorr()
    pk, sk = hs.keygen(rng)
    return hs, pk, sk, hs.sign(pk, sk, MESSAGE, rng)


def systems_equal(jcs, tcs):
    assert (tcs.num_constraints, tcs.num_inputs, tcs.num_aux) == \
        (jcs.num_constraints, jcs.num_inputs, jcs.num_aux)
    assert tcs.names == jcs.names
    assert (tcs.at, tcs.bt, tcs.ct) == (jcs.at, jcs.bt, jcs.ct)
    assert tcs.assignment() == jcs.assignment()


@pytest.mark.parametrize("name", ["mnt4753", "mnt6753"])
def test_poseidon_gadget_matches_jax(name):
    # three inputs: a full chunk and a trailing one; two: one chunk
    field, inputs = ("MNT4753_FR", [5, 0, 2 ** 700 + 3]) \
        if name == "mnt4753" else ("MNT6753_FR", [5, 2 ** 700 + 3])
    out = {}
    for pkg, G, FpG, R, PPm in (("jax", jpos, jfpg.FpG, jr1cs, JP),
                                ("port", tpos, tfpg.FpG, tr1cs, TP)):
        cs = R.ConstraintSystem(getattr(PPm, field))
        xs = [FpG.alloc_input(cs, inputs[0], "in")] + \
            [FpG.alloc(cs, v, f"w{i}") for i, v in enumerate(inputs[1:])]
        out[pkg] = (cs, getattr(G.PoseidonGadget, name)().evaluate(cs, xs))
    systems_equal(out["jax"][0], out["port"][0])
    assert out["port"][0].which_is_unsatisfied() is None
    assert out["port"][1].value == \
        getattr(PoseidonHost, name)().evaluate(inputs)


def test_schnorr_circuit_matches_jax_gadget(signed):
    """``schnorr_verification_circuit`` (the message and pk public) against
    the same allocation through the JAX package's gadgets: one constraint
    system, 19,292 constraints, satisfied; with e + 1 unsatisfied."""
    _, pk, _, sig = signed
    cs = schnorr_verification_circuit(pk, sig, MESSAGE)
    vg = jsch.mnt4753_schnorr_gadget()
    jcs = jr1cs.ConstraintSystem(JP.MNT4753_FR)
    msg = [jfpg.FpG.alloc_input(jcs, m, f"m{i}")
           for i, m in enumerate(MESSAGE)]
    pkg = vg.g.alloc_input(jcs, pk, "pk")
    vg.g.enforce_on_curve(jcs, pkg, "pk/on_curve")
    vg.enforce_signature_verification(jcs, pkg, vg.alloc_signature(jcs, sig),
                                      msg)
    systems_equal(jcs, cs)
    assert (cs.num_constraints, cs.num_inputs) == (19292, 4)
    assert cs.input_values[1:] == MESSAGE + [pk[0][0], pk[1][0]]
    assert cs.which_is_unsatisfied() is None
    bad = schnorr_verification_circuit(pk, (sig[0] + 1, sig[1]), MESSAGE)
    assert bad.which_is_unsatisfied() is not None


def cpu_vrf(gh=None):
    g = TCI.mnt6753_g1("cpu")
    h = PoseidonHash(PoseidonParams.mnt4753("cpu"), device="cpu")
    return FieldBasedEcVrf(g, h, gh or BoweHopwoodCRH(g, PedersenWindow(
        64, 4)))


def test_vrf_refuses_an_off_curve_gamma():
    """The subgroup check of gamma on MNT6-753 G1 (cofactor 1), where the
    on-curve check is the whole check: an off-curve gamma is refused
    before any multiply, and the generator passes.  (The JAX class refuses
    an off-curve gamma too; the fault shows only off the subgroup, in
    ``test_subgroup_check_multiplies_by_the_full_r``.)"""
    vrf = cpu_vrf()
    g = vrf.g
    with pytest.raises(ValueError, match="gamma not in prime-order"):
        vrf.proof_to_hash(g.generator(()), VRF_MESSAGE,
                          EcVrfProof(gamma=(1, 2), c=1, s=1))
    assert in_prime_subgroup(g, g.generator(()))


@pytest.mark.slow
def test_subgroup_check_multiplies_by_the_full_r():
    """Where the cofactor is not 1 (BLS12-377 G1), a point of the curve
    outside the subgroup, (2, 3) on y^2 = x^3 + 1, as gamma.  The JAX
    class's subgroup check (``gingerlib_tpu/primitives/vrf.py:113-117``:
    on the curve, then its own ``_mul`` by r, which reduces r mod r to 0,
    then ``is_zero``) passes it; the port's ``proof_to_hash`` multiplies by
    r itself and refuses it, and the generator passes.  The JAX check runs
    step by step on gamma in the layout ``_mul`` takes: the class's own
    ``proof_to_hash`` drops gamma's coordinate axis (``c[0]``, :111), and
    its multiply's scan then refuses the carry, whatever gamma is.  The
    hasher's field is the curve's base field, as both classes require; no
    hash or group hash is reached."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gingerlib_tpu.curves import instances as JCI
    from gingerlib_tpu.fields import fp as jfp
    from gingerlib_tpu.primitives import vrf as jvrf
    jg = JCI.bls12_377_g1()
    jv = jvrf.FieldBasedEcVrf(jg, SimpleNamespace(F=jg.fp), None)
    with pytest.raises(TypeError, match="carry"):
        jv.proof_to_hash(None, [1], jvrf.EcVrfProof(gamma=(2, 3), c=1, s=1))
    gamma = jg.from_affine(*(jnp.asarray(jfp.fp_from_int(jg.fp, v))[None]
                             for v in (2, 3)))
    assert bool(np.asarray(jax.jit(jg.on_curve)(gamma[0], gamma[1])))
    assert bool(np.asarray(jg.is_zero(jv._mul(gamma, jv.Fr.modulus))))
    g = TCI.bls12_377_g1("cpu")
    tv = FieldBasedEcVrf(g, SimpleNamespace(F=g.fp, device=g.device),
                         SimpleNamespace(g=g))
    with pytest.raises(ValueError, match="gamma not in prime-order"):
        tv.proof_to_hash(None, [1], EcVrfProof(gamma=(2, 3), c=1, s=1))
    assert in_prime_subgroup(g, g.generator(()))


# ---------------------------------------------------------------------------
# slow: the oracles, the primitives end to end, the VRF gadget, Groth16
# ---------------------------------------------------------------------------

def vrf_case():
    rng = random.Random(9174123)
    gh = tgh.mnt6753_g1_group_hash(window_size=64, num_windows=4).setup(rng)
    hv = HostVrf(gh)
    pk, sk = hv.keygen(rng)
    proof = hv.prove(pk, sk, VRF_MESSAGE, rng)
    return gh, hv, pk, sk, proof, rng


@pytest.mark.slow
def test_host_oracles_match_the_jax_tests(signed):
    import test_schnorr
    import test_vrf
    hs, pk, _, sig = signed
    rng = random.Random(1231275789)
    jhs = test_schnorr.HostSchnorr()
    jpk, jsk = jhs.keygen(rng)
    assert (jpk, jhs.sign(jpk, jsk, MESSAGE, rng)) == (pk, sig)
    assert hs.verify(pk, MESSAGE, sig) and \
        not hs.verify(pk, [MESSAGE[0] + 1], sig)
    gh, hv, pk, _, proof, _ = vrf_case()
    rng = random.Random(9174123)
    from gingerlib_tpu.primitives.group_hash_host import \
        mnt6753_g1_group_hash
    jgh = mnt6753_g1_group_hash(window_size=64, num_windows=4).setup(rng)
    jhv = test_vrf.HostVrf(jgh)
    jpk, jsk = jhv.keygen(rng)
    jproof = jhv.prove(jpk, jsk, VRF_MESSAGE, rng)
    assert (jpk, jproof) == (pk, proof)
    assert jhv.proof_to_hash(jpk, VRF_MESSAGE, jproof) == \
        hv.proof_to_hash(pk, VRF_MESSAGE, proof)


def affine(g, P):
    x, y = g.to_affine(P)
    return ([tfp.fp_to_int(g.fp, x[0])], [tfp.fp_to_int(g.fp, y[0])])


@pytest.mark.slow
def test_schnorr_end_to_end_on_the_cpu(signed):
    hs, pk_h, _, sig_h = signed
    g = TCI.mnt6753_g1("cpu")
    sch = FieldBasedSchnorr(g, PoseidonHash(PoseidonParams.mnt4753("cpu"),
                                            device="cpu"))
    rng = random.Random(1231275789)
    pk, sk = sch.keygen(rng)
    sig = sch.sign(pk, sk, MESSAGE, rng)
    assert affine(g, pk) == pk_h and (sig.e, sig.s) == sig_h
    assert sch.verify(pk, MESSAGE, sig)
    assert not sch.verify(pk, [MESSAGE[0] + 1], sig)
    assert sch.keyverify(pk)
    with pytest.raises(ValueError):
        sch.verify(pk, MESSAGE, SchnorrSignature(e=1 << 752, s=sig.s))


@pytest.mark.slow
def test_schnorr_matches_the_jax_class(signed):
    """The JAX package's FieldBasedSchnorr on the same seed (its jitted
    753-bit scans compile for minutes on a CPU) signs as the port does."""
    from gingerlib_tpu.curves import instances as JCI
    from gingerlib_tpu.primitives.poseidon import PoseidonHash as JHash
    from gingerlib_tpu.primitives.poseidon import PoseidonParams as JParams
    from gingerlib_tpu.primitives.schnorr import FieldBasedSchnorr as JSch
    _, pk_h, _, sig_h = signed
    jsch_ = JSch(JCI.mnt6753_g1(), JHash(JParams.mnt4753()))
    rng = random.Random(1231275789)
    jpk, jsk = jsch_.keygen(rng)
    jsig = jsch_.sign(jpk, jsk, MESSAGE, rng)
    assert (jsig.e, jsig.s) == sig_h
    assert jsch_.verify(jpk, MESSAGE, jsig)


@pytest.mark.slow
def test_vrf_end_to_end_on_the_cpu():
    gh_h, hv, pk_h, _, proof_h, _ = vrf_case()
    g = TCI.mnt6753_g1("cpu")
    rng = random.Random(9174123)
    gh = BoweHopwoodCRH(g, PedersenWindow(64, 4)).setup(rng)
    vrf = cpu_vrf(gh)
    pk, sk = vrf.keygen(rng)
    proof = vrf.prove(pk, sk, VRF_MESSAGE, rng)
    assert affine(g, pk) == pk_h
    assert ((list(proof.gamma[:1]), list(proof.gamma[1:])), proof.c,
            proof.s) == (proof_h[0], proof_h[1], proof_h[2])
    assert vrf.proof_to_hash(pk, VRF_MESSAGE, proof) == \
        hv.proof_to_hash(pk_h, VRF_MESSAGE, proof_h)
    with pytest.raises(ValueError, match="VRF verification failed"):
        vrf.proof_to_hash(pk, [VRF_MESSAGE[0] + 1], proof)


@pytest.mark.slow
def test_vrf_gadget_circuit():
    gh, hv, pk, _, proof, _ = vrf_case()
    out = hv.proof_to_hash(pk, VRF_MESSAGE, proof)
    vg = tvrf.mnt4753_vrf_gadget(gh)
    cs = tr1cs.ConstraintSystem(TP.MNT4753_FR)
    pkg = vg.g.alloc_checked(cs, pk, "pk")
    proofg = vg.alloc_proof(cs, proof)
    msg = [tfpg.FpG.alloc(cs, m) for m in VRF_MESSAGE]
    assert vg.enforce_proof_to_hash_verification(cs, pkg, proofg,
                                                 msg).value == out
    assert cs.which_is_unsatisfied() is None


def prove_on_the_cpu(family, cs):
    """Groth16 setup, prove and verify on the CPU, the proof against the
    closed form; a wrong first input is refused."""
    from gingerlib_tpu_torch.proofs import groth16, groth16_host
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
    toxic = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)
    eng = getattr(TCI, f"{family}_engine")("cpu")
    params = groth16.generate_parameters(eng, cs, **toxic, device="cpu")
    proof = groth16.create_proof(eng, params, compile_r1cs(cs, device="cpu"),
                                 cs.assignment(), r=31337, s=71717,
                                 device="cpu")
    assert groth16.proof_to_ints(eng, proof) == groth16_host.expected_proof(
        family, cs, **toxic, r=31337, s=71717)
    inputs = cs.input_values[1:]
    assert groth16.verify_proof(eng, params.vk, proof, inputs)
    assert not groth16.verify_proof(eng, params.vk, proof,
                                    [inputs[0] + 1] + inputs[1:])


@pytest.mark.slow
def test_pedersen_opening_proof_on_the_cpu():
    """A commitment over Edwards-BLS12 at window 4 x 8, its opening
    circuit over BLS12-377 Fr proven over BLS12-377."""
    from gingerlib_tpu_torch.primitives.commitment import PedersenCommitment
    from gingerlib_tpu_torch.curves.points import affine_host
    te = TCI.edwards_bls12("cpu")
    comm = PedersenCommitment(te, PedersenWindow(4, 8)).setup(
        random.Random(5))
    data, rnd = b"abc", 424242
    cs = pedersen_commitment_circuit(comm, data, rnd,
                                     affine_host(te, comm.commit(data, rnd)))
    assert cs.which_is_unsatisfied() is None
    prove_on_the_cpu("bls12_377", cs)


@pytest.mark.slow
def test_schnorr_proof_on_the_cpu(signed):
    """The 19,292-constraint Schnorr circuit proven over MNT4-753 on the
    CPU (tens of minutes or more)."""
    _, pk, _, sig = signed
    prove_on_the_cpu("mnt4753",
                     schnorr_verification_circuit(pk, sig, MESSAGE))
