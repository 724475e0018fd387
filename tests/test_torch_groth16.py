"""Port vs JAX package: the slice as a whole -- Groth16 setup and prove
(gingerlib_tpu_torch.proofs.groth16) on ``device="cpu"`` against the JAX
package's python-int oracle (gingerlib_tpu.proofs.groth16_host), with the
same toxic waste and blinding on both sides.

Fast tier: BLS12-377 (24-digit base field, 256-step scalar loops) on the
4-constraint benchmark circuit, verified through the BLS12 pairing.  ``slow``: MNT4-753 on a 1-constraint
circuit.  Integer arithmetic: tolerance 0, every coordinate must agree.
"""

import numpy as np
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.proofs import groth16_host as jhost
from gingerlib_tpu.relations import r1cs as jr1cs
from gingerlib_tpu_torch.circuits import benchmark_circuit
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.proofs import groth16 as tgroth16
from gingerlib_tpu_torch.proofs import groth16_host as thost
from gingerlib_tpu_torch.relations import r1cs as tr1cs
from gingerlib_tpu_torch.utils.convert import params_from_numpy
from test_torch_cases import host_alpha_beta, one_constraint_circuit

torch.set_num_threads(1)
TOXIC = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)
RAND = dict(r=31337, s=71717)


def jax_copy(tcs, jfield):
    """The same constraint system as the JAX package's ConstraintSystem."""
    jcs = jr1cs.ConstraintSystem(jfield)
    for v in tcs.input_values[1:]:
        jcs.alloc_input("", v)
    for v in tcs.aux_values:
        jcs.alloc("", v)
    jcs.at, jcs.bt, jcs.ct = tcs.at, tcs.bt, tcs.ct
    jcs.names = list(tcs.names)
    return jcs


def host_points(curve, query):
    """Port query (xs, ys, inf) -> list of host points, None for infinity."""
    xs, ys, inf = query
    return [None if bool(i) else tgroth16.affine_to_ints(curve, (x, y))
            for x, y, i in zip(xs, ys, inf)]


def make_case(family, jfield, host_factory, cs):
    eng = getattr(TCI, family + "_engine")("cpu")
    compiled = tr1cs.compile_r1cs(cs, device="cpu")
    params = tgroth16.generate_parameters(eng, cs, **TOXIC, device="cpu")
    proof = tgroth16.create_proof(eng, params, compiled, cs.assignment(),
                                  **RAND, device="cpu")
    H = host_factory()
    jcs = jax_copy(cs, jfield)
    hparams = H.setup(jcs, **TOXIC)
    hproof = H.prove(jcs, hparams, RAND["r"], RAND["s"])
    return dict(family=family, eng=eng, cs=cs, compiled=compiled,
                params=params, proof=proof, hparams=hparams, hproof=hproof)


@pytest.fixture(scope="module")
def bls():
    from gingerlib_tpu_torch import params as TP
    cs, _ = benchmark_circuit(TP.BLS12_377_FR, 2, 4)
    return make_case("bls12_377", JP.BLS12_377_FR,
                     jhost.host_groth16_bls12_377, cs)


def check_setup(case):
    eng, params, hp = case["eng"], case["params"], case["hparams"]
    for name in ("a_query", "b_g1_query", "h_query", "l_query"):
        assert host_points(eng.g1, getattr(params, name)) \
            == getattr(hp, name), name
    assert host_points(eng.g2, params.b_g2_query) == hp.b_g2_query
    for name in ("alpha_g1", "beta_g1", "delta_g1"):
        assert tgroth16.affine_to_ints(eng.g1, getattr(params, name)) \
            == getattr(hp, name), name
    for name in ("beta_g2", "delta_g2"):
        assert tgroth16.affine_to_ints(eng.g2, getattr(params, name)) \
            == getattr(hp, name), name
    assert tgroth16.affine_to_ints(eng.g2, params.vk.gamma_g2) \
        == hp.vk["gamma_g2"]
    abc = params.vk.gamma_abc_g1
    assert [tgroth16.affine_to_ints(eng.g1, (x, y)) for x, y in zip(*abc)] \
        == hp.vk["gamma_abc"]
    assert (params.num_inputs, params.domain_size) \
        == (hp.num_inputs, hp.domain_size)
    # every engine is a pairing: the GT element is the host oracle's
    assert tfp.fp_to_ints(eng.fp, params.vk.alpha_g1_beta_g2) == \
        hp.vk["alpha_g1_beta_g2"]


def check_carried_params(case):
    """HostParams carried over by params_from_numpy equal the port's own
    setup tensor for tensor, so a proof made from them is the same proof."""
    eng, params = case["eng"], case["params"]
    carried = params_from_numpy(eng, case["hparams"], device="cpu")
    for name in ("a_query", "b_g1_query", "b_g2_query", "h_query",
                 "l_query", "alpha_g1", "beta_g1", "beta_g2", "delta_g1",
                 "delta_g2"):
        for got, want in zip(getattr(carried, name), getattr(params, name)):
            assert got.dtype == want.dtype and torch.equal(got, want), name
    for got, want in zip(carried.vk.gamma_abc_g1, params.vk.gamma_abc_g1):
        assert torch.equal(got, want)
    if params.vk.alpha_g1_beta_g2 is not None:
        assert torch.equal(carried.vk.alpha_g1_beta_g2,
                           params.vk.alpha_g1_beta_g2)
    assert (carried.num_inputs, carried.domain_size) \
        == (params.num_inputs, params.domain_size)


def test_setup_matches_host_oracle(bls):
    check_setup(bls)


@pytest.mark.parametrize("element", ["a", "b", "c"])
def test_proof_matches_host_oracle(bls, element):
    got = tgroth16.proof_to_ints(bls["eng"], bls["proof"])
    assert got[element] == bls["hproof"][element]


def test_closed_form_oracle_matches_host_prover(bls):
    want = thost.expected_proof(bls["family"], bls["cs"], **TOXIC, **RAND)
    assert want == bls["hproof"]
    other = thost.expected_proof(bls["family"], bls["cs"], **TOXIC,
                                 r=RAND["r"], s=RAND["s"] + 1)
    assert other["a"] == want["a"] and other["b"] != want["b"] \
        and other["c"] != want["c"]


def test_params_carried_from_host_form(bls):
    check_carried_params(bls)


def test_params_carried_from_array_form(bls):
    """Array form: the same attributes holding numpy arrays of another
    integer dtype, as np.asarray of the JAX package's Parameters gives."""
    from types import SimpleNamespace as NS
    params = bls["params"]

    def arr(t):
        a = t.numpy()
        return a if a.dtype == np.bool_ else a.astype(np.uint32)

    fields = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
              "a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")
    src = NS(vk=NS(gamma_g2=tuple(map(arr, params.vk.gamma_g2)),
                   delta_g2=tuple(map(arr, params.vk.delta_g2)),
                   gamma_abc_g1=tuple(map(arr, params.vk.gamma_abc_g1))),
             num_inputs=params.num_inputs, domain_size=params.domain_size,
             **{f: tuple(map(arr, getattr(params, f))) for f in fields})
    carried = params_from_numpy(bls["eng"], src, device="cpu")
    for f in fields:
        for got, want in zip(getattr(carried, f), getattr(params, f)):
            assert got.dtype == want.dtype and torch.equal(got, want), f


def test_assignment_tensor_and_blinding(bls):
    """create_proof takes the assignment as a device tensor as well; with
    d1, d2, d3 the proof changes in C only (h absorbs the blinding)."""
    eng, cs = bls["eng"], bls["cs"]
    fr = eng.g1.scalar_field
    z = torch.from_numpy(tfp.fp_from_ints(fr, cs.assignment()))
    h0 = tgroth16.witness_map(bls["compiled"], z)
    h1 = tgroth16.witness_map(bls["compiled"], z, 3, 5, 7)
    assert h0.shape == h1.shape and not torch.equal(h0, h1)
    # h(x) of the plain map evaluates to (a(t) b(t) - c(t)) / Z(t)
    a, b, c, zt, m = thost.qap_at(cs, TOXIC["t"])
    p, vals = fr.modulus, cs.assignment()
    dot = lambda q: sum(x * y for x, y in zip(vals, q)) % p
    h_t = sum(hv * pow(TOXIC["t"], i, p)
              for i, hv in enumerate(tfp.fp_to_ints(fr, h0))) % p
    assert h_t == (dot(a) * dot(b) - dot(c)) * pow(zt, -1, p) % p


def test_verify_is_not_ported_yet(bls):
    """(Named when BLS12-377 had no pairing; it has one now.)  Over
    BLS12-377 the verifying key's GT element is e(alpha G1, beta G2) by the
    host oracle, verify_proof accepts the proof and refuses the statement
    with its first input 78."""
    eng, params, proof = bls["eng"], bls["params"], bls["proof"]
    assert tfp.fp_to_ints(eng.fp, params.vk.alpha_g1_beta_g2) == \
        host_alpha_beta(TOXIC["alpha"], TOXIC["beta"], "bls12_377")
    inputs = bls["cs"].input_values[1:]
    assert tgroth16.verify_proof(eng, params.vk, proof, inputs)
    assert not tgroth16.verify_proof(eng, params.vk, proof,
                                     [78] + inputs[1:])


@pytest.fixture(scope="module")
def mnt4():
    """The 1-constraint circuit of tests/test_groth16_753_device.py."""
    from gingerlib_tpu_torch import params as TP
    return make_case("mnt4753", JP.MNT4753_FR, jhost.host_groth16_mnt4753,
                     one_constraint_circuit(TP.MNT4753_FR))


@pytest.mark.slow
def test_mnt4753_slice_matches_host_oracle(mnt4):
    """Setup (alpha_g1_beta_g2 included), prove and verify over MNT4-753,
    all on the port."""
    check_setup(mnt4)
    assert tgroth16.proof_to_ints(mnt4["eng"], mnt4["proof"]) \
        == mnt4["hproof"]
    assert thost.expected_proof("mnt4753", mnt4["cs"], **TOXIC, **RAND) \
        == mnt4["hproof"]
    check_carried_params(mnt4)
    assert tgroth16.verify_proof(mnt4["eng"], mnt4["params"].vk,
                                 mnt4["proof"], [77])
