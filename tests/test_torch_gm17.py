"""Port vs JAX package: GM17 (gingerlib_tpu_torch.proofs.gm17 and its
python-int oracles in proofs.gm17_host) on ``device="cpu"``, against the
JAX package's ``proofs/gm17.py`` and ``proofs/gm17_host.py``, the port's
closed-form oracle ``expected_gm17_proof`` and the host prover.  Integer
arithmetic: tolerance 0.

Fast tier (~70 s in one process, cold XLA cache): the SAP instance map
(device, host, JAX) on a radix-2 size; the SAP witness map (device, host)
on a radix-2 size and, on a mixed-radix domain of 20 points, against the
host map with that domain's generator; the closed-form oracle against
the host prover over MNT4-753 and MNT6-753; the port's host GM17 against
the JAX package's; the device setup and prove over BLS12-377 against the
oracle; GM17 parameters carried across from the JAX package's host form
and from the port's array form.  ``slow``: the SAP witness map against
the JAX package's (~2 min of compiles), the SAP instance map at 2^14
constraints over MNT6-753 (the mixed domain of 40,960 points, ~50 s) and
setup, prove and verify over MNT4-753 on the CPU (minutes).
"""

from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gingerlib_tpu import params as JP
from gingerlib_tpu.proofs import gm17 as jgm17
from gingerlib_tpu.proofs import gm17_host as jgm17_host
from gingerlib_tpu.relations import r1cs as jr1cs
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.circuits import benchmark_circuit
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops import fft as tfft
from gingerlib_tpu_torch.proofs import gm17 as tgm17
from gingerlib_tpu_torch.proofs import gm17_host as GH
from gingerlib_tpu_torch.proofs import groth16 as tgroth16
from gingerlib_tpu_torch.relations import r1cs as tr1cs
from gingerlib_tpu_torch.utils.convert import (gm17_params_from_numpy,
                                               points_to_numpy)
from test_torch_cases import host_alpha_beta
from test_torch_groth16 import jax_copy

torch.set_num_threads(1)
TOXIC = dict(alpha=123, beta=456, t=13579)
# the JAX package's setup takes gamma; the port pins it to 1, as the
# reference's public API does (generator.rs:27)
JAX_TOXIC = dict(TOXIC, gamma=1)
RAND = dict(d1=11, d2=22, r=333)


def mul_circuit(fr, a_val=7, b_val=11):
    """a * b = c with the input c: the shape of the JAX package's GM17
    tests (``tests/test_gm17_device.py``)."""
    cs = tr1cs.ConstraintSystem(fr)
    c = cs.alloc_input("c", a_val * b_val % fr.modulus)
    a, b = cs.alloc("a", a_val), cs.alloc("b", b_val)
    cs.enforce(tr1cs.lc(a), tr1cs.lc(b), tr1cs.lc(c), "a*b=c")
    return cs


def ints(fr, t):
    return tfp.fp_to_ints(fr, t)


# ---------------------------------------------------------------------------
# the SAP maps
# ---------------------------------------------------------------------------

def test_sap_instance_map_matches_jax_and_host():
    """8 constraints, 3 inputs (SAP size 21, radix-2 domain of 32) over
    MNT4-753's Fr: every a_i(t), c_i(t), Z(t), the variable count and the
    domain, on the device path, in python ints and in the JAX package."""
    fr = TP.MNT4753_FR
    cs, _ = benchmark_circuit(fr, 2, 8)
    a, c, zt, dom = tgm17.sap_at_device(cs, TOXIC["t"], device="cpu")
    host = GH.sap_at(cs, TOXIC["t"])
    want = jgm17._sap_instance_map(jax_copy(cs, JP.MNT4753_FR),
                                   JP.MNT4753_FR, TOXIC["t"])
    assert tuple(host) == tuple(want)
    assert (ints(fr, a), ints(fr, c), zt, a.shape[0] - 1, dom.size,
            dom.gen) == tuple(host)
    assert isinstance(dom, tfft.Domain) and dom.size == 32


@pytest.mark.slow
def test_sap_instance_map_on_the_mixed_domain():
    """2^14 constraints over MNT6-753's Fr: SAP size 32,777 passes the
    two-adicity, so the map runs on the mixed domain of 40,960 points."""
    fr = TP.MNT6753_FR
    cs, _ = benchmark_circuit(fr, 4, 1 << 14)
    a, c, zt, dom = tgm17.sap_at_device(cs, TOXIC["t"], device="cpu")
    host = GH.sap_at(cs, TOXIC["t"])
    assert isinstance(dom, tfft.MixedRadixDomain) and dom.size == 40960
    assert (ints(fr, a), ints(fr, c), zt, a.shape[0] - 1, dom.size,
            dom.gen) == tuple(host)


def witness_case(fr, cs, domain=None):
    """The device witness map of ``cs`` (on ``domain`` where given) and the
    host map with the same domain's size and generator."""
    compiled = tgm17.compile_circuit(cs, device="cpu")
    dom = domain or tgm17.sap_domain(compiled)
    z = torch.from_numpy(tfp.fp_from_ints(fr, cs.assignment()))
    full, h = tgm17.sap_witness_map(compiled, z, RAND["d1"], RAND["d2"],
                                    dom)
    H = GH.HostGM17(None, None, None, fr)
    return (ints(fr, full), ints(fr, h)), H._witness(
        cs, dom.size, dom.gen, RAND["d1"], RAND["d2"]), compiled, z


def test_sap_witness_map_matches_host():
    """8 constraints, 3 inputs over MNT4-753's Fr (radix-2 domain of 32):
    the SAP witness and h against the host map's quadratic inverse DFT and
    schoolbook division."""
    fr = TP.MNT4753_FR
    cs, _ = benchmark_circuit(fr, 2, 8)
    got, host, _, _ = witness_case(fr, cs)
    assert got == host


@pytest.mark.slow
def test_sap_witness_map_matches_jax():
    """The same against the JAX package's ``sap_witness_map`` (eager: its
    transforms compile for ~2 min)."""
    fr = TP.MNT4753_FR
    cs, _ = benchmark_circuit(fr, 2, 8)
    got, _, _, z = witness_case(fr, cs)
    jcs = jax_copy(cs, JP.MNT4753_FR)
    jfull, jh = jgm17.sap_witness_map(
        jr1cs.compile_r1cs(jcs), jnp.asarray(z.numpy().astype(np.uint32)),
        RAND["d1"], RAND["d2"])
    assert got == (ints(fr, np.asarray(jfull).astype(np.int64)),
                   ints(fr, np.asarray(jh).astype(np.int64)))


def test_sap_witness_map_on_a_mixed_domain():
    """One input and 8 constraints over MNT6-753's Fr (SAP size 19) on the
    mixed domain of 20 = 2^2 * 5 points: ifft, coset_fft, the division by
    the vanishing polynomial and coset_ifft of ``MixedRadixDomain`` inside
    the witness map, against the host map over that domain's generator
    (h is exact only where A^2 - C vanishes on the domain)."""
    fr = TP.MNT6753_FR
    cs, _ = benchmark_circuit(fr, 1, 8)
    dom = tfft.MixedRadixDomain(fr, GH.sap_size(cs), device="cpu")
    assert (dom.size, sorted(set(dom.factors))) == (20, [2, 5])
    got, host, _, _ = witness_case(fr, cs, dom)
    assert got == host


# ---------------------------------------------------------------------------
# the python-int oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["mnt4753", "mnt6753"])
def test_closed_form_oracle_matches_host_prover(family):
    """``expected_gm17_proof`` (three scalar multiplications) against the
    host prover's MSMs, and the host verifier accepts it and refuses a
    wrong input."""
    fr = {"mnt4753": TP.MNT4753_FR, "mnt6753": TP.MNT6753_FR}[family]
    cs = mul_circuit(fr)
    H = getattr(GH, f"host_gm17_{family}")()
    params = H.setup(cs, **TOXIC)
    proof = H.prove(cs, params, **RAND)
    assert proof == GH.expected_gm17_proof(family, cs, **TOXIC, **RAND)
    assert H.verify(params, proof, [77])
    assert not H.verify(params, proof, [78])


@pytest.fixture(scope="module")
def host_pair():
    """The port's and the JAX package's host GM17 on the mul circuit over
    MNT4-753: parameters and proofs."""
    cs = mul_circuit(TP.MNT4753_FR)
    mine, theirs = GH.host_gm17_mnt4753(), jgm17_host.host_gm17_mnt4753()
    jcs = jax_copy(cs, JP.MNT4753_FR)
    jp = theirs.setup(jcs, **JAX_TOXIC)
    return dict(cs=cs, mp=mine.setup(cs, **TOXIC), jp=jp,
                jproof=theirs.prove(jcs, jp, **RAND),
                mine=mine)


def as_host(pt):
    """A JAX host point (tuple of ints or lists, or None) as the port's
    ([x comps], [y comps])."""
    if pt is None:
        return None
    return tuple(list(c) if isinstance(c, (list, tuple)) else [c]
                 for c in pt)


def test_host_gm17_matches_jax_host(host_pair):
    mp, jp, mine = host_pair["mp"], host_pair["jp"], host_pair["mine"]
    for name in ("a_query", "b_query", "c_query_1", "c_query_2",
                 "g_gamma2_z_t"):
        assert [as_host(q) for q in getattr(jp, name)] == \
            getattr(mp, name), name
    for name in ("g_gamma_z", "h_gamma_z", "g_ab_gamma_z", "g_gamma2_z2"):
        assert as_host(getattr(jp, name)) == getattr(mp, name), name
    for k, v in jp.vk.items():
        want = [as_host(q) for q in v] if k == "query" else as_host(v)
        assert want == mp.vk[k], k
    assert (mp.num_inputs, mp.domain_size) == (jp.num_inputs, jp.domain_size)
    proof = mine.prove(host_pair["cs"], mp, **RAND)
    assert {k: as_host(v) for k, v in host_pair["jproof"].items()} == proof


def test_params_carried_from_the_jax_host_form(host_pair):
    """The JAX package's ``HostGM17Params`` -> the port's tensors, point
    for point the port's host setup."""
    eng = TCI.mnt4753_engine("cpu")
    got = gm17_params_from_numpy(eng, host_pair["jp"], device="cpu")
    mp = host_pair["mp"]
    for name in ("a_query", "b_query", "c_query_1", "c_query_2",
                 "g_gamma2_z_t"):
        curve = eng.g2 if name == "b_query" else eng.g1
        xs, ys, inf = getattr(got, name)
        assert [None if i else tgroth16.affine_to_ints(curve, (x, y))
                for x, y, i in zip(xs, ys, inf)] == getattr(mp, name), name
    assert tgroth16.affine_to_ints(eng.g2, got.h_gamma_z) == mp.h_gamma_z
    assert tgroth16.affine_to_ints(eng.g2, got.vk.h_g2) == mp.vk["h_g2"]
    assert got.vk.g_alpha_h_beta is None     # the host setup has none
    assert (got.num_inputs, got.domain_size) == (1 + 1, 8)


# ---------------------------------------------------------------------------
# the device path on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bls_case():
    """Setup and prove over BLS12-377 on the 4-constraint benchmark
    circuit."""
    eng = TCI.bls12_377_engine("cpu")
    cs, _ = benchmark_circuit(TP.BLS12_377_FR, 2, 4)
    compiled = tgm17.compile_circuit(cs, device="cpu")
    params = tgm17.generate_parameters(eng, cs, **TOXIC, device="cpu")
    proof = tgm17.create_proof(eng, params, compiled, cs.assignment(),
                               **RAND, device="cpu")
    return dict(eng=eng, cs=cs, params=params, proof=proof)


def test_device_gm17_over_bls12_377_matches_oracle(bls_case):
    eng, params = bls_case["eng"], bls_case["params"]
    assert tgroth16.proof_to_ints(eng, bls_case["proof"]) == \
        GH.expected_gm17_proof("bls12_377", bls_case["cs"], **TOXIC, **RAND)
    # the vk's GT element: e(alpha G1, beta G2) by the host oracle
    assert tfp.fp_to_ints(eng.fp, params.vk.g_alpha_h_beta) == \
        host_alpha_beta(TOXIC["alpha"], TOXIC["beta"], "bls12_377")
    assert params.domain_size == 16
    inputs = bls_case["cs"].input_values[1:]
    assert tgm17.verify_proof(eng, params.vk, bls_case["proof"], inputs)


def test_params_carried_from_the_array_form(bls_case):
    """The port's parameters as numpy arrays (the JAX package's array
    form: digits uint32, flags bool) come back as the same tensors."""
    p = bls_case["params"]
    fields = ("a_query", "b_query", "c_query_1", "c_query_2",
              "g_gamma2_z_t", "g_gamma_z", "h_gamma_z", "g_ab_gamma_z",
              "g_gamma2_z2")
    vk = p.vk
    src = NS(vk=NS(**{k: points_to_numpy(getattr(vk, k)) for k in (
        "h_g2", "g_alpha_g1", "h_beta_g2", "g_gamma_g1", "h_gamma_g2",
        "query")}, g_alpha_h_beta=None),
        num_inputs=p.num_inputs, domain_size=p.domain_size,
        **{f: points_to_numpy(getattr(p, f)) for f in fields})
    got = gm17_params_from_numpy(bls_case["eng"], src, device="cpu")
    for f in fields:
        for g, w in zip(getattr(got, f), getattr(p, f)):
            assert torch.equal(g, w), f
    for k in ("h_g2", "g_alpha_g1", "query"):
        for g, w in zip(getattr(got.vk, k), getattr(vk, k)):
            assert torch.equal(g, w), k


@pytest.mark.slow
def test_mnt4753_mul_circuit_setup_prove_verify():
    """The JAX package's GM17 device test's shape over MNT4-753 (its
    pairing in setup's GT and in verify): the proof equals the oracle,
    verify accepts it and refuses a wrong input."""
    eng = TCI.mnt4753_engine("cpu")
    cs = mul_circuit(TP.MNT4753_FR)
    compiled = tgm17.compile_circuit(cs, device="cpu")
    params = tgm17.generate_parameters(eng, cs, **TOXIC, device="cpu")
    proof = tgm17.create_proof(eng, params, compiled, cs.assignment(),
                               **RAND, device="cpu")
    assert tgroth16.proof_to_ints(eng, proof) == GH.expected_gm17_proof(
        "mnt4753", cs, **TOXIC, **RAND)
    assert tgm17.verify_proof(eng, params.vk, proof, [77])
    assert not tgm17.verify_proof(eng, params.vk, proof, [78])
