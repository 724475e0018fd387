"""Port vs JAX package: Lagrange and vanishing evaluation of the port's
``Domain``, its table of powers built on the device, and setup's QAP at the
toxic point on the device (``proofs.groth16.qap_at_device`` over
``relations.r1cs.eval_matrix_transposed``), held against the JAX package
and the python-int oracle ``groth16_host.qap_at``, on ``device="cpu"``.
Integer arithmetic: tolerance 0.
"""

import random

import numpy as np
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.ops.fft import Domain as JDomain
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.circuits import benchmark_circuit
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops import fft as tfft
from gingerlib_tpu_torch.proofs import groth16 as tgroth16
from gingerlib_tpu_torch.proofs import groth16_host as thost
from gingerlib_tpu_torch.relations import r1cs as tr1cs
from test_torch_cases import dense_row_circuit

torch.set_num_threads(1)
JF, TF = JP.BLS12_377_FR, TP.BLS12_377_FR


def test_lagrange_coefficients_match_jax():
    """m = 16 at a seeded tau: the port's coefficients (one shared
    inversion) equal the JAX package's (element-wise inverses), digit for
    digit, and the vanishing values agree."""
    tau = random.Random(14).randrange(TF.modulus)
    jdom, tdom = JDomain(JF, 16), tfft.Domain(TF, 16, device="cpu")
    want = np.asarray(jdom.evaluate_all_lagrange_coefficients(tau))
    got = tdom.evaluate_all_lagrange_coefficients(tau)
    assert np.array_equal(want.astype(np.int64), got.numpy())
    assert tdom.evaluate_vanishing_polynomial(tau) \
        == jdom.evaluate_vanishing_polynomial(tau) != 0


@pytest.mark.parametrize("index", [0, 3, 15])
def test_lagrange_at_a_domain_point(index):
    """tau = w^index: l is 1 at index and 0 elsewhere, as in the JAX
    package."""
    jdom, tdom = JDomain(JF, 16), tfft.Domain(TF, 16, device="cpu")
    tau = pow(tdom.gen, index, TF.modulus)
    got = tdom.evaluate_all_lagrange_coefficients(tau)
    assert tfp.fp_to_ints(TF, got) == [int(i == index) for i in range(16)]
    assert np.array_equal(np.asarray(
        jdom.evaluate_all_lagrange_coefficients(tau)).astype(np.int64),
        got.numpy())
    assert tdom.evaluate_vanishing_polynomial(tau) == 0


def test_lagrange_coefficients_match_python_ints_at_753_bits():
    """MNT4-753 Fr at m = 64 against ``groth16_host.lagrange_at``."""
    fr = TP.MNT4753_FR
    tau = random.Random(15).randrange(fr.modulus)
    dom = tfft.Domain(fr, 64, device="cpu")
    want, zt = thost.lagrange_at(fr, 64, dom.gen, tau)
    assert tfp.fp_to_ints(fr, dom.evaluate_all_lagrange_coefficients(tau)) \
        == want
    assert dom.evaluate_vanishing_polynomial(tau) == zt


@pytest.mark.parametrize("n", [0, 1, 2, 5, 64, 100])
def test_power_table_built_on_the_device(n):
    """The doubling build gives 1, b, ..., b^(n-1) digit for digit."""
    p = TF.modulus
    base = random.Random(n).randrange(p)
    got = tfft._build_powers_device(TF, base, n, "cpu")
    assert got.shape == (n, TF.n_digits) and got.dtype == torch.int64
    assert tfp.fp_to_ints(TF, got) == [pow(base, i, p) for i in range(n)]


@pytest.mark.parametrize("family", ["bls12_377", "mnt4753"])
def test_qap_on_the_device_matches_host_oracle(family):
    """The benchmark circuit at 2^6 constraints: a, b, c, Z(t) and m
    equal ``qap_at``'s exactly."""
    fr = TP.BLS12_377_FR if family == "bls12_377" else TP.MNT4753_FR
    cs, _ = benchmark_circuit(fr, 4, 1 << 6)
    a, b, c, zt, dom = tgroth16.qap_at_device(cs, 314159, device="cpu")
    wa, wb, wc, wzt, wm = thost.qap_at(cs, 314159)
    assert (zt, dom.size) == (wzt, wm)
    for got, want in ((a, wa), (b, wb), (c, wc)):
        assert got.shape == (cs.num_variables, fr.n_digits)
        assert tfp.fp_to_ints(fr, got) == want


def test_qap_refuses_t_in_the_domain():
    fr = TP.BLS12_377_FR
    cs, _ = benchmark_circuit(fr, 2, 4)
    m = tr1cs.domain_size_for(cs)
    with pytest.raises(ValueError, match="evaluation domain"):
        tgroth16.qap_at_device(cs, thost.domain_generator(fr, m),
                               device="cpu")


@pytest.mark.parametrize("family", ["bls12_377", "mnt4753"])
def test_column_sums_split_dense_columns(family):
    """A column of more terms than one ``lazy_reduce`` takes (the ONE
    variable in every constraint) is cut into groups: column 0 holds
    2^15 + 7 terms, column 1 exactly LAZY_TERMS - 1, column 2 one, the
    rest none; every sum equals python ints.  MNT4-753's Fr takes 2^15 - 1
    terms a group, BLS12-377's 13 (several rounds of groups)."""
    fr = TF if family == "bls12_377" else TP.MNT4753_FR
    assert tr1cs.lazy_terms(fr) == (13 if family == "bls12_377"
                                    else tr1cs.LAZY_TERMS - 1)
    p = fr.modulus
    rng = random.Random(7)
    pool = [p - 1 - i for i in range(8)] + [rng.randrange(p)
                                            for _ in range(56)]
    cols = [0] * ((1 << 15) + 7) + [1] * (tr1cs.LAZY_TERMS - 1) + [2]
    rng.shuffle(cols)
    pick = np.random.default_rng(7).integers(0, len(pool), len(cols))
    vals = torch.from_numpy(tfp.fp_from_ints(fr, pool))[torch.from_numpy(
        pick)]
    got = tr1cs.column_sums(fr, vals, torch.tensor(cols), 4)
    want = [0] * 4
    for col, k in zip(cols, pick.tolist()):
        want[col] += pool[k]
    assert tfp.fp_to_ints(fr, got) == [w % p for w in want]


@pytest.mark.parametrize("terms", [13, 14, 40])
def test_dense_rows_sum_past_the_lazy_bound(terms):
    """A row of more terms than one lazy reduction takes (13 over
    BLS12-377's Fr), each term the largest residue: ``eval_matrix`` sums it
    exactly, setup's QAP equals ``qap_at``, and the prover's witness map
    gives the h with A(x) B(x) - C(x) = h(x) Z(x) at a seeded point."""
    assert tr1cs.lazy_terms(TF) == 13
    p = TF.modulus
    cs = dense_row_circuit(TF, terms)
    assert cs.is_satisfied()
    values = cs.assignment()
    z = torch.from_numpy(tfp.fp_from_ints(TF, values))
    compiled = tr1cs.compile_r1cs(cs, device="cpu")
    assert tfp.fp_to_ints(TF, tr1cs.eval_matrix(TF, compiled.a, z))[0] \
        == sum(values[1:terms + 1]) % p
    a, b, c, zt, dom = tgroth16.qap_at_device(cs, 314159, device="cpu")
    wa, wb, wc, wzt, wm = thost.qap_at(cs, 314159)
    assert (zt, dom.size) == (wzt, wm)
    assert [tfp.fp_to_ints(TF, v) for v in (a, b, c)] == [wa, wb, wc]
    h = tfp.fp_to_ints(TF, tgroth16.witness_map(compiled, z))
    x = random.Random(terms).randrange(p)
    qa, qb, qc, zx, _ = thost.qap_at(cs, x)
    ax, bx, cx = (sum(v * q for v, q in zip(values, col)) % p
                  for col in (qa, qb, qc))
    hx = sum(hj * pow(x, j, p) for j, hj in enumerate(h)) % p
    assert (ax * bx - cx) % p == hx * zx % p
