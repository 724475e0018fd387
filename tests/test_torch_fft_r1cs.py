"""Port vs JAX package: evaluation domains, R1CS evaluation and the QAP
witness map (gingerlib_tpu_torch.ops.fft, .relations.r1cs,
.proofs.groth16.witness_map), on ``device="cpu"`` over BLS12-377 Fr.

Inputs come from a seeded numpy generator and go to both sides; the compiled
circuit of the JAX package is carried over with ``compiled_from_numpy``, so
that function is covered too.  Integer arithmetic: tolerance 0.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.ops.fft import Domain as JDomain
from gingerlib_tpu.proofs import groth16 as jgroth16
from gingerlib_tpu.relations import r1cs as jr1cs
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops.fft import Domain as TDomain
from gingerlib_tpu_torch.proofs import groth16 as tgroth16
from gingerlib_tpu_torch.relations import r1cs as tr1cs
from gingerlib_tpu_torch.utils.convert import compiled_from_numpy

torch.set_num_threads(1)
JF, TF = JP.BLS12_377_FR, TP.BLS12_377_FR
TRANSFORMS = ["fft", "ifft", "coset_fft", "coset_ifft"]


def rand_field(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % TF.modulus
            for _ in range(n)]
    return tfp.fp_from_ints(TF, vals)


def same(jax_out, torch_out):
    return np.array_equal(np.asarray(jax_out).astype(np.int64),
                          torch_out.numpy())


_jax_transforms = {}


def jax_transforms(m):
    """All four JAX transforms of one input, one compiled graph per m."""
    if m not in _jax_transforms:
        dom = JDomain(JF, m)
        x = rand_field(m, seed=100 + m)
        out = jax.jit(lambda v: tuple(getattr(dom, t)(v)
                                      for t in TRANSFORMS))(
            jnp.asarray(x.astype(np.uint32)))
        _jax_transforms[m] = (x, dict(zip(TRANSFORMS, out)))
    return _jax_transforms[m]


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("m", [1, 2, 8, 32])
def test_domain_transform_matches_jax(m, transform):
    x, want = jax_transforms(m)
    dom = TDomain(TF, m, device="cpu")
    assert same(want[transform], getattr(dom, transform)(torch.from_numpy(x)))


def test_domain_constants_match_jax():
    for m in (1, 2, 8, 32, 1000):
        jd, td = JDomain(JF, m), TDomain(TF, m, device="cpu")
        for attr in ("size", "lg", "gen", "gen_inv", "size_inv",
                     "coset_shift", "coset_shift_inv", "z_coset",
                     "z_coset_inv"):
            assert getattr(jd, attr) == getattr(td, attr), (m, attr)


def test_fft_against_naive_dft_and_batch_axis():
    """Independent of JAX, and with a leading batch axis."""
    m, p = 8, TF.modulus
    dom = TDomain(TF, m, device="cpu")
    x = rand_field(2 * m, seed=7).reshape(2, m, TF.n_digits)
    got = dom.fft(torch.from_numpy(x))
    for row in range(2):
        xs = tfp.fp_to_ints(TF, x[row])
        want = [sum(xs[j] * pow(dom.gen, i * j, p) for j in range(m)) % p
                for i in range(m)]
        assert tfp.fp_to_ints(TF, got[row]) == want
    back = dom.ifft(got)
    assert np.array_equal(back.numpy(), x)


def test_vanishing_division_and_pointwise_product():
    m, p = 8, TF.modulus
    dom = TDomain(TF, m, device="cpu")
    x = rand_field(m, seed=8)
    xs = tfp.fp_to_ints(TF, x)
    t = torch.from_numpy(x)
    assert tfp.fp_to_ints(TF, dom.divide_by_vanishing_poly_on_coset(t)) == [
        v * dom.z_coset_inv % p for v in xs]
    assert tfp.fp_to_ints(TF, dom.mul_in_evaluation_domain(t, t)) == [
        v * v % p for v in xs]


def build(r1cs_mod, field):
    """x * y = z; (x + 2y) * (z - 1) = w; w * w = v; (v + x) * 1 = out, with
    one public input: 4 constraints, domain 8."""
    cs = r1cs_mod.ConstraintSystem(field)
    p = field.modulus
    xv, yv = 1234567, p - 3
    zv = xv * yv % p
    wv = (xv + 2 * yv) * (zv - 1) % p
    vv = wv * wv % p
    out = cs.alloc_input("out", (vv + xv) % p)
    x, y = cs.alloc("x", xv), cs.alloc("y", yv)
    z, w, v = cs.alloc("z", zv), cs.alloc("w", wv), cs.alloc("v", vv)
    lc = r1cs_mod.lc
    cs.enforce(lc(x), lc(y), lc(z), "xy")
    cs.enforce(lc(x, (y, 2)), lc(z, (r1cs_mod.ONE, -1)), lc(w), "w")
    cs.enforce(lc(w), lc(w), lc(v), "ww")
    cs.enforce(lc(v, x), lc(r1cs_mod.ONE), lc(out), "out")
    assert cs.is_satisfied()
    return cs


@pytest.fixture(scope="module")
def circuits():
    jcs, tcs = build(jr1cs, JF), build(tr1cs, TF)
    jcomp = jr1cs.compile_r1cs(jcs)
    tcomp = tr1cs.compile_r1cs(tcs, device="cpu")
    z = tfp.fp_from_ints(TF, tcs.assignment())
    return jcs, tcs, jcomp, tcomp, z


def test_constraint_system_and_compiler_match_jax(circuits):
    jcs, tcs, jcomp, tcomp, _ = circuits
    assert (jcs.at, jcs.bt, jcs.ct) == (tcs.at, tcs.bt, tcs.ct)
    assert jcs.assignment() == tcs.assignment()
    assert tcomp.domain_size == jcomp.domain_size == 8
    carried = compiled_from_numpy(TF, jcomp, device="cpu")
    for name in "abc":
        jm, tm, cm = (getattr(c, name) for c in (jcomp, tcomp, carried))
        for attr in ("rows", "cols", "coeffs"):
            want = np.asarray(getattr(jm, attr)).astype(np.int64)
            assert np.array_equal(want, getattr(tm, attr).numpy())
            assert np.array_equal(want, getattr(cm, attr).numpy())
        assert (jm.num_rows, jm.max_row_nnz) == (tm.num_rows, tm.max_row_nnz)


@pytest.mark.parametrize("matrix", ["a", "b", "c"])
def test_eval_matrix_matches_jax(circuits, matrix):
    _, tcs, jcomp, tcomp, z = circuits
    want = jax.jit(lambda v: jr1cs.eval_matrix(
        JF, getattr(jcomp, matrix), v))(jnp.asarray(z.astype(np.uint32)))
    got = tr1cs.eval_matrix(TF, getattr(tcomp, matrix), torch.from_numpy(z))
    assert same(want, got)
    vals = tcs.assignment()
    rows = getattr(tcs, matrix + "t")
    assert tfp.fp_to_ints(TF, got)[:4] == [tcs.eval_lc(r, vals)
                                           for r in rows]


@pytest.mark.parametrize("blind", [
    (0, 0, 0),
    pytest.param((5, 7, 11), marks=pytest.mark.slow),   # a second XLA graph
])
def test_witness_map_matches_jax(circuits, blind):
    _, _, jcomp, tcomp, z = circuits
    want = jax.jit(lambda v: jgroth16.witness_map(jcomp, v, *blind))(
        jnp.asarray(z.astype(np.uint32)))
    got = tgroth16.witness_map(tcomp, torch.from_numpy(z), *blind)
    assert got.shape == (7, TF.n_digits)
    assert same(want, got)


def test_unsatisfied_circuit_is_named():
    cs = build(tr1cs, TF)
    cs.aux_values[0] += 1
    assert cs.which_is_unsatisfied() == "xy"
