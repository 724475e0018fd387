"""The windowed fixed-base path of setup (gingerlib_tpu_torch.ops.msm
``fixed_base_table`` and ``fixed_base_msm_windowed``, ``proofs.groth16``'s
table a curve) on ``device="cpu"``: the table against python-int multiples
(and, ``slow``, against the JAX package's table), the windowed query
against the double-and-add oracle ``fixed_base_msm`` + ``to_affine``, and
setup at 2^6 constraints against the python-int oracle.

Full-width scalars (768-step oracle loops, r - 1 among them) are checked on
the card: the ``gpu`` cases of ``tests/test_torch_gpu_kernels.py`` and
``chip_smoke.py``.  Integer arithmetic: tolerance 0.
"""

import random

import numpy as np
import pytest
import torch

from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.circuits import benchmark_circuit
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.ops import msm as tmsm
from gingerlib_tpu_torch.proofs import groth16 as tgroth16
from gingerlib_tpu_torch.proofs import groth16_host as thost

torch.set_num_threads(1)
TOXIC = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)
CURVES = {"bls12_377_g1": ("bls12_377", 0), "bls12_377_g2": ("bls12_377", 1),
          "mnt4753_g1": ("mnt4753", 0), "mnt4753_g2": ("mnt4753", 1)}


def host_curve(name):
    family, group = CURVES[name]
    return thost.host_curves(family)[group]


def host_view(curve, x, y, inf):
    """Device affine points -> host points (None at infinity)."""
    return [None if bool(i) else tgroth16.affine_to_ints(curve, (a, b))
            for a, b, i in zip(x, y, inf)]


@pytest.mark.parametrize("name", ["bls12_377_g1", "mnt4753_g1",
                                  "bls12_377_g2"])
def test_table_matches_python_ints(name):
    """w = 3, nbits = 8: T[i][j] = j 2^(3 i) G for 3 windows of 8."""
    curve = getattr(TCI, name)("cpu")
    H = host_curve(name)
    (tx, ty), tinf = tmsm.fixed_base_table(curve, curve.generator_affine,
                                           3, 8)
    assert tx.shape == (3, 8, curve.F.K, curve.fp.n_digits)
    got = host_view(curve, tx.reshape((24,) + tx.shape[2:]),
                    ty.reshape((24,) + ty.shape[2:]), tinf.reshape(24))
    assert got == [H.mul(H.gen, j << (3 * i)) for i in range(3)
                   for j in range(8)]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["bls12_377_g1", "mnt4753_g1"])
def test_table_matches_jax(name):
    """The JAX package's ``fixed_base_table`` at w = 3, nbits = 8 (its
    eager batched additions take minutes on XLA:CPU, hence slow)."""
    from gingerlib_tpu.curves import instances as JCI
    from gingerlib_tpu.ops import msm as jmsm
    jc, tc = getattr(JCI, name)(), getattr(TCI, name)("cpu")
    (jx, jy), jinf = jmsm.fixed_base_table(jc, jc.generator_affine, 3, 8)
    (tx, ty), tinf = tmsm.fixed_base_table(tc, tc.generator_affine, 3, 8)
    for j, t in ((jx, tx), (jy, ty)):
        assert np.array_equal(np.asarray(j).astype(np.int64), t.numpy())
    assert np.array_equal(np.asarray(jinf), tinf.numpy())


_tables = {}


def small_table(name):
    """A w = 4, nbits = 16 table of the curve's generator (4 windows of
    16), built once a module."""
    if name not in _tables:
        curve = getattr(TCI, name)("cpu")
        _tables[name] = tmsm.fixed_base_table(curve, curve.generator_affine,
                                              4, 16)
    return _tables[name]


@pytest.mark.parametrize("name", ["bls12_377_g1", "bls12_377_g2",
                                  "mnt4753_g1"])
def test_windowed_query_matches_double_and_add(name):
    """w = 4, nbits = 16 (a tree of two levels): scalars 0, 1, 2^16 - 1, a
    power of two, and seeded ones, against ``fixed_base_msm`` (16 steps)
    and ``to_affine``; infinity is (0, 0) and flagged.  MNT4-753's G2 is
    the ``gpu`` case's."""
    curve = getattr(TCI, name)("cpu")
    rng = random.Random(len(name))
    ks = [0, 1, (1 << 16) - 1, 1 << 15] + [rng.randrange(1 << 16)
                                          for _ in range(4)]
    sd = torch.tensor([[k] for k in ks], dtype=torch.int64)
    (x, y), inf = tmsm.fixed_base_msm_windowed(curve, small_table(name), sd,
                                               4, 16)
    wx, wy = curve.to_affine(tmsm.fixed_base_msm(
        curve, curve.generator_affine, sd))
    assert torch.equal(x, wx) and torch.equal(y, wy)
    assert inf.tolist() == [k == 0 for k in ks]


def test_windowed_query_in_chunks(monkeypatch):
    """Scalars past one chunk go in several; the result is the same as in
    one."""
    curve = TCI.bls12_377_g1("cpu")
    sd = torch.tensor([[k] for k in (5, 0, 7, 65535, 3)], dtype=torch.int64)
    table = small_table("bls12_377_g1")
    whole = tmsm.fixed_base_msm_windowed(curve, table, sd, 4, 16)
    monkeypatch.setattr(tmsm, "windowed_chunk", lambda *a: 2)
    parts = tmsm.fixed_base_msm_windowed(curve, table, sd, 4, 16)
    assert all(torch.equal(a, b) for a, b in zip(
        (*whole[0], whole[1]), (*parts[0], parts[1])))


def test_chunk_sizes():
    """The chunk follows the field's width and the window count: 2^19
    first-level lanes for MNT4-753 G1 at 95 windows, half for G2."""
    assert tmsm.windowed_chunk(128, 1, 48) == 8192
    assert tmsm.windowed_chunk(128, 2, 48) == 4096
    assert tmsm.windowed_chunk(32, 1, 24) == 1 << 16


@pytest.mark.parametrize("query", ["a_query", "b_g1_query", "h_query",
                                   "l_query", "b_g2_query"])
def test_setup_at_2p6_matches_python_ints(setup_2p6, query):
    """BLS12-377, the benchmark circuit at 2^6 constraints: a seeded sample
    of each query's points equals [s]G for its scalar s in python ints."""
    params, cs = setup_2p6
    a, b, c, zt, m = thost.qap_at(cs, TOXIC["t"])
    p = TP.BLS12_377_FR.modulus
    ni = cs.num_inputs
    d_inv = pow(TOXIC["delta"], -1, p)
    scalars = {
        "a_query": a, "b_g1_query": b, "b_g2_query": b,
        "h_query": [zt * d_inv * pow(TOXIC["t"], i, p) % p
                    for i in range(m - 1)],
        "l_query": [(TOXIC["beta"] * a[i] + TOXIC["alpha"] * b[i] + c[i])
                    * d_inv % p for i in range(ni, cs.num_variables)]}[query]
    name = "bls12_377_g2" if query == "b_g2_query" else "bls12_377_g1"
    curve, H = getattr(TCI, name)("cpu"), host_curve(name)
    xs, ys, inf = getattr(params, query)
    assert xs.shape[0] == len(scalars)
    pick = sorted(random.Random(query).sample(range(len(scalars)), 6))
    got = host_view(curve, xs[pick], ys[pick], inf[pick])
    assert got == [H.mul(H.gen, scalars[i]) for i in pick]


@pytest.fixture(scope="module")
def setup_2p6():
    cs, _ = benchmark_circuit(TP.BLS12_377_FR, 4, 1 << 6)
    eng = TCI.bls12_377_engine("cpu")
    return tgroth16.generate_parameters(eng, cs, **TOXIC, device="cpu"), cs


def test_setup_at_2p6_single_elements(setup_2p6):
    params, _ = setup_2p6
    g1, g2 = (host_curve(n) for n in ("bls12_377_g1", "bls12_377_g2"))
    e1, e2 = TCI.bls12_377_g1("cpu"), TCI.bls12_377_g2("cpu")
    for name, curve, H, k in (
            ("alpha_g1", e1, g1, "alpha"), ("beta_g1", e1, g1, "beta"),
            ("delta_g1", e1, g1, "delta"), ("beta_g2", e2, g2, "beta"),
            ("delta_g2", e2, g2, "delta")):
        assert tgroth16.affine_to_ints(curve, getattr(params, name)) \
            == H.mul(H.gen, TOXIC[k]), name
    assert tgroth16.affine_to_ints(e2, params.vk.gamma_g2) \
        == g2.mul(g2.gen, TOXIC["gamma"])


def test_setup_keeps_one_table_a_curve(setup_2p6):
    """The 2^6 setup built BLS12-377 G1's table; the next call takes the
    same."""
    curve = TCI.bls12_377_g1("cpu")
    assert tgroth16.setup_table(curve) is tgroth16.setup_table(curve)
    (tx, _), _ = tgroth16.setup_table(curve)
    assert tx.shape[:2] == (32, 256)          # ceil(253 / 8) windows
