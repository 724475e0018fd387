"""Port: the batched affine addition with RNS multiplies (K8,
gingerlib_tpu_torch.ops.ec_rns) and the curves that ask for it
(``SWCurveOps(..., ec_rns=True)``), on ``device="cpu"``, where pre, tree and
post run their plain PyTorch versions.

* on BLS12-377 G1 and MNT4-753 G1, with one lane of every special kind,
  the RNS addition equals the port's positional ``batch_affine_add_plain``
  (held to the JAX package in tests/test_torch_ec_kernels.py) and the
  python-int curve, digit for digit;
* ``ecr_pre_plain``'s numerators, denominators, coordinates in RNS and flags
  equal a composition of the JAX package's ``ops/rns.py`` functions on the
  same lanes (its formulas and scale constants: pallas_ec_rns.py:60-90,
  127-193), and the RNS tree's inverses times the denominators give M_A^2;
* ``msm_affine`` over an RNS BLS12-377 G1 equals ``msm_naive`` and the
  closed form on the inputs tests/test_torch_msm_pippenger.py uses;
  ``msm_hybrid`` on such a curve keeps to the positional kernels;
* under ``slow``: the RNS addition against the JAX package's
  ``batch_affine_add_rns`` in interpret mode, 16 MNT4-753 lanes (~45 s).

Inputs come from seeded generators.  Integer arithmetic: tolerance 0.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gingerlib_tpu.ops import rns as jrns
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.curves.sw import SWCurveOps
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops import ec_kernels as EK
from gingerlib_tpu_torch.ops import ec_rns as ER
from gingerlib_tpu_torch.ops import msm as tmsm
from gingerlib_tpu_torch.ops import rns as trns
from gingerlib_tpu_torch.ops import rns_kernels as RK
from gingerlib_tpu_torch.proofs import groth16_host
from gingerlib_tpu_torch.utils.convert import points_to_numpy
from test_torch_cases import LANES, affine_pairs, msm_case, scalar_multiple

torch.set_num_threads(1)
N = 16


def make_pairs(curve):
    """The special-lane pairs of test_torch_cases over N distinct affine
    multiples of the generator."""
    k = torch.from_numpy(np.random.default_rng(21).integers(
        1, 1 << 16, size=(N, 1), dtype=np.int64))
    return affine_pairs(curve, curve.to_affine(
        curve.mul_scalar_digits(curve.generator((N,)), k)))


def host_points(curve, x, y, inf):
    return [None if bool(i) else (tfp.fp_to_ints(curve.fp, a),
                                  tfp.fp_to_ints(curve.fp, b))
            for a, b, i in zip(x, y, inf)]


@pytest.fixture(scope="module", params=["bls12_377", "mnt4753"])
def case(request):
    name = request.param
    rns_curve = getattr(TCI, name + "_g1")("cpu", ec_rns=True)
    plain_curve = getattr(TCI, name + "_g1")("cpu")
    a_pt, b_pt = make_pairs(rns_curve)
    return dict(name=name, curve=rns_curve, a_pt=a_pt, b_pt=b_pt,
                got=rns_curve.batch_affine_add(a_pt, b_pt),
                want=EK.batch_affine_add_plain(plain_curve, a_pt, b_pt))


@pytest.mark.parametrize("kind", sorted(LANES))
def test_rns_add_equals_positional_and_python_ints(case, kind):
    lane = LANES[kind]
    lanes = slice(lane, N) if kind == "ordinary" else slice(lane, lane + 1)
    (gx, gy), ginf = case["got"]
    (wx, wy), winf = case["want"]
    assert torch.equal(ginf[lanes], winf[lanes]), kind
    assert torch.equal(gx[lanes], wx[lanes]) and \
        torch.equal(gy[lanes], wy[lanes]), kind
    curve = case["curve"]
    host = groth16_host.host_curves(case["name"])[0]
    pa = host_points(curve, *case["a_pt"][0], case["a_pt"][1])
    qa = host_points(curve, *case["b_pt"][0], case["b_pt"][1])
    got = host_points(curve, gx, gy, ginf)
    for i in range(N)[lanes]:
        assert got[i] == host.add(pa[i], qa[i]), (kind, i)


def test_pre_equals_a_composition_of_the_jax_rns_functions(case):
    """num, den, x1r, y1r, x2r, inf3 and dead of ``ecr_pre_plain`` against
    the JAX ``to_rns_digits`` / ``mont_mul_rns`` and channelwise sums on
    the same lanes, with the scale constants of pallas_ec_rns.py."""
    curve = case["curve"]
    p, nd = curve.fp.modulus, curve.fp.n_digits
    ctx = jrns.make_context(p)
    (x1, y1), inf1 = case["a_pt"]
    (x2, y2), inf2 = case["b_pt"]
    got = ER.ecr_pre_plain(curve, x1, y1, x2, y2, inf1, inf2)
    R = curve.fp.r
    ma = jnp.asarray(ctx.mA, jnp.uint32)
    mb = jnp.asarray(ctx.mB, jnp.uint32)

    def const(v):
        return jrns.to_rns(ctx, [v])

    def conv(t):
        r = jrns.to_rns_digits(ctx, jnp.asarray(
            t.reshape(N, nd).numpy().astype(np.uint32)))
        return jrns.mont_mul_rns(ctx, r, const(
            ctx.MA * ctx.MA % p * pow(R, -1, p) % p))

    def lin(f, *xs):
        return tuple(f(*(x[i] for x in xs), m) for i, m in enumerate((ma, mb)))

    add = lambda a, b: lin(lambda u, v, m: (u + v) % m, a, b)
    p4 = const(4 * p)
    sub4 = lambda a, b: lin(lambda u, o, v, m: (u + (o + m - v) % m) % m,
                            a, p4, b)
    X1, Y1, X2, Y2 = (conv(t) for t in (x1, y1, x2, y2))
    xx = jrns.mont_mul_rns(ctx, X1, X1)
    a_plain = tfp.fp_to_int(curve.fp, curve.a.reshape(-1))
    txa = add(add(add(xx, xx), xx), const(a_plain * ctx.MA % p))
    X1n, Y1n, X2n, Y2n = (t.reshape(N, nd).numpy()
                          for t in (x1, y1, x2, y2))
    same_x = (X1n == X2n).all(-1)
    same_y = (Y1n == Y2n).all(-1)
    i1, i2 = inf1.numpy(), inf2.numpy()
    dbl = same_x & same_y & ~i1 & ~i2
    anti = same_x & ~same_y & ~i1 & ~i2
    inf3 = (i1 & i2) | anti | (dbl & (Y1n == 0).all(-1))
    sel = dbl[:, None]
    want = [tuple(np.where(sel, a, b) for a, b in zip(txa, sub4(Y2, Y1))),
            tuple(np.where(sel, a, b) for a, b in zip(add(Y1, Y1),
                                                       sub4(X2, X1))),
            X1, Y1, X2]
    for g, w in zip(got[:5], want):
        ga, gb = RK.unpack_rns(trns.make_context(p), g)
        assert np.array_equal(ga.numpy(), np.asarray(w[0]).astype(np.int64))
        assert np.array_equal(gb.numpy(), np.asarray(w[1]).astype(np.int64))
    assert np.array_equal(got[5].numpy(), inf3)
    assert np.array_equal(got[6].numpy(), inf3 | i1 | i2)


def test_tree_inverses_times_denominators_are_ma_squared(case):
    """Leaves d M_A, inverses d^-1 M_A: their values multiply to M_A^2 mod
    p in every live lane; dead lanes come out as zero residues."""
    curve = case["curve"]
    (x1, y1), inf1 = case["a_pt"]
    (x2, y2), inf2 = case["b_pt"]
    _, den, *_, dead = ER.ecr_pre_plain(curve, x1, y1, x2, y2, inf1, inf2)
    dinv = ER.tree_inverse_rns(curve, den, dead)
    ctx = trns.make_context(curve.fp.modulus)
    p = ctx.p
    dv = trns.from_rns(ctx, RK.unpack_rns(ctx, den)[0])
    iv = trns.from_rns(ctx, RK.unpack_rns(ctx, dinv)[0])
    assert int(dead.sum()) >= 4
    for d, i, off in zip(dv, iv, dead.tolist()):
        if off:
            assert i == 0
        else:
            assert d * i % p == ctx.MA * ctx.MA % p


def test_ec_rns_asks_for_a_base_field_curve():
    from gingerlib_tpu_torch.params._gen import curves_gen as CG
    c = CG.BLS12_377
    with pytest.raises(NotImplementedError, match="base field"):
        SWCurveOps("bls12_377_g2", TCI.bls12_377_towers()[1], c["g2_a"],
                   c["g2_b"], device="cpu", ec_rns=True)
    assert ER.supports(TCI.mnt4753_g1("cpu"))
    assert not ER.supports(TCI.mnt4753_g2("cpu"))
    assert TCI.bls12_377_g1("cpu", ec_rns=True) is not TCI.bls12_377_g1("cpu")


@pytest.mark.parametrize("wrapper", ["ecr_pre", "ecr_post"])
def test_k8_wrappers_refuse_cpu_tensors(case, wrapper):
    curve = case["curve"]
    (x1, y1), inf1 = case["a_pt"]
    (x2, y2), inf2 = case["b_pt"]
    res = torch.zeros((N, RK.LANES), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "ecr_pre":
            ER.ecr_pre_cuda(curve, x1, y1, x2, y2, inf1, inf2)
        else:
            ER.ecr_post_cuda(curve, res, res, res, res, res, x1, y1, x2, y2,
                             inf1, inf2, inf1)


# ---------------------------------------------------------------------------
# msm_affine over an RNS curve; msm_hybrid keeps to the positional kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def msm():
    g1 = TCI.bls12_377_g1("cpu", ec_rns=True)
    return dict(msm_case(g1), g1=g1)


def test_msm_affine_over_rns_equals_naive_and_closed_form(msm):
    g1, xs, ys, sd, inf = (msm[k] for k in ("g1", "xs", "ys", "sd", "inf"))
    got = tmsm.msm_affine(g1, xs, ys, sd, c=4, nbits=12, inf_mask=inf)
    assert bool(g1.eq(got, tmsm.msm_naive(g1, xs, ys, sd[:, :1],
                                          inf_mask=inf)))
    assert bool(g1.eq(got, scalar_multiple(g1, msm["total"])))


def test_msm_hybrid_on_an_rns_curve_takes_no_rns_addition(msm, monkeypatch):
    """As the JAX package's msm_hybrid, which calls batch_affine_add_dm
    whatever GINGERLIB_EC_RNS says: its affine tree levels (three of them
    at this cutoff) go to the positional kernels, and the point is the
    scalar combination.  (On a GPU the launch counters show the same:
    tests/test_torch_gpu_kernels.py.)"""
    g1, xs, ys, sd, inf = (msm[k] for k in ("g1", "xs", "ys", "sd", "inf"))
    calls = []
    real = ER.ecr_pre_plain
    monkeypatch.setattr(ER, "ecr_pre_plain",
                        lambda *a: (calls.append(a[1].shape[0]), real(*a))[1])
    got = tmsm.msm_hybrid(g1, xs, ys, sd, c=4, nbits=12, inf_mask=inf,
                          affine_cutoff=4)
    assert calls == []
    assert bool(g1.eq(got, scalar_multiple(g1, msm["total"])))
    g1.batch_affine_add(((xs[:2], ys[:2]), inf[:2]),
                        ((xs[2:4], ys[2:4]), inf[2:4]))
    assert calls == [2]


# ---------------------------------------------------------------------------
# slow: against the JAX package's RNS addition in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_rns_add_equals_jax_batch_affine_add_rns():
    """16 MNT4-753 lanes with every special kind, the JAX Pallas kernels in
    interpret mode (~45 s on one CPU core)."""
    from gingerlib_tpu.curves import instances as JCI
    from gingerlib_tpu.ops import pallas_ec_rns
    curve = TCI.mnt4753_g1("cpu", ec_rns=True)
    a_pt, b_pt = make_pairs(curve)
    (gx, gy), ginf = curve.batch_affine_add(a_pt, b_pt)
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, points_to_numpy(t))
    (wx, wy), winf = pallas_ec_rns.batch_affine_add_rns(
        JCI.mnt4753_g1(), to_jax(a_pt), to_jax(b_pt), interpret=True)
    assert np.array_equal(ginf.numpy(), np.asarray(winf))
    assert np.array_equal(gx.numpy(), np.asarray(wx).astype(np.int64))
    assert np.array_equal(gy.numpy(), np.asarray(wy).astype(np.int64))
