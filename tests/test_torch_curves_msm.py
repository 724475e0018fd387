"""Port vs JAX package: curve arithmetic and the small-size MSMs
(gingerlib_tpu_torch.curves.sw, .ops.msm), on ``device="cpu"``.

BLS12-377 G1 is held against the JAX functions coordinate for coordinate
(projective X, Y, Z, so formulas and selects must match, not just points);
MNT4-753 G1 and G2 against python-int affine arithmetic with short scalars.
Inputs come from a seeded numpy generator.  Integer arithmetic: tolerance 0.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gingerlib_tpu.curves import instances as JCI
from gingerlib_tpu.ops import msm as jmsm
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops import limbs as tlimbs, msm as tmsm
from gingerlib_tpu_torch.proofs import groth16_host

torch.set_num_threads(1)
N = 16


def to_jax(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def same(jax_pt, torch_pt):
    return all(np.array_equal(np.asarray(j).astype(np.int64), t.numpy())
               for j, t in zip(jax_pt, torch_pt))


def scalars(n, nd, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 16, size=(n, nd), dtype=np.int64)


@pytest.fixture(scope="module")
def curves():
    return JCI.bls12_377_g1(), TCI.bls12_377_g1("cpu")


@pytest.fixture(scope="module")
def points(curves):
    """N distinct projective points with Z != 1, made by the port from
    one-digit scalars, plus their JAX copies."""
    _, tg = curves
    k = torch.from_numpy(scalars(N, 1, seed=1))
    tp = tg.mul_scalar_digits(tg.generator((N,)), k)
    return tuple(to_jax(c) for c in tp), tp


def special_lanes(tg, tp):
    """Second operand exercising every select: Q == P, Q == -P, Q = inf,
    and (with P = inf) inf + Q; the rest ordinary."""
    tq = tuple(c.roll(1, 0).clone() for c in tp)
    neg = tg.neg(tp)
    zero = tg.zero((N,))
    for c_q, c_p, c_n, c_z in zip(tq, tp, neg, zero):
        c_q[0] = c_p[0]
        c_q[1] = c_n[1]
        c_q[2] = c_z[2]
    tp2 = tuple(c.clone() for c in tp)
    for c_p, c_z in zip(tp2, zero):
        c_p[3] = c_z[3]
    return tp2, tq


def test_add_matches_jax_on_all_branches(curves, points):
    jg, tg = curves
    tp, tq = special_lanes(tg, points[1])
    got = tg.add(tp, tq)
    want = jax.jit(jg.add)(tuple(map(to_jax, tp)), tuple(map(to_jax, tq)))
    assert same(want, got)
    # lane 0 took the doubling branch, lane 1 cancelled to infinity
    assert bool(tg.is_zero(got)[1]) and bool(tg.eq(got, tg.double(tp))[0])
    assert bool(tg.is_zero(tg.double(tg.zero((2,)))).all())


def test_add_mixed_and_to_affine_match_jax(curves, points):
    jg, tg = curves
    jp, tp = points
    ax, ay = tg.to_affine(tp)
    jax_aff = jax.jit(jg.to_affine)(jp)
    assert same(jax_aff, (ax, ay))
    assert bool(tg.on_curve(ax, ay).all())
    tq = (ax.roll(1, 0), ay.roll(1, 0))
    tq[0][0], tq[1][0] = ax[0], ay[0]            # lane 0: doubling branch
    want = jax.jit(jg.add_mixed)(jp, (to_jax(tq[0]), to_jax(tq[1])))
    assert same(want, tg.add_mixed(tp, tq))


def test_to_affine_of_infinity_is_zero_zero(curves):
    _, tg = curves
    x, y = tg.to_affine(tg.zero((1,)))
    assert not x.any() and not y.any()


@pytest.fixture(scope="module")
def jax_mul(curves):
    """One compiled JAX double-and-add loop (16 lanes, one-digit scalars)
    for every test that needs the JAX side of a scalar multiplication."""
    return jax.jit(curves[0].mul_scalar_digits)


def test_mul_scalar_digits_matches_jax(curves, points, jax_mul):
    _, tg = curves
    jp, tp = points
    k = scalars(N, 1, seed=2)
    k[0] = 0
    assert same(jax_mul(jp, jnp.asarray(k, jnp.uint32)),
                tg.mul_scalar_digits(tp, torch.from_numpy(k)))


@pytest.fixture(scope="module")
def msm_case(curves, points):
    """16 affine points (as in tests/test_msm.py), four-digit scalars, one
    zero scalar and one masked lane."""
    _, tg = curves
    xs, ys = tg.to_affine(points[1])
    sd = scalars(N, 4, seed=3)
    sd[2] = 0
    inf = np.zeros(N, bool)
    inf[5] = True
    got = tmsm.msm_naive(tg, xs, ys, torch.from_numpy(sd),
                         inf_mask=torch.from_numpy(inf))
    return xs, ys, sd, inf, got


def test_msm_naive_matches_jax(curves, msm_case):
    """Against JAX's msm_naive at a size whose graph compiles quickly
    (2 points, one of them masked out; one-digit scalars); the reduction
    tree and the mask at 16 points are checked in the tests below."""
    jg, tg = curves
    xs, ys, sd, inf, _ = msm_case
    n = 2
    sd1 = np.ascontiguousarray(sd[:n, 3:4])
    inf1 = inf[:n].copy()
    inf1[1] = True
    want = jax.jit(lambda x, y, s, m: jmsm.msm_naive(
        jg, x, y, s, inf_mask=m))(to_jax(xs[:n]), to_jax(ys[:n]),
                                  jnp.asarray(sd1, jnp.uint32),
                                  jnp.asarray(inf1))
    assert same(want, tmsm.msm_naive(tg, xs[:n], ys[:n],
                                     torch.from_numpy(sd1),
                                     inf_mask=torch.from_numpy(inf1)))


def test_msm_naive_is_the_scalar_combination(curves, points, msm_case):
    """Independent of JAX: sum k_i * (s_i G) == (sum k_i s_i) G."""
    _, tg = curves
    _, _, sd, inf, got = msm_case
    r = tg.scalar_field.modulus
    base = tlimbs.from_digits_batch(scalars(N, 1, seed=1))
    ks = tlimbs.from_digits_batch(sd)
    total = sum(b * k for i, (b, k) in enumerate(zip(base, ks))
                if not inf[i]) % r
    assert bool(tg.eq(got, tg.mul_const(tg.generator(()), total)))


def test_msm_bucketed_and_batched_equal_naive(curves, msm_case):
    _, tg = curves
    xs, ys, sd, inf, got = msm_case
    sd_t, inf_t = torch.from_numpy(sd[:, :1].copy()), torch.from_numpy(inf)
    one = tmsm.msm_naive(tg, xs, ys, sd_t, inf_mask=inf_t)
    two = tmsm.msm_naive(tg, xs[:5], ys[:5], sd_t[:5])
    assert same(one, tmsm.msm_bucketed(tg, xs, ys, sd_t, inf_mask=inf_t))
    b1, b2 = tmsm.msm_batched(tg, [(xs, ys, sd_t, inf_t),
                                   (xs[:5], ys[:5], sd_t[:5], None)])
    assert same(one, b1) and same(two, b2)


def test_msm_bucketed_refuses_large_sizes(curves):
    """No size is refused: 2^12 points and more go to Pippenger (here with
    all-zero scalars, which must give infinity).  What is refused is the
    hybrid form on a curve over an extension field, whose kernels exist for
    the base field only."""
    _, tg = curves
    n = 1 << 12
    xs = tg.generator_affine[0].expand(n, -1, -1)
    ys = tg.generator_affine[1].expand(n, -1, -1)
    sd = torch.zeros((n, 1), dtype=torch.int64)
    assert bool(tg.is_zero(tmsm.msm_bucketed(tg, xs, ys, sd)))
    g2 = TCI.bls12_377_g2("cpu")
    with pytest.raises(NotImplementedError, match="msm_affine"):
        tmsm.msm_hybrid(g2, g2.generator_affine[0][None],
                        g2.generator_affine[1][None], sd[:1])


def test_fixed_base_msm_matches_jax(curves, jax_mul):
    """JAX's fixed_base_msm is the base broadcast over the batch and then
    mul_scalar_digits (ops/msm.py); its side is run as exactly that, so the
    loop compiled for the test above is reused."""
    jg, tg = curves
    k = scalars(N, 1, seed=4)
    assert same(jax_mul(jg.generator((N,)), jnp.asarray(k, jnp.uint32)),
                tmsm.fixed_base_msm(tg, tg.generator_affine,
                                    torch.from_numpy(k)))


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("family", ["mnt4753", "bls12_377"])
def test_scalar_mul_against_python_ints(family, group):
    """[k]G and [k1]G + [k2]G on the full-width curves, short scalars
    (one digit: 16 loop steps), against python-int affine arithmetic."""
    tg = getattr(TCI, f"{family}_{group}")("cpu")
    host = groth16_host.host_curves(family)[0 if group == "g1" else 1]
    k = scalars(3, 1, seed=5)
    k[2] = 0
    pts = tg.mul_scalar_digits(tg.generator((3,)), torch.from_numpy(k))
    ax, ay = tg.to_affine(pts)
    ks = [int(v) for v in k[:, 0]]
    for i, kv in enumerate(ks):
        want = host.mul(host.gen, kv)
        got = (tfp.fp_to_ints(tg.fp, ax[i]), tfp.fp_to_ints(tg.fp, ay[i]))
        assert got == (want if want is not None
                       else ([0] * tg.F.K, [0] * tg.F.K))
    sx, sy = tg.to_affine(tuple(c[None] for c in tg.add(
        tuple(c[0] for c in pts), tuple(c[1] for c in pts))))
    want = host.add(host.mul(host.gen, ks[0]), host.mul(host.gen, ks[1]))
    assert (tfp.fp_to_ints(tg.fp, sx[0]), tfp.fp_to_ints(tg.fp, sy[0])) \
        == want


@pytest.mark.parametrize("family", ["mnt4753", "bls12_377"])
def test_generators_and_constants_match_jax(family):
    for group in ("g1", "g2"):
        jg = getattr(JCI, f"{family}_{group}")()
        tg = getattr(TCI, f"{family}_{group}")("cpu")
        assert same((jg.a, jg.b) + tuple(jg.generator_affine),
                    (tg.a, tg.b) + tuple(tg.generator_affine))
        assert tg.scalar_field.modulus == jg.scalar_field.modulus
        assert bool(tg.on_curve(*tg.generator_affine))
