"""Port: the Pippenger MSMs (gingerlib_tpu_torch.ops.msm: ``msm_hybrid``,
``msm_affine``, the ``msm_bucketed`` / ``msm_batched`` dispatch) on
``device="cpu"``, where the fused curve kernels run as their plain versions.

Mirrors tests/test_msm.py of the JAX package: 16 multiples of the BLS12-377
G1 generator with a duplicated point in one bucket (a doubling lane in the
tree), a zero scalar and a masked point; results are held against the port's
``msm_naive`` and against the closed form [sum k_i s_i]G.  The window
digits, the default window width, and the sorted lanes and bucket counts a
chunk of windows starts from are held against the JAX functions.  The JAX
package's ``msm_hybrid`` itself runs its Pallas kernels in interpret mode,
minutes a call: under ``slow`` the port's result is held against it in all
three projective coordinates, and the coordinates it returned are kept here
(``JAX_HYBRID``) so that the quick run holds the port to them too.  Inputs
come from a seeded generator.  Integer arithmetic: tolerance 0.
"""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gingerlib_tpu.curves import instances as JCI
from gingerlib_tpu.ops import msm as jmsm
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.ops import limbs as tlimbs, msm as tmsm
from test_torch_cases import MSM_N as N, msm_case, multiples, \
    scalar_multiple

torch.set_num_threads(1)


def to_jax(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


@pytest.fixture(scope="module")
def case():
    """The inputs of tests/test_msm.py::test_msm_hybrid_matches_naive."""
    g1 = TCI.bls12_377_g1("cpu")
    c = msm_case(g1)
    return dict(c, g1=g1, naive=tmsm.msm_naive(
        g1, c["xs"], c["ys"], c["sd"][:, :1], inf_mask=c["inf"]),
        closed=scalar_multiple(g1, c["total"]))


def test_naive_is_the_scalar_combination(case):
    assert bool(case["g1"].eq(case["naive"], case["closed"]))


@pytest.fixture(scope="module")
def results(case):
    g1, xs, ys, sd, inf = (case[k] for k in ("g1", "xs", "ys", "sd", "inf"))
    out = {f"hybrid-cutoff-{cutoff}": tmsm.msm_hybrid(
        g1, xs, ys, sd, c=3, nbits=12, inf_mask=inf, window_chunk=2,
        affine_cutoff=cutoff) for cutoff in (1 << 15, 4)}
    out["hybrid-one-chunk"] = tmsm.msm_hybrid(
        g1, xs, ys, sd, c=4, nbits=12, inf_mask=inf)
    out["affine-g1"] = tmsm.msm_affine(g1, xs, ys, sd, c=4, nbits=12,
                                       inf_mask=inf)
    return out


# What the JAX package's msm_hybrid returns for ``case`` (c = 3, nbits = 12,
# window_chunk = 2) at each affine_cutoff: X, Y, Z as the integers their
# Montgomery-form digits spell.  test_msm_hybrid_matches_jax_hybrid (slow)
# holds the JAX function to these very values.
JAX_HYBRID = {
    1 << 15: (
        0xe6bb6725c8f5c753f5d04dbf0852c0330922b776afd5ec80486b722155ad66add80c61a3bcc1204ce8a3367c59fb14,
        0x2792bf691b0728bd460e72b49f9f5ebb25989af4bffc42882b8f5d090bf43eb2d4569cedf039cf5301278ae12fd6f7,
        0x940e4537f35c6db3e00fcbd989061691389451a2cc5be436f0b94ef1598f70775ecf33f40eeaa745422e65c43a5243),
    4: (
        0x16242889d241b8bc07822fc44c08e2e9677d48597213d51299ed5675ab3e46a29cc926b040e6af3f06ea23814970d7b,
        0x643155dc1a4a46f51538a34ffec66b37a1a3f439d6fdb0703d0bc42a1e7360c226f9b749e56a67471e579875df5752,
        0x1ad454f3796cf52afcb5fe004b6c1b2df709e47b69df12c65bcddd51bf9c71747a90b8bebaa69225d3a1df80bd2ed49),
}

FORMS = ["hybrid-cutoff-32768", "hybrid-cutoff-4", "hybrid-one-chunk",
         "affine-g1"]


@pytest.mark.parametrize("against", ["naive", "closed"])
@pytest.mark.parametrize("form", FORMS)
def test_bucketed_forms_equal_naive_and_closed_form(case, results, form,
                                                    against):
    assert bool(case["g1"].eq(results[form], case[against])), (form, against)


@pytest.mark.parametrize("cutoff", [1 << 15, 4])
def test_msm_hybrid_projective_coordinates_are_the_jax_ones(results, cutoff):
    """Not just the same point: the same pairing of lanes, so the same X, Y
    and Z, digit for digit, as the JAX package's msm_hybrid returned."""
    got = tuple(tlimbs.from_digits(c.reshape(-1))
                for c in results[f"hybrid-cutoff-{cutoff}"])
    assert got == JAX_HYBRID[cutoff]


def test_sorted_lanes_and_bucket_counts_match_jax(case):
    """What a chunk of windows starts from, against the JAX statements that
    msm_hybrid and msm_affine make it with: a stable sort by window digit
    (ties keep their order, so the same points pair up), bucket-0 and masked
    lanes flagged and zeroed, and for every bucket the number of smaller
    keys."""
    n, c = 32, 3
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 1 << c, size=(3, n), dtype=np.int64)
    keys[1] = 5                                   # one window all ties
    keys[2, 4:] = 0                               # one nearly empty
    xs = torch.arange(1, n + 1).reshape(n, 1, 1) * torch.ones(
        (1, 1, 2), dtype=torch.int64)
    inf = torch.from_numpy(rng.integers(0, 4, size=n) == 0)
    keys_s, (x, y, flags) = tmsm._sorted_chunk(xs, xs + 100, inf,
                                               torch.from_numpy(keys))
    counts = tmsm._bucket_counts(keys_s, c)

    jkeys = jnp.asarray(keys.astype(np.uint32))
    order = jax.vmap(jnp.argsort)(jkeys)
    want_keys = jnp.take_along_axis(jkeys, order, axis=1)
    flat = order.reshape(-1)
    want_inf = jnp.take(jnp.asarray(inf.numpy()), flat) \
        | (want_keys.reshape(-1) == 0)
    want_x = jnp.where(want_inf[:, None],
                       0, jnp.take(to_jax(xs.reshape(n, 2)), flat, axis=0))
    bvals = jnp.arange(1, 1 << c, dtype=want_keys.dtype)
    want_counts = jax.vmap(lambda k: jnp.searchsorted(
        k, bvals, side="left"))(want_keys)

    assert np.array_equal(keys_s.numpy(), np.asarray(want_keys))
    assert np.array_equal(flags.numpy(), np.asarray(want_inf))
    assert np.array_equal(x.reshape(-1, 2).numpy(), np.asarray(want_x))
    assert np.array_equal(y.reshape(-1, 2).numpy(),
                          np.where(np.asarray(want_inf)[:, None], 0,
                                   np.asarray(want_x) + 100))
    assert np.array_equal(counts.numpy(), np.asarray(want_counts).reshape(-1))


def test_hybrid_pads_a_ragged_batch(case):
    """13 points: N is padded to 16 with points at infinity."""
    g1, n = case["g1"], 13
    got = tmsm.msm_hybrid(g1, case["xs"][:n], case["ys"][:n], case["sd"][:n],
                          c=3, nbits=12, inf_mask=case["inf"][:n],
                          window_chunk=3)
    want = tmsm.msm_naive(g1, case["xs"][:n], case["ys"][:n],
                          case["sd"][:n, :1], inf_mask=case["inf"][:n])
    assert bool(g1.eq(got, want))


def test_msm_affine_g2():
    """The affine form over Fq2 (the prover's G2 path): 8 points, c = 5, as
    tests/test_msm.py::test_msm_affine_g2, with 20-bit scalars (four
    windows) to keep the plain CPU path short."""
    g2 = TCI.bls12_377_g2("cpu")
    rng = random.Random(99)
    n = 8
    ks = [rng.randrange(1, 500) for _ in range(n)]
    xs, ys = multiples(g2, ks)
    sc = [rng.randrange(1 << 20) for _ in range(n)]
    sd = torch.from_numpy(tlimbs.to_digits_batch(sc, 2))
    got = tmsm.msm_affine(g2, xs, ys, sd, c=5)
    assert bool(g2.eq(got, tmsm.msm_naive(g2, xs, ys, sd)))
    assert bool(g2.eq(got, scalar_multiple(
        g2, sum(k * s for k, s in zip(ks, sc)))))


def test_batched_sends_each_job_its_way(case, monkeypatch):
    """Jobs below the threshold share one double-and-add loop, larger ones
    take Pippenger; the results keep the order of the jobs.  (Threshold
    lowered to 8 points so that 16 points count as large.)"""
    g1, xs, ys, sd, inf = (case[k] for k in ("g1", "xs", "ys", "sd", "inf"))
    monkeypatch.setattr(tmsm, "NAIVE_BELOW", 8)
    sd1 = sd[:, :1].contiguous()
    calls = []
    real = tmsm.msm_hybrid
    monkeypatch.setattr(tmsm, "msm_hybrid", lambda *a, **k: (
        calls.append(a[1].shape[0]), real(*a, **k))[1])
    small, large, single = tmsm.msm_batched(g1, [
        (xs[:5], ys[:5], sd1[:5], None), (xs, ys, sd1, inf),
        (xs[3:4], ys[3:4], sd1[3:4], None)], c=4)
    assert calls == [N]
    assert bool(g1.eq(large, case["naive"]))
    assert bool(g1.eq(small, tmsm.msm_naive(g1, xs[:5], ys[:5], sd1[:5])))
    assert bool(g1.eq(single, tmsm.msm_naive(g1, xs[3:4], ys[3:4],
                                             sd1[3:4])))


def test_msm_bucketed_takes_2_to_the_12_points():
    """2^12 points and more no longer raise: they go to Pippenger.  One
    16-bit digit a scalar, so two 9-bit windows."""
    g1 = TCI.bls12_377_g1("cpu")
    n = 1 << 12
    rng = np.random.default_rng(5)
    base_x, base_y = multiples(g1, [3, 5, 7, 11])
    pick = torch.from_numpy(rng.integers(0, 4, size=n))
    xs, ys = base_x[pick], base_y[pick]
    sc = rng.integers(0, 1 << 16, size=(n, 1), dtype=np.int64)
    got = tmsm.msm_bucketed(g1, xs, ys, torch.from_numpy(sc))
    total = sum(int(k) * int(s)
                for k, s in zip(np.array([3, 5, 7, 11])[pick.numpy()],
                                sc[:, 0]))
    assert bool(g1.eq(got, scalar_multiple(g1, total)))


@pytest.mark.parametrize("c", [3, 4, 7, 9, 11, 13, 16])
def test_window_digits_match_jax_and_python(c):
    rng = random.Random(c)
    vals = [rng.randrange(1 << 253) for _ in range(6)] + [0, (1 << 253) - 1]
    d = tlimbs.to_digits_batch(vals, 16)
    got = tmsm._window_digits(torch.from_numpy(d), c, 253).numpy()
    want = np.asarray(jmsm._window_digits(
        jnp.asarray(d.astype(np.uint32)), c, 253))
    assert np.array_equal(got, want.astype(np.int64))
    for col, v in enumerate(vals):
        assert sum(int(w) << (c * i) for i, w in enumerate(got[:, col])) == v


def test_default_window_matches_jax():
    for lg in range(0, 24):
        for n in ((1 << lg) - 1, 1 << lg):
            assert tmsm.default_window(n) == jmsm.default_window(n)


# ---------------------------------------------------------------------------
# slow: against the JAX package's hybrid (Pallas kernels in interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("cutoff", [1 << 15, 4])
def test_msm_hybrid_matches_jax_hybrid(case, results, cutoff):
    """The same stable sort, the same pairing of lanes and the same
    formulas: the projective coordinates agree, not just the point."""
    jg = JCI.bls12_377_g1()
    want = jax.jit(lambda x, y, s: jmsm.msm_hybrid(
        jg, x, y, s, c=3, nbits=12, inf_mask=jnp.asarray(case["inf"].numpy()),
        window_chunk=2, affine_cutoff=cutoff))(
            to_jax(case["xs"]), to_jax(case["ys"]), to_jax(case["sd"]))
    for got, w, kept in zip(results[f"hybrid-cutoff-{cutoff}"], want,
                            JAX_HYBRID[cutoff]):
        w = np.asarray(w).astype(np.int64)
        assert np.array_equal(got.numpy(), w)
        assert tlimbs.from_digits(w.reshape(-1)) == kept
