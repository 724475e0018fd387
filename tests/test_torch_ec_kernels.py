"""Port vs JAX package: the fused curve kernels' module
(gingerlib_tpu_torch.ops.ec_kernels) on ``device="cpu"``, where every wrapper
runs its plain PyTorch version.

* the unified projective addition against JAX ``SWCurveOps.add``, digit for
  digit in X, Y and Z;
* the batched affine addition (pre, shared inversion, post) against JAX
  ``to_affine(add(P, Q))`` and the infinity flag;
* the shared inversion against python's ``pow(v, -1, p)``;

on BLS12-377 G1 with one lane of every special kind, and the same lanes on
MNT4-753 G1 against the port's python-int curve.  Under ``slow``: the plain
versions against the Pallas kernels in interpret mode.  Inputs come from a
seeded numpy generator.  Integer arithmetic: tolerance 0.

The CUDA kernels themselves run only on a GPU: ``chip_smoke.py`` holds them
against these plain versions there, and tests/test_torch_gpu_kernels.py does
the same under pytest on a machine with a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gingerlib_tpu.curves import instances as JCI
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops import ec_kernels as EK
from gingerlib_tpu_torch.proofs import groth16_host
from gingerlib_tpu_torch.utils.convert import points_from_numpy, \
    points_to_numpy
from test_torch_cases import LANES, PROJ_LANES, affine_pairs, proj_pairs

torch.set_num_threads(1)
N = 16


def scalars(n, nd, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 1 << 16, size=(n, nd), dtype=np.int64)


def to_jax(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def lane_of(t, lane):
    return t[lane:] if lane == LANES["ordinary"] else t[lane]


def make_points(tg):
    """N distinct projective points with Z != 1 and their affine form."""
    k = torch.from_numpy(scalars(N, 1, seed=21))
    proj = tg.mul_scalar_digits(tg.generator((N,)), k)
    return proj, tg.to_affine(proj)


def as_projective(tg, pt):
    (x, y), inf = pt
    return tg.select(inf, tg.zero((N,)), tg.from_affine(x, y))


# ---------------------------------------------------------------------------
# BLS12-377 G1 against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bls():
    jg, tg = JCI.bls12_377_g1(), TCI.bls12_377_g1("cpu")
    proj, aff = make_points(tg)
    P, Q = proj_pairs(tg, proj)
    a_pt, b_pt = affine_pairs(tg, aff)
    jadd = jax.jit(jg.add)
    want_proj = jadd(tuple(map(to_jax, P)), tuple(map(to_jax, Q)))

    def affine_sum(A, B):
        S = jg.add(A, B)
        return jg.to_affine(S), jg.is_zero(S)

    want_aff = jax.jit(affine_sum)(
        tuple(map(to_jax, as_projective(tg, a_pt))),
        tuple(map(to_jax, as_projective(tg, b_pt))))
    return dict(jg=jg, tg=tg, P=P, Q=Q, a_pt=a_pt, b_pt=b_pt,
                got_proj=EK.proj_add(tg, P, Q), want_proj=want_proj,
                got_aff=tg.batch_affine_add(a_pt, b_pt), want_aff=want_aff)


@pytest.mark.parametrize("kind", sorted(PROJ_LANES))
def test_proj_add_matches_jax_add(bls, kind):
    lane = PROJ_LANES[kind]
    for got, want in zip(bls["got_proj"], bls["want_proj"]):
        assert np.array_equal(lane_of(got, lane).numpy(),
                              lane_of(np.asarray(want), lane)
                              .astype(np.int64)), kind
    inf = bls["tg"].is_zero(bls["got_proj"])
    if kind in ("opposite", "both_infinity", "y_zero_doubling"):
        assert bool(inf[lane])
    elif kind != "ordinary":
        assert not bool(inf[lane])


def test_proj_add_of_a_point_to_itself_is_double(bls):
    tg, P = bls["tg"], bls["P"]
    for got, want in zip(EK.proj_add(tg, P, P), tg.double(P)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", sorted(LANES))
def test_batch_affine_add_matches_jax(bls, kind):
    lane = LANES[kind]
    (gx, gy), ginf = bls["got_aff"]
    (wx, wy), winf = bls["want_aff"]
    assert np.array_equal(lane_of(ginf, lane).numpy(),
                          lane_of(np.asarray(winf), lane)), kind
    for got, want in ((gx, wx), (gy, wy)):
        assert np.array_equal(lane_of(got, lane).numpy(),
                              lane_of(np.asarray(want), lane)
                              .astype(np.int64)), kind
    if kind in ("opposite", "both_infinity", "y_zero_doubling"):
        assert bool(ginf[lane]) and not gx[lane].any() and not gy[lane].any()


def test_pre_and_post_are_the_two_halves(bls):
    """pre -> shared inversion -> post is batch_affine_add; lanes that do
    not use lambda may carry a zero denominator, and a doubling lane's
    denominator is 2y."""
    tg = bls["tg"]
    (x1, y1), inf1 = bls["a_pt"]
    (x2, y2), inf2 = bls["b_pt"]
    num, den, inf3 = EK.affine_pre(tg, x1, y1, x2, y2, inf1, inf2)
    assert torch.equal(den[0], tg.F.double(y1[0]))
    assert not den[1].any() and not den[4].any() and not den[5].any()
    dinv = EK.batch_inverse(tg.fp, den.reshape(N, -1)).reshape(den.shape)
    x3, y3 = EK.affine_post(tg, num, dinv, x1, y1, x2, y2, inf1, inf2, inf3)
    (gx, gy), ginf = bls["got_aff"]
    assert torch.equal(x3, gx) and torch.equal(y3, gy) \
        and torch.equal(inf3, ginf)


@pytest.mark.parametrize("field,n", [
    ("BLS12_377_FQ", 1), ("BLS12_377_FQ", 5), ("BLS12_377_FQ", 16),
    ("BLS12_377_FR", 5), ("MNT4753_FQ", 5)])
def test_batch_inverse_matches_pow(field, n):
    P = getattr(TP, field)
    p = P.modulus
    rng = np.random.default_rng(n)
    vals = [int.from_bytes(rng.bytes(100), "little") % p for _ in range(n)]
    if n > 1:
        vals[1] = 0
        vals[n - 1] = 0
    a = torch.from_numpy(tfp.fp_from_ints(P, vals))
    got = tfp.fp_to_ints(P, EK.batch_inverse(P, a))
    assert got == [pow(v, -1, p) if v else 0 for v in vals]


@pytest.mark.parametrize("field,n", [
    ("BLS12_377_FQ", 2), ("BLS12_377_FQ", 21), ("BLS12_377_FR", 16),
    ("MNT4753_FQ", 11)])
def test_inversion_levels_match_python_ints(field, n):
    """One level of the up sweep (prefix products inside each run, run
    products) and of the down sweep (inverses from the run products'
    inverses), as the two inversion kernels compute them; zeros count as one
    going up and come out as zero."""
    P = getattr(TP, field)
    p, run = P.modulus, EK.INV_RUN
    rng = np.random.default_rng(100 + n)
    vals = [int.from_bytes(rng.bytes(100), "little") % p for _ in range(n)]
    vals[1] = 0
    vals[n - 1] = 0
    x = torch.from_numpy(tfp.fp_from_ints(P, vals))
    pre, roots = EK.inv_up_plain(P, x)
    want_pre, want_roots = [], []
    for i, v in enumerate(vals):
        acc = 1 if i % run == 0 else want_pre[-1]
        want_pre.append(acc * (v or 1) % p)
        if i % run == run - 1 or i == n - 1:
            want_roots.append(want_pre[-1])
    assert tfp.fp_to_ints(P, pre) == want_pre
    assert tfp.fp_to_ints(P, roots) == want_roots
    rinv = torch.from_numpy(tfp.fp_from_ints(
        P, [pow(v, -1, p) for v in want_roots]))
    got = tfp.fp_to_ints(P, EK.inv_down_plain(P, x, pre, rinv))
    assert got == [pow(v, -1, p) if v else 0 for v in vals]


def test_unpack_limbs_splits_32_bit_words_into_digits():
    digits = np.random.default_rng(9).integers(0, 1 << 16, size=(5, 24),
                                               dtype=np.int64)
    digits[0] = 0xFFFF                              # top bit of a word set
    packed = (digits[:, 0::2] | (digits[:, 1::2] << 16)).astype(np.uint32)
    got = EK.unpack_limbs(torch.from_numpy(packed.view(np.int32)))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), digits)


def test_supports_base_field_curves_only():
    assert EK.supports(TCI.bls12_377_g1("cpu"))
    assert EK.supports(TCI.mnt4753_g1("cpu"))
    assert not EK.supports(TCI.mnt4753_g2("cpu"))


@pytest.mark.parametrize("wrapper", ["proj_add", "affine_pre", "affine_post",
                                     "batch_inverse", "inv_up", "inv_down"])
def test_kernel_wrappers_refuse_cpu_tensors(bls, wrapper):
    """No fallback: the launching half of a wrapper raises on a tensor that
    is not on a GPU instead of taking the plain version."""
    tg = bls["tg"]
    (x1, y1), inf1 = bls["a_pt"]
    (x2, y2), inf2 = bls["b_pt"]
    calls = {
        "proj_add": lambda: EK.proj_add_cuda(tg, bls["P"], bls["Q"]),
        "affine_pre": lambda: EK.affine_pre_cuda(tg, x1, y1, x2, y2, inf1,
                                                 inf2),
        "affine_post": lambda: EK.affine_post_cuda(
            tg, x1, y1, x1, y1, x2, y2, inf1, inf2, inf1),
        "batch_inverse": lambda: EK.batch_inverse_cuda(tg.fp, x1[:, 0]),
        "inv_up": lambda: EK.inv_up_cuda(tg.fp, x1[:, 0]),
        "inv_down": lambda: EK.inv_down_cuda(
            tg.fp, x1[:, 0], torch.zeros(N, 12, dtype=torch.int32),
            x1[:2, 0]),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[wrapper]()


def test_curve_kernels_refuse_extension_field_curves():
    g2 = TCI.bls12_377_g2("cpu")
    with pytest.raises(NotImplementedError, match="base field"):
        EK.proj_add_cuda(g2, g2.zero((2,)), g2.zero((2,)))


def test_points_cross_between_the_packages(bls):
    """convert.points_from_numpy / points_to_numpy: a JAX affine batch and
    a projective triple arrive as the port's tensors and go back."""
    a_np = points_to_numpy(bls["a_pt"])
    (x, _), inf = a_np
    assert x.dtype == np.uint32 and inf.dtype == np.bool_
    back = points_from_numpy(a_np, device="cpu")
    assert back[0][0].dtype == torch.int64 and back[1].dtype == torch.bool
    assert torch.equal(back[0][0], bls["a_pt"][0][0]) \
        and torch.equal(back[0][1], bls["a_pt"][0][1]) \
        and torch.equal(back[1], bls["a_pt"][1])
    triple = points_from_numpy(tuple(np.asarray(c)
                                     for c in bls["want_proj"]), "cpu")
    assert all(torch.equal(g, w) for g, w in zip(triple, bls["got_proj"]))


# ---------------------------------------------------------------------------
# MNT4-753 G1 against python-int affine arithmetic
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mnt4():
    tg = TCI.mnt4753_g1("cpu")
    host = groth16_host.host_curves("mnt4753")[0]
    proj, aff = make_points(tg)
    P, Q = proj_pairs(tg, proj)
    a_pt, b_pt = affine_pairs(tg, aff)

    def host_pt(x, y, inf):
        if bool(inf):
            return None
        return (tfp.fp_to_ints(tg.fp, x), tfp.fp_to_ints(tg.fp, y))

    def host_pts(x, y, inf):
        return [host_pt(*lane) for lane in zip(x, y, inf)]

    sums = EK.proj_add(tg, P, Q)
    sx, sy = tg.to_affine(sums)
    (gx, gy), ginf = tg.batch_affine_add(a_pt, b_pt)
    pa = host_pts(*tg.to_affine(P), tg.is_zero(P))
    qa = host_pts(*tg.to_affine(Q), tg.is_zero(Q))
    return dict(
        host=host,
        proj=(pa, qa, host_pts(sx, sy, tg.is_zero(sums))),
        aff=(host_pts(*a_pt[0], a_pt[1]), host_pts(*b_pt[0], b_pt[1]),
             host_pts(gx, gy, ginf)))


@pytest.mark.parametrize(
    "form,kind", [("proj", k) for k in sorted(PROJ_LANES)]
    + [("aff", k) for k in sorted(LANES)])
def test_mnt4753_special_lanes_against_python_ints(mnt4, form, kind):
    lane = PROJ_LANES[kind]
    host = mnt4["host"]
    pa, qa, got = mnt4[form]
    lanes = range(lane, N) if kind == "ordinary" else [lane]
    for i in lanes:
        assert got[i] == host.add(pa[i], qa[i]), (kind, i)


# ---------------------------------------------------------------------------
# slow: against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pallas(bls):
    from gingerlib_tpu.ops import pallas_ec
    jg, tg = bls["jg"], bls["tg"]
    nd = tg.fp.n_digits

    def dm(t):
        return pallas_ec._to_dm(to_jax(t[:, 0]), N)

    sums = pallas_ec.proj_add_dm(jg, tuple(map(dm, bls["P"])),
                                 tuple(map(dm, bls["Q"])), interpret=True)
    proj = tuple(np.asarray(pallas_ec._from_dm(s, N, nd)).astype(np.int64)
                 for s in sums)
    a_np, b_np = points_to_numpy(bls["a_pt"]), points_to_numpy(bls["b_pt"])
    aff = pallas_ec.batch_affine_add_fused(
        jg, jax.tree_util.tree_map(jnp.asarray, a_np),
        jax.tree_util.tree_map(jnp.asarray, b_np), interpret=True)
    return proj, aff


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(PROJ_LANES))
def test_proj_add_matches_pallas_interpret(bls, pallas, kind):
    lane = PROJ_LANES[kind]
    for got, want in zip(bls["got_proj"], pallas[0]):
        assert np.array_equal(lane_of(got[:, 0], lane).numpy(),
                              lane_of(want, lane)), kind


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(LANES))
def test_batch_affine_add_matches_pallas_interpret(bls, pallas, kind):
    lane = LANES[kind]
    (gx, gy), ginf = bls["got_aff"]
    (wx, wy), winf = pallas[1]
    assert np.array_equal(lane_of(ginf, lane).numpy(),
                          lane_of(np.asarray(winf), lane)), kind
    for got, want in ((gx, wx), (gy, wy)):
        assert np.array_equal(lane_of(got, lane).numpy(),
                              lane_of(np.asarray(want), lane)
                              .astype(np.int64)), kind
