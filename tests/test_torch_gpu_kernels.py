"""The port's curve, pow-chain, Poseidon and RNS kernels against their plain
PyTorch versions, under pytest, on a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_gpu_kernels.py -q

(``--noconftest`` because tests/conftest.py sets up JAX, which such a machine
need not have; this file imports only torch and the port.)  Without a CUDA
device every case skips: a CUDA kernel has no CPU form, and the CPU tests
hold the plain versions against the JAX package instead.  Integer
arithmetic: tolerance 0.
"""

import pytest
import torch

from gingerlib_tpu_torch.curves import instances as CI
from gingerlib_tpu_torch.ops import ec_kernels as EK, msm as tmsm
from gingerlib_tpu_torch.ops import ec_rns as ER
from test_torch_cases import (affine_pairs, poseidon_states, proj_pairs,
                              reduced_poseidon)

pytestmark = pytest.mark.gpu
N = 64


@pytest.fixture(scope="module", params=["bls12_377", "mnt4753"])
def curve(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the curve kernels have no CPU form")
    return getattr(CI, request.param + "_g1")()


@pytest.fixture(scope="module")
def points(curve):
    """N projective multiples of the generator and their affine form."""
    k = torch.randint(1, 1 << 16, (N, 1), dtype=torch.int64,
                      generator=torch.Generator().manual_seed(3))
    proj = curve.mul_scalar_digits(curve.generator((N,)),
                                   k.to(curve.device))
    return proj, curve.to_affine(proj)


def test_proj_add_matches_plain(curve, points):
    P, Q = proj_pairs(curve, points[0])
    for got, want in zip(EK.proj_add(curve, P, Q),
                         EK.proj_add_plain(curve, P, Q)):
        assert torch.equal(got, want)


def test_batch_affine_add_matches_plain(curve, points):
    a_pt, b_pt = affine_pairs(curve, points[1])
    (gx, gy), ginf = curve.batch_affine_add(a_pt, b_pt)
    (wx, wy), winf = EK.batch_affine_add_plain(curve, a_pt, b_pt)
    assert torch.equal(gx, wx) and torch.equal(gy, wy) \
        and torch.equal(ginf, winf)


def test_inversion_levels_match_plain(curve, points):
    """One level of the up and of the down kernel, on a ragged batch with
    zeros, against their array forms."""
    fp_params = curve.fp
    x = points[1][0][:N - 3, 0].clone()
    x[1] = x[8] = x[N - 4] = 0
    pre_packed, roots = EK.inv_up_cuda(fp_params, x)
    pre = EK.unpack_limbs(pre_packed)
    want_pre, want_roots = EK.inv_up_plain(fp_params, x)
    assert torch.equal(pre, want_pre) and torch.equal(roots, want_roots)
    rinv = EK.batch_inverse(fp_params, roots)
    assert torch.equal(EK.inv_down_cuda(fp_params, x, pre_packed, rinv),
                       EK.inv_down_plain(fp_params, x, pre, rinv))
    assert torch.equal(EK.batch_inverse(fp_params, x),
                       EK.batch_inverse_plain(fp_params, x))


def test_msm_hybrid_matches_naive(curve, points):
    xs, ys = points[1]
    sd = torch.randint(0, 1 << 16, (N, 2), dtype=torch.int64,
                       generator=torch.Generator().manual_seed(4))
    sd = sd.to(curve.device)
    got = tmsm.msm_hybrid(curve, xs, ys, sd, c=4, affine_cutoff=16)
    assert bool(curve.eq(got, tmsm.msm_naive(curve, xs, ys, sd)))


def test_rns_batch_affine_add_matches_plain(curve, points):
    """K8 (pre, the K7 tree, post) on the special lanes: the plain RNS
    path's residues and digits, and the positional kernels' digits."""
    rns_curve = getattr(CI, curve.name)(ec_rns=True)
    a_pt, b_pt = affine_pairs(curve, points[1])
    (x1, y1), inf1 = a_pt
    (x2, y2), inf2 = b_pt
    pre = ER.ecr_pre(rns_curve, x1, y1, x2, y2, inf1, inf2)
    for got, want in zip(pre, ER.ecr_pre_plain(rns_curve, x1, y1, x2, y2,
                                               inf1, inf2)):
        assert torch.equal(got, want)
    num, den, x1r, y1r, x2r, inf3, dead = pre
    dinv = ER.tree_inverse_rns(rns_curve, den, dead)
    assert torch.equal(dinv, ER.tree_inverse_rns(rns_curve, den, dead,
                                                 plain=True))
    args = (num, dinv, x1r, y1r, x2r, x1, y1, x2, y2, inf1, inf2, inf3)
    for got, want in zip(ER.ecr_post(rns_curve, *args),
                         ER.ecr_post_plain(rns_curve, *args)):
        assert torch.equal(got, want)
    (gx, gy), ginf = rns_curve.batch_affine_add(a_pt, b_pt)
    (wx, wy), winf = EK.batch_affine_add(curve, a_pt, b_pt)
    assert torch.equal(gx, wx) and torch.equal(gy, wy) \
        and torch.equal(ginf, winf)


def test_msm_on_an_rns_curve(curve, points):
    """msm_affine over the RNS curve launches K7 and K8 and equals
    msm_naive; msm_hybrid over it launches neither."""
    from gingerlib_tpu_torch.fields import fp
    rns_curve = getattr(CI, curve.name)(ec_rns=True)
    xs, ys = points[1]
    sd = torch.randint(0, 1 << 16, (N, 1), dtype=torch.int64,
                       generator=torch.Generator().manual_seed(5))
    sd = sd.to(curve.device)
    want = tmsm.msm_naive(curve, xs, ys, sd)
    fp.reset_launch_counts()
    got = tmsm.msm_affine(rns_curve, xs, ys, sd, c=4)
    assert fp.launch_counts["ecr_pre"] > 0 and fp.launch_counts["ecr_post"] > 0
    assert fp.launch_counts["rns_mont"] > 0
    assert bool(curve.eq(got, want))
    fp.reset_launch_counts()
    got = tmsm.msm_hybrid(rns_curve, xs, ys, sd, c=4, affine_cutoff=16)
    assert fp.launch_counts["ec_affine_pre"] > 0
    assert fp.launch_counts["ecr_pre"] == fp.launch_counts["rns_mont"] == 0
    assert bool(curve.eq(got, want))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("name", ["MNT4753_FQ", "BLS12_377_FR"])
def test_pow_const_matches_plain(cuda, name):
    from gingerlib_tpu_torch import params as TP
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import limbs
    F = getattr(TP, name)
    vals = [0, 1, F.modulus - 1] + [(7 ** k) % F.modulus for k in range(40)]
    x = torch.from_numpy(fp.fp_from_ints(F, vals)).to(cuda)
    for bits in (F.legendre_exp_bits, limbs.bits_msb_first(0xC0FFEE11, 32)):
        assert torch.equal(fp.pow_const(F, x, bits),
                           fp.pow_const_plain(F, x, bits))


@pytest.mark.parametrize("name", ["mnt4753", "mnt6753"])
def test_poseidon_permute_matches_plain(cuda, name):
    """The reduced parameter sets on the special states, and the full ones
    on the zero state, which must give AFTER_ZERO_PERM."""
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import poseidon_kernels as PK
    from gingerlib_tpu_torch.primitives.poseidon import PoseidonParams
    full = getattr(PoseidonParams, name)(cuda)
    d = reduced_poseidon(name)
    P = PoseidonParams(full.field, d["t"], d["r_f"], d["r_p"], d["rate"],
                       d["c2"], d["round_cst"], d["mds"],
                       d["after_zero_perm"], device=cuda)
    states = poseidon_states(name)
    x = torch.from_numpy(fp.fp_from_ints(P.field, sum(states, []))).to(
        cuda).reshape(len(states), 3, -1)
    assert torch.equal(PK.permute(P, x), PK.permute_plain(P, x))
    zero = torch.zeros_like(x[:1])
    assert torch.equal(PK.permute(full, zero)[0], full.after_zero_perm)


@pytest.mark.parametrize("name", ["MNT4753_FQ", "BLS12_377_FQ"])
def test_rns_mont_matches_plain(cuda, name):
    """K7 residue for residue: 0, 1 and p - 1 among the operands, strided
    halves and one row against all, as the RNS tree passes them."""
    from gingerlib_tpu_torch import params as TP
    from gingerlib_tpu_torch.ops import rns, rns_kernels as RK
    p = getattr(TP, name).modulus
    ctx = rns.make_context(p)
    vals = [0, 1, p - 1] + [pow(7, k, p) for k in range(1, 62)]
    x = RK.pack_rns(ctx, *rns.to_rns(ctx, vals, cuda))
    y = x.flip(0)
    for a, b in ((x, y), (x[0::2], x[1::2]), (x, y[5:6])):
        assert torch.equal(RK.mont_mul_rns(p, a, b),
                           RK.mont_mul_rns_plain(p, a, b))
