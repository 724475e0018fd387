"""The port's field, curve, pow-chain, Poseidon and RNS kernels against their
plain PyTorch versions (the curve kernels also at MNT6-753 G1's constant,
and at the odd digit counts, 19 and 49, on MNT6-298 and SW6 G1),
and the MNT4-753, MNT6-753, BLS12-377 and BLS12-381 pairings, Groth16
verification, GM17 and the recursion's inner proof (through the bridge to
the verifier circuit), the twisted-Edwards curves, Pedersen, Schnorr and
the VRF (against their python-int oracles) and the field kernels at 16
digits that run over them, under pytest, on a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_gpu_kernels.py -q

(``--noconftest`` because tests/conftest.py sets up JAX, which such a machine
need not have; this file imports only torch and the port.)  Without a CUDA
device every case skips: a CUDA kernel has no CPU form, and the CPU tests
hold the plain versions against the JAX package instead.  Integer
arithmetic: tolerance 0.
"""

import numpy as np
import pytest
import torch

from gingerlib_tpu_torch.curves import instances as CI
from gingerlib_tpu_torch.ops import ec_kernels as EK, msm as tmsm
from gingerlib_tpu_torch.ops import ec_rns as ER
from test_torch_cases import (affine_pairs, dense_row_circuit,
                              host_alpha_beta, inv_inputs,
                              mnt4753_anchor, mnt6753_anchor,
                              one_constraint_circuit,
                              poseidon_states, pow_edge_exponents,
                              proj_pairs, rand_below, reduced_poseidon)

pytestmark = pytest.mark.gpu
N = 64


def _g1(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the curve kernels have no CPU form")
    return getattr(CI, name + "_g1")()


def _multiples(curve):
    """N projective multiples of the generator and their affine form."""
    k = torch.randint(1, 1 << 16, (N, 1), dtype=torch.int64,
                      generator=torch.Generator().manual_seed(3))
    proj = curve.mul_scalar_digits(curve.generator((N,)),
                                   k.to(curve.device))
    return proj, curve.to_affine(proj)


@pytest.fixture(scope="module", params=["bls12_377", "mnt4753", "mnt6753",
                                        "mnt6298", "sw6"])
def curve(request):
    return _g1(request.param)


@pytest.fixture(scope="module")
def points(curve):
    return _multiples(curve)


# the RNS kernels (K7, K8) are built at 24 and 48 digits only
@pytest.fixture(scope="module", params=["bls12_377", "mnt4753", "mnt6753"])
def rcurve(request):
    return _g1(request.param)


@pytest.fixture(scope="module")
def rpoints(rcurve):
    return _multiples(rcurve)


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


B = EK.INV_TILE


@pytest.mark.parametrize("n", [1, 2, B - 1, B, B + 1, 2 * B + 3])
def test_inversion_kernels_match_plain_at_tile_edges(curve, n):
    """The tail kernel (up to a tile), or up and down around the inversion
    of the tiles' products, against their plain versions and python's pow:
    zeros on the first and last element of every tile of three or more and,
    past two tiles, on the whole second tile.  A batch of up to a tile takes
    one launch, one of up to B^2 three, and neither the inverse kernel."""
    from gingerlib_tpu_torch.fields import fp
    F = curve.fp
    vals = rand_below(F.modulus, n, seed=n)
    for i in range(0, n, B):
        if min(i + B, n) - i >= 3:
            vals[i] = vals[min(i + B, n) - 1] = 0
    if n > 2 * B:
        vals[B:2 * B] = [0] * B
    x = torch.from_numpy(fp.fp_from_ints(F, vals)).to(curve.device)
    fp.reset_launch_counts()
    got = EK.batch_inverse(F, x)
    launched = {k: v for k, v in fp.launch_counts.items() if v}
    if n <= B:
        assert launched == {"inv_tree_tail": 1}
        assert torch.equal(EK.inv_tail_cuda(F, x), EK.inv_tail_plain(F, x))
    else:
        assert launched == {"inv_tree_up": 1, "inv_tree_tail": 1,
                            "inv_tree_down": 1}
        tree, roots = EK.inv_up_cuda(F, x)
        want_tree, want_roots = EK.inv_up_plain(F, x)
        assert torch.equal(EK.unpack_limbs(tree, F.n_digits), want_tree)
        assert torch.equal(roots, want_roots)
        rinv = EK.inv_tail_cuda(F, roots)
        assert torch.equal(rinv, EK.inv_tail_plain(F, roots))
        assert torch.equal(EK.inv_down_cuda(F, tree, rinv, n),
                           EK.inv_down_plain(F, want_tree, rinv, n))
    assert torch.equal(got, EK.batch_inverse_plain(F, x))
    assert fp.fp_to_ints(F, got) == [pow(v, -1, F.modulus) if v else 0
                                     for v in vals]


@pytest.mark.parametrize("form", ["dense", "strided", "one_lane",
                                  "expanded"])
def test_affine_pre_and_post_match_plain(curve, points, form):
    """K5's two kernels on the special lanes, with operands as the tree
    levels pass them (even and odd halves), one lane, and a row expanded
    over the batch."""
    a_pt, b_pt = affine_pairs(curve, points[1])
    (x1, y1), inf1 = a_pt
    (x2, y2), inf2 = b_pt
    ops = {"dense": (x1, y1, x2, y2, inf1, inf2),
           "strided": (x1[0::2], y1[0::2], x2[1::2], y2[1::2], inf1[0::2],
                       inf2[1::2]),
           "one_lane": (x1[:1], y1[:1], x2[:1], y2[:1], inf1[:1], inf2[:1]),
           "expanded": (x1, y1, x2[9:10].expand_as(x2),
                        y2[9:10].expand_as(y2), inf1, inf2)}[form]
    pre = EK.affine_pre(curve, *ops)
    want = EK.affine_pre_plain(curve, *ops)
    assert all(torch.equal(g, w) for g, w in zip(pre, want))
    num, den, inf3 = want
    dinv = EK.batch_inverse_plain(
        curve.fp, den.reshape(den.shape[0], -1)).reshape(den.shape)
    args = (num, dinv, *ops, inf3)
    assert all(torch.equal(g, w) for g, w in zip(
        EK.affine_post(curve, *args), EK.affine_post_plain(curve, *args)))


def test_msm_hybrid_matches_naive(curve, points):
    xs, ys = points[1]
    sd = torch.randint(0, 1 << 16, (N, 2), dtype=torch.int64,
                       generator=torch.Generator().manual_seed(4))
    sd = sd.to(curve.device)
    got = tmsm.msm_hybrid(curve, xs, ys, sd, c=4, affine_cutoff=16)
    assert bool(curve.eq(got, tmsm.msm_naive(curve, xs, ys, sd)))


def test_rns_batch_affine_add_matches_plain(rcurve, rpoints):
    """K8 (pre, the K7 tree, post) on the special lanes: the plain RNS
    path's residues and digits, and the positional kernels' digits."""
    curve, points = rcurve, rpoints
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


def test_msm_on_an_rns_curve(rcurve, rpoints):
    """msm_affine over the RNS curve launches K7 and K8 and equals
    msm_naive; msm_hybrid over it launches neither."""
    from gingerlib_tpu_torch.fields import fp
    curve, points = rcurve, rpoints
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


@pytest.mark.parametrize("name", ["MNT4753_FQ", "BLS12_377_FQ",
                                  "BLS12_377_FR"])
def test_pow_const_by_elements_and_edge_exponents(cuda, name):
    """K3 (a group of threads an element, blocks of 128 threads) at 1 ...
    129 elements, so that every group position of a block is the last,
    with the Legendre exponent; on 64 elements with each edge exponent of
    the window schedule; and the launcher's window is fp.pow_window's."""
    import ctypes
    from gingerlib_tpu_torch import params as TP
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import cuda_lib
    F = getattr(TP, name)
    vals = [0, 1, F.modulus - 1] + rand_below(F.modulus, 126, seed=83)
    x = fp.to_mont(F, torch.from_numpy(fp.fp_from_ints(F, vals)).to(cuda))
    bits = F.legendre_exp_bits
    want = fp.pow_const_plain(F, x, bits)
    for n in range(1, 130):
        assert torch.equal(fp.pow_const(F, x[:n], bits), want[:n]), n
    window = cuda_lib.function("gl_pow_const_window")
    for label, e in list(pow_edge_exponents().items()) + [
            ("legendre", bits), ("sqrt", F.sqrt_exp_bits)]:
        b = np.ascontiguousarray(e, dtype=np.uint8)
        muls = ctypes.c_int()
        w = window(b.ctypes.data, b.size, ctypes.byref(muls))
        want_w, _ = fp.pow_window(e)
        assert (w, muls.value) == (want_w, fp.pow_window_muls(e, want_w))
        assert torch.equal(fp.pow_const(F, x[:64], e),
                           fp.pow_const_plain(F, x[:64], e)), label


@pytest.mark.parametrize("name", ["mnt4753", "mnt6753"])
def test_poseidon_permute_at_block_edges(cuda, name):
    """K9 against permute_plain (full round counts) for each S the launcher
    can pick: batches of whole blocks plus 1, S - 1, S, S + 1 and 3 S + 1
    sponges past a width where the launcher takes S, and one sponge; zero
    S-box inputs (after the first round's constants) at every leaf of a
    block's tree, leaf j in block j, and one block all zero."""
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import poseidon_kernels as PK
    from gingerlib_tpu_torch.primitives.poseidon import PoseidonParams
    P = getattr(PoseidonParams, name)(cuda)
    F, nd = P.field, P.field.n_digits
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    neg = fp.neg_mod(F, P.rc[0])
    for S in (1, 2, 4, 8, 16, 32, 64):
        base = next(n for n in range(S, 1 << 20, S)
                    if PK.block_sponges(n, sms) == S)
        for n in [1] + [base + d for d in (1, S - 1, S, S + 1, 3 * S + 1)]:
            if PK.block_sponges(n, sms) != S and n != 1:
                continue
            assert PK.block_sponges_cuda(n) == PK.block_sponges(n, sms)
            vals = rand_below(F.modulus, 3 * n, seed=n)
            state = fp.to_mont(F, torch.from_numpy(fp.fp_from_ints(
                F, vals)).to(cuda)).reshape(n, 3, nd)
            blocks = -(-n // S)
            for b in range(blocks):
                leaf = b % (3 * S)
                q = b * S + leaf // 3
                if q < n:
                    state[q, leaf % 3] = neg[leaf % 3]
            if blocks > 2:
                state[S:min(2 * S, n)] = neg
            assert torch.equal(PK.permute(P, state),
                               PK.permute_plain(P, state)), (S, n)


@pytest.mark.parametrize("name", ["MNT4753_FQ", "BLS12_377_FQ",
                                  "BLS12_377_FR", "SW6_FQ", "MNT6298_FQ"])
def test_inv_bea_on_the_hardest_inputs(cuda, name):
    """K2 at 48, 24, 16, 49 and 19 digits on the inputs of the host test of its
    inversion (2^k for every k, runs of ones, the inputs that take the most
    passes or negate a row): against python's pow, and on a few against
    the plain version."""
    from gingerlib_tpu_torch import params as TP
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import limbs
    F = getattr(TP, name)
    cases = inv_inputs(F.modulus, F.name)
    vals = [v for kind in cases.values() for v in kind]
    x = torch.from_numpy(limbs.to_digits_batch(vals, F.n_digits)).to(cuda)
    got = fp.inv_bea(F, x)
    assert limbs.from_digits_batch(got.cpu()) == [
        pow(v, -1, F.modulus) if v else 0 for v in vals]
    few = x[:len(cases["random"]) + len(cases["edges"])]
    assert torch.equal(fp.inv_bea(F, few), fp.inv_bea_plain(F, few))


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


# ---------------------------------------------------------------------------
# K7 and K8 on tiles of 16 elements, inner products on the tensor cores
# ---------------------------------------------------------------------------

RNS_EDGES = [1, 15, 16, 17, 127, 128, 129, 1 << 15]


@pytest.mark.parametrize("name", ["MNT4753_FQ", "BLS12_377_FQ"])
def test_rns_mont_at_tile_edges(cuda, name):
    """K7 against its plain version on 1 .. 2^15 elements around the tile
    of 16: dense, strided, one row against all, the tree's paired
    down-sweep, and rows with every residue at m_i - 1."""
    import numpy as np
    from gingerlib_tpu_torch import params as TP
    from gingerlib_tpu_torch.ops import rns, rns_kernels as RK
    p = getattr(TP, name).modulus
    ctx = rns.make_context(p)
    vals = [0, 1, p - 1] + [pow(7, k, p) for k in range(1, 126)]
    base = RK.pack_rns(ctx, *rns.to_rns(ctx, vals, cuda))
    m = torch.from_numpy(RK.kernel_consts(p)[:RK.LANES].astype(np.int64))
    base[5] = torch.where(m > 1, m - 1, 0).to(torch.int32).to(cuda)
    base[6] = base[5]
    for n in RNS_EDGES:
        x = base.repeat(-(-n // base.shape[0]), 1)[:n]
        y = x.roll(3, 0)
        wide = torch.zeros((n, 2 * RK.LANES), dtype=torch.int32,
                           device=cuda)
        wide[:, RK.LANES:] = y
        for a, b in ((x, y), (x, y[:1]), (x, wide[:, RK.LANES:])):
            assert torch.equal(RK.mont_mul_rns(p, a, b),
                               RK.mont_mul_rns_plain(p, a, b)), n
        if n % 2 == 0:
            par = y[:n // 2]
            assert torch.equal(RK.mont_mul_rns_down(p, par, x),
                               RK.mont_mul_rns_down_plain(p, par, x)), n


def test_rns_mont_chained_squarings_equal_pow(cuda):
    """Six squarings through K7 from x M_A: each equals the plain version
    and x^(2^i) M_A mod p below 3p."""
    from gingerlib_tpu_torch import params as TP
    from gingerlib_tpu_torch.ops import rns, rns_kernels as RK
    p = TP.MNT4753_FQ.modulus
    ctx = rns.make_context(p)
    vals = [1, p - 1] + [pow(3, k, p) for k in range(1, 40)]
    r2 = RK.pack_rns(ctx, *rns.to_rns(ctx, [ctx.MA * ctx.MA % p], cuda))
    cur = RK.mont_mul_rns(p, RK.pack_rns(ctx, *rns.to_rns(ctx, vals, cuda)),
                          r2)
    want = list(vals)
    for _ in range(6):
        nxt = RK.mont_mul_rns(p, cur, cur)
        assert torch.equal(nxt, RK.mont_mul_rns_plain(p, cur, cur))
        cur, want = nxt, [w * w % p for w in want]
        got = rns.from_rns(ctx, RK.unpack_rns(ctx, cur)[0])
        assert all(g < 3 * p for g in got)
        assert [g % p for g in got] == [w * ctx.MA % p for w in want]


@pytest.mark.parametrize("n", [1, 15, 16, 17, 127, 128, 129])
def test_rns_affine_kernels_at_tile_edges(rcurve, rpoints, n):
    """K8's pre and post against their plain versions on n lanes around
    the tile of 16, special lanes first (one lane: a doubling, then an
    ordinary pair), with the tree's inverses between them."""
    curve, points = rcurve, rpoints
    rns_curve = getattr(CI, curve.name)(ec_rns=True)
    aff = tuple(torch.cat([c] * -(-max(n, 9) // N))[:max(n, 9)]
                for c in points[1])
    a_pt, b_pt = affine_pairs(curve, aff)
    starts = [0, 8] if n == 1 else [0]
    for s in starts:
        (x1, y1), inf1 = ((c[s:s + n] for c in a_pt[0]), a_pt[1][s:s + n])
        (x2, y2), inf2 = ((c[s:s + n] for c in b_pt[0]), b_pt[1][s:s + n])
        pre = ER.ecr_pre(rns_curve, x1, y1, x2, y2, inf1, inf2)
        for got, want in zip(pre, ER.ecr_pre_plain(rns_curve, x1, y1, x2,
                                                   y2, inf1, inf2)):
            assert torch.equal(got, want)
        num, den, x1r, y1r, x2r, inf3, dead = pre
        dinv = ER.tree_inverse_rns(rns_curve, den, dead)
        assert torch.equal(dinv, ER.tree_inverse_rns(rns_curve, den, dead,
                                                     plain=True))
        args = (num, dinv, x1r, y1r, x2r, x1, y1, x2, y2, inf1, inf2, inf3)
        for got, want in zip(ER.ecr_post(rns_curve, *args),
                             ER.ecr_post_plain(rns_curve, *args)):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K1 (tiles staged through shared memory) and K4 (a group of threads a lane)
# ---------------------------------------------------------------------------

TILE = 128                      # elements a K1 block
# 48, 24, 16 digits, and the odd counts 49 and 19
FIELDS = ["MNT4753_FQ", "BLS12_377_FQ", "BLS12_377_FR", "SW6_FQ",
          "MNT6298_FQ"]


def _field(name):
    from gingerlib_tpu_torch import params as TP
    return getattr(TP, name)


def _digits(F, vals, device):
    from gingerlib_tpu_torch.ops import limbs
    return torch.from_numpy(limbs.to_digits_batch(vals, F.n_digits)).to(
        device)


def _carry_values(F):
    """Operands whose products and sums make runs of all-ones limbs: R - 1
    and p - 1 and their neighbours, all ones below a limb boundary."""
    p, R = F.modulus, 1 << (16 * F.n_digits)
    vals = [(R - 1) % p, p - 1, p - 2, R % p, 1, 2, (R - 1) // 3 % p]
    limbs = (F.n_digits + 1) // 2
    vals += [((1 << (32 * k)) - 1) % p for k in range(1, limbs)]
    vals += [(p - (1 << (32 * k))) % p for k in range(1, limbs)]
    return vals


@pytest.mark.parametrize("name", FIELDS)
def test_mont_mul_ragged_tiles_and_row_forms(cuda, name):
    """K1 on ragged tiles (1, T - 1, T + 1, 2^11 + 3 elements), a constant
    row (to_mont's R^2), a twiddle table repeated along the leading axes,
    an Fq2 component view (row stride 2 nd) and one operand in [p, R)."""
    from gingerlib_tpu_torch.fields import fp
    F = _field(name)
    nd, p, R = F.n_digits, F.modulus, 1 << (16 * F.n_digits)
    big = (1 << 11) + 3
    vals = [0, 1, p - 1] + rand_below(p, 2 * big, seed=71)
    a_all, b_all = _digits(F, vals[:big], cuda), _digits(F, vals[big:2 * big],
                                                         cuda)
    for n in (1, TILE - 1, TILE + 1, big):
        a, b = a_all[:n], b_all[:n]
        assert torch.equal(fp.mont_mul(F, a, b), fp.mont_mul_plain(F, a, b))
    r2 = F.tensor("r2_digits", cuda)
    assert torch.equal(fp.mont_mul(F, a_all, r2),
                       fp.mont_mul_plain(F, a_all, r2))
    assert torch.equal(fp.to_mont(F, a_all), fp.mont_mul_plain(F, a_all, r2))
    x = a_all[:2048].reshape(8, 256, nd)
    tw = b_all[:256]
    assert torch.equal(fp.mont_mul(F, x, tw), fp.mont_mul_plain(F, x, tw))
    q = a_all[:2 * 700].reshape(700, 2, nd)
    assert q[:, 1].stride(0) == 2 * nd
    assert torch.equal(fp.mont_mul(F, q[:, 1], q[:, 0]),
                       fp.mont_mul_plain(F, q[:, 1], q[:, 0]))
    wide = _digits(F, [R - 1, p] + rand_below(R, big - 2, seed=72), cuda)
    assert torch.equal(fp.mont_mul(F, wide, b_all),
                       fp.mont_mul_plain(F, wide, b_all))


@pytest.mark.parametrize("name", FIELDS)
def test_field_kernels_on_carry_runs(cuda, name):
    """K1 and add/sub/neg on every pair of the all-ones-run operands."""
    from gingerlib_tpu_torch.fields import fp
    F = _field(name)
    vals = _carry_values(F)
    a = _digits(F, [u for u in vals for _ in vals], cuda)
    b = _digits(F, [v for _ in vals for v in vals], cuda)
    assert torch.equal(fp.mont_mul(F, a, b), fp.mont_mul_plain(F, a, b))
    assert torch.equal(fp.add_mod(F, a, b), fp.add_mod_plain(F, a, b))
    assert torch.equal(fp.sub_mod(F, a, b), fp.sub_mod_plain(F, a, b))
    assert torch.equal(fp.neg_mod(F, a), fp.neg_mod_plain(F, a))


def _lanes(curve, proj, n):
    """(P, Q) on n lanes, the special lanes of proj_pairs first; points
    repeat beyond the fixture's N."""
    reps = -(-max(n, N) // N)
    P, Q = proj_pairs(curve, tuple(c.repeat(reps, *([1] * (c.dim() - 1)))
                                   for c in proj))
    return tuple(c[:n] for c in P), tuple(c[:n] for c in Q)


@pytest.mark.parametrize("n", [1, 3, 5, 9, 33, 16376])
def test_proj_add_lane_counts(curve, points, n):
    """K4 at 1, 3, G + 1 (5 at 24 digits, 9 at 48), 33 and 16,376 lanes,
    with lanes at infinity on either side, doublings, opposite points and
    y = 0 doublings among them."""
    P, Q = _lanes(curve, points[0], n)
    for got, want in zip(EK.proj_add(curve, P, Q),
                         EK.proj_add_plain(curve, P, Q)):
        assert torch.equal(got, want)


def test_proj_add_strided_broadcast_and_doubling(curve, points):
    """Even/odd halves (row stride 2 nd), a broadcast row (stride 0), and
    P + P equal to double(P)."""
    P, Q = proj_pairs(curve, points[0])
    even, odd = tuple(c[0::2] for c in P), tuple(c[1::2] for c in Q)
    for got, want in zip(EK.proj_add(curve, even, odd),
                         EK.proj_add_plain(curve, even, odd)):
        assert torch.equal(got, want)
    row = tuple(c[9:10].expand(N, *c.shape[1:]) for c in Q)
    for got, want in zip(EK.proj_add(curve, P, row),
                         EK.proj_add_plain(curve, P, row)):
        assert torch.equal(got, want)
    for got, want in zip(EK.proj_add(curve, P, P), curve.double(P)):
        assert torch.equal(got, want)


def test_proj_add_on_carry_runs(curve):
    """K4's group arithmetic on coordinates made of the all-ones-run
    operands (not points of the curve: the formulas run all the same),
    seeded combinations and the equal and opposite cases among them."""
    import random
    F = curve.fp
    vals = _carry_values(F)
    rng = random.Random(73)
    n = 256
    cols = [[rng.choice(vals) for _ in range(n)] for _ in range(6)]
    for k in range(0, n, 4):          # equal points, then opposite points
        cols[3][k], cols[4][k], cols[5][k] = cols[0][k], cols[1][k], cols[2][k]
        cols[3][k + 1], cols[5][k + 1] = cols[0][k + 1], cols[2][k + 1]
        cols[4][k + 1] = (F.modulus - cols[1][k + 1]) % F.modulus
    t = [_digits(F, c, curve.device).reshape(n, 1, -1) for c in cols]
    P, Q = tuple(t[:3]), tuple(t[3:])
    for got, want in zip(EK.proj_add(curve, P, Q),
                         EK.proj_add_plain(curve, P, Q)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the MNT4-753 pairing and verify_proof
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mnt4_pairing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the field kernels have no CPU form")
    return CI.mnt4753_pairing()


def test_fq4_on_the_kernels_matches_plain(mnt4_pairing):
    """Fq4 multiply, square, inverse, cyclotomic square and sparse line on
    the field kernels against the same calls on the CPU's plain versions."""
    F = mnt4_pairing.fqk
    P = mnt4_pairing.fp.modulus
    x = torch.from_numpy(np.stack([F.const(rand_below(P, 4, seed=s))
                                   for s in range(5)]))
    y = x.roll(1, 0)
    u = F.mul(F.frob(x, 2), F.inv(x))                 # unitary, on the CPU
    ops = {"mul": lambda x, y, u: F.mul(x, y),
           "sqr": lambda x, y, u: F.sqr(x),
           "inv": lambda x, y, u: F.inv(x),
           "frob1": lambda x, y, u: F.frob(x, 1),
           "cyclotomic_square": lambda x, y, u: F.cyclotomic_square(u),
           "mul_by_023": lambda x, y, u: F.mul_by_023(x, y[..., 0, :],
                                                      y[..., 2:, :])}
    for name, op in ops.items():
        got = op(x.cuda(), y.cuda(), u.cuda())
        assert torch.equal(got.cpu(), op(x, y, u)), name


def test_mnt4753_pairing_matches_anchor(mnt4_pairing):
    """The full pairing of the reference's anchor points on the card, each
    field operation a kernel launch, the final exponentiation's inversion
    one launch of the inverse."""
    from gingerlib_tpu_torch.fields import fp, towers as T
    E = mnt4_pairing
    pa, qb, gt = mnt4753_anchor()
    p, q = E.g1.affine_from_ints(*pa), E.g2.affine_from_ints(*qb)
    fp.reset_launch_counts()
    got = E.pairing_prepared(p, E.prepare_g2(q))
    assert T.ext_to_ints(E.fqk, got) == gt
    assert fp.launch_counts["inv_bea"] >= 1
    assert fp.launch_counts["mont_mul"] > 0


@pytest.fixture(scope="module")
def mnt4_proof(mnt4_pairing):
    """Setup and prove on the card, the 1-constraint circuit."""
    from gingerlib_tpu_torch.proofs import groth16
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
    eng = CI.mnt4753_engine()
    cs = one_constraint_circuit(eng.g1.scalar_field)
    toxic = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)
    params = groth16.generate_parameters(eng, cs, **toxic)
    proof = groth16.create_proof(eng, params, compile_r1cs(cs),
                                 cs.assignment(), r=31337, s=71717)
    return eng, params, proof, toxic


def test_setup_fills_alpha_g1_beta_g2(mnt4_proof):
    from gingerlib_tpu_torch.fields import fp
    eng, params, _, toxic = mnt4_proof
    assert fp.fp_to_ints(eng.fp, params.vk.alpha_g1_beta_g2) == \
        host_alpha_beta(toxic["alpha"], toxic["beta"])


@pytest.mark.parametrize("case", ["accepts", "wrong_input", "altered_c"])
def test_verify_proof_on_the_gpu(mnt4_proof, case):
    """verify_proof accepts the card's proof, and refuses it with another
    public input or with C + G1's generator (still a curve point)."""
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.proofs import groth16
    eng, params, proof, _ = mnt4_proof
    inputs = [77]
    if case == "wrong_input":
        inputs = [78]
    elif case == "altered_c":
        g1 = eng.g1
        proof = groth16.Proof(a=proof.a, b=proof.b, c=g1.to_affine(
            g1.add_mixed(g1.from_affine(*proof.c), g1.generator_affine)))
    fp.reset_launch_counts()
    assert groth16.verify_proof(eng, params.vk, proof, inputs) \
        is (case == "accepts")
    assert fp.launch_counts["mont_mul"] > 0 \
        and fp.launch_counts["inv_bea"] > 0


# ---------------------------------------------------------------------------
# MNT6-753: Fq3/Fq6 on the kernels, its pairing; GM17
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mnt6_pairing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the field kernels have no CPU form")
    return CI.mnt6753_pairing()


def test_fq3_fq6_on_the_kernels_match_plain(mnt6_pairing):
    """Fq3 and Fq6 multiply, square, inverse, Frobenius, the cyclotomic
    square and the sparse line ``mul_by_2345`` on the field kernels
    against the same calls on the CPU's plain versions."""
    F = mnt6_pairing.fqk
    P = mnt6_pairing.fp.modulus
    x = torch.from_numpy(np.stack([F.const(rand_below(P, 6, seed=s))
                                   for s in range(5)]))
    y = x.roll(1, 0)
    u = F.mul(F.frob(x, 3), F.inv(x))                 # unitary, on the CPU
    S = F.sf
    ops = {"fq3 mul": lambda x, y, u: S.mul(x[..., :3, :], y[..., 3:, :]),
           "fq3 inv": lambda x, y, u: S.inv(x[..., :3, :]),
           "mul": lambda x, y, u: F.mul(x, y),
           "sqr": lambda x, y, u: F.sqr(x),
           "inv": lambda x, y, u: F.inv(x),
           "frob1": lambda x, y, u: F.frob(x, 1),
           "cyclotomic_square": lambda x, y, u: F.cyclotomic_square(u),
           "mul_by_2345": lambda x, y, u: F.mul_by_2345(x, y[..., 0, :],
                                                        y[..., 3:, :])}
    for name, op in ops.items():
        got = op(x.cuda(), y.cuda(), u.cuda())
        assert torch.equal(got.cpu(), op(x, y, u)), name


def test_mnt6753_pairing_matches_anchor(mnt6_pairing):
    from gingerlib_tpu_torch.fields import fp, towers as T
    E = mnt6_pairing
    pa, qb, gt = mnt6753_anchor()
    p, q = E.g1.affine_from_ints(*pa), E.g2.affine_from_ints(*qb)
    fp.reset_launch_counts()
    got = E.pairing_prepared(p, E.prepare_g2(q))
    assert T.ext_to_ints(E.fqk, got) == gt
    assert fp.launch_counts["inv_bea"] >= 1


@pytest.mark.parametrize("family", ["mnt4753", "mnt6753"])
def test_gm17_on_the_gpu(family):
    """GM17 setup, prove and verify on the card over the 1-constraint
    circuit: the proof equals the closed-form oracle, a wrong input is
    refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the field kernels have no CPU form")
    from gingerlib_tpu_torch.proofs import gm17, gm17_host, groth16
    eng = getattr(CI, f"{family}_engine")()
    cs = one_constraint_circuit(eng.g1.scalar_field)
    toxic = dict(alpha=123, beta=456, t=314159)
    rand = dict(d1=11, d2=22, r=333)
    params = gm17.generate_parameters(eng, cs, **toxic)
    proof = gm17.create_proof(eng, params, gm17.compile_circuit(cs),
                              cs.assignment(), **rand)
    assert groth16.proof_to_ints(eng, proof) == \
        gm17_host.expected_gm17_proof(family, cs, **toxic, **rand)
    assert gm17.verify_proof(eng, params.vk, proof, [77])
    assert not gm17.verify_proof(eng, params.vk, proof, [78])


# ---------------------------------------------------------------------------
# the windowed fixed-base setup, the device QAP, the 2^20 FFT and the bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", ["g1", "g2"])
def test_windowed_query_matches_double_and_add_at_full_width(group):
    """Setup's table of MNT4-753's generator (w = 8, 95 windows) and the
    windowed query against the 768-step loop ``fixed_base_msm`` and
    ``to_affine``: 0, 1, 2, r - 1, r - 2, 2^752 and seeded full-width
    scalars; the table's entries against the loop's j 2^(8 i) G."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the curve kernels have no CPU form")
    from gingerlib_tpu_torch.ops import limbs
    from gingerlib_tpu_torch.proofs import groth16
    curve = getattr(CI, "mnt4753_" + group)()
    r = curve.scalar_field.modulus
    ks = [0, 1, 2, r - 1, r - 2, 1 << 752] + rand_below(r, 26, seed=5)
    sd = torch.from_numpy(limbs.to_digits_batch(ks, 48)).to(curve.device)
    table = groth16.setup_table(curve)
    (x, y), inf = tmsm.fixed_base_msm_windowed(curve, table, sd, 8, 753)
    wx, wy = curve.to_affine(tmsm.fixed_base_msm(
        curve, curve.generator_affine, sd))
    assert torch.equal(x, wx) and torch.equal(y, wy)
    assert inf.tolist() == [k == 0 for k in ks]
    (tx, ty), tinf = table
    picks = [(0, 0), (0, 1), (0, 255), (1, 3), (47, 128), (94, 255)]
    tk = torch.from_numpy(limbs.to_digits_batch(
        [j << (8 * i) for i, j in picks], 48)).to(curve.device)
    lx, ly = curve.to_affine(tmsm.fixed_base_msm(
        curve, curve.generator_affine, tk))
    for n, (i, j) in enumerate(picks):
        assert bool(tinf[i, j]) is (j == 0)
        assert torch.equal(tx[i, j], lx[n]) and torch.equal(ty[i, j], ly[n])


def test_dense_row_circuit_proves_on_the_gpu():
    """BLS12-377: a row of 14 largest residues, one more than a lazy
    reduction takes, through setup and prove on the card: the proof equals
    the closed-form oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gingerlib_tpu_torch.proofs import groth16, groth16_host
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
    eng = CI.bls12_377_engine()
    cs = dense_row_circuit(eng.g1.scalar_field, 14)
    toxic = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)
    params = groth16.generate_parameters(eng, cs, **toxic)
    proof = groth16.create_proof(eng, params, compile_r1cs(cs),
                                 cs.assignment(), r=31337, s=71717)
    assert groth16.proof_to_ints(eng, proof) == groth16_host.expected_proof(
        "bls12_377", cs, **toxic, r=31337, s=71717)


def test_device_qap_matches_host_oracle_at_2p10():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gingerlib_tpu_torch.circuits import benchmark_circuit
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.proofs import groth16, groth16_host
    fr = CI.mnt4753_g1().scalar_field
    cs, _ = benchmark_circuit(fr, 4, 1 << 10)
    got = groth16.qap_at_device(cs, 314159)
    want = groth16_host.qap_at(cs, 314159)
    assert (got[3], got[4].size) == want[3:]
    for g, w in zip(got[:3], want[:3]):
        assert g.is_cuda and fp.fp_to_ints(fr, g) == w


def test_fft_roundtrip_at_2p18():
    """The radix-2 domain of MNT4-753's Fr at 2^18 (the 2^20 round trip is
    chip_smoke.py's ``fft`` line): ifft(fft(x)) == x, and two evaluations
    equal Horner's rule in python ints."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops.fft import Domain
    fr = CI.mnt4753_g1().scalar_field
    n = 1 << 18
    dom = Domain(fr, n)
    raw = torch.randint(0, 1 << 16, (n, 48), dtype=torch.int64,
                        generator=torch.Generator().manual_seed(18))
    raw[:, -1] = 0
    x = raw.cuda()
    y = dom.fft(x)
    assert torch.equal(dom.ifft(y), x)
    coeffs = fp.fp_to_ints(fr, x)
    for i in (0, 12345):
        w, acc = pow(dom.gen, i, fr.modulus), 0
        for c in reversed(coeffs):
            acc = (acc * w + c) % fr.modulus
        assert fp.fp_to_ints(fr, y[i:i + 1]) == [acc]


def test_proof_vk_and_params_bytes_round_trip(mnt4_proof):
    """The card's 1-constraint setup and proof through bytes: the proof
    and vk come back tensor for tensor and verify; the parameters prove
    the same proof."""
    from gingerlib_tpu_torch.proofs import groth16
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
    from gingerlib_tpu_torch.utils import serialize as S
    eng, params, proof, _ = mnt4_proof
    back, _ = S.proof_from_bytes(eng, S.proof_to_bytes(eng, proof))
    vk, _ = S.vk_from_bytes(eng, S.vk_to_bytes(eng, params.vk))
    assert groth16.verify_proof(eng, vk, back, [77])
    raw = S.params_to_bytes(eng, params)
    decoded, used = S.params_from_bytes(eng, raw)
    assert used == len(raw) and S.params_to_bytes(eng, decoded) == raw
    cs = one_constraint_circuit(eng.g1.scalar_field)
    again = groth16.create_proof(eng, decoded, compile_r1cs(cs),
                                 cs.assignment(), r=31337, s=71717)
    assert groth16.proof_to_ints(eng, again) \
        == groth16.proof_to_ints(eng, proof)


# ---------------------------------------------------------------------------
# one step of recursion
# ---------------------------------------------------------------------------

def test_recursion_inner_proof_through_the_bridge():
    """The recursion's inner proof of 7 * 11 = 77 made on the card (the
    toxic waste of tests/test_recursion.py) comes back through the bridge
    equal to ``HostGroth16``'s, and the verifier circuit built from the
    device's dicts, the statement's 753 bits public, has 61,407
    constraints and 754 inputs and is satisfied (~30 s on the host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the field kernels have no CPU form")
    from gingerlib_tpu_torch.circuits import (groth16_verifier_circuit,
                                              mul_circuit)
    from gingerlib_tpu_torch.proofs import groth16, groth16_host
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
    from gingerlib_tpu_torch.utils import convert
    eng = CI.mnt4753_engine()
    cs = mul_circuit(eng.g1.scalar_field, 7, 11)
    toxic = dict(alpha=1234, beta=5678, gamma=9101, delta=1121, t=31415)
    blind = dict(r=171717, s=282828)
    params = groth16.generate_parameters(eng, cs, **toxic)
    proof = groth16.create_proof(eng, params, compile_r1cs(cs),
                                 cs.assignment(), **blind)
    vk_host = convert.groth16_vk_to_host(eng, params.vk)
    proof_host = convert.proof_to_host(eng, proof)
    H = groth16_host.host_groth16_mnt4753()
    host_params = H.setup(cs, **toxic)
    assert vk_host == {k: host_params.vk[k] for k in vk_host}
    assert proof_host == H.prove(cs, host_params, **blind)
    outer = groth16_verifier_circuit(vk_host, proof_host, [77])
    assert (outer.num_constraints, outer.num_inputs) == (61407, 754)
    assert outer.which_is_unsatisfied() is None


@pytest.mark.parametrize("n", [1 << 20, 1 << 21])
def test_affine_kernels_at_the_outer_proofs_widths(n):
    """K5 (pre, post) and K6 (up, tail, down) on MNT6-753 G1 against their
    plain versions at the widest batches the recursion's outer GM17 proof
    launched (2^20 and 2^21 lanes, its C MSM's first tree levels:
    ``chip_smoke.py``'s ``recursion`` line): 64 distinct points with the
    special lanes first, repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the curve kernels have no CPU form")
    curve = CI.mnt6753_g1()
    k = torch.randint(1, 1 << 16, (N, 1), dtype=torch.int64,
                      generator=torch.Generator().manual_seed(21))
    aff = curve.to_affine(curve.mul_scalar_digits(curve.generator((N,)),
                                                  k.to(curve.device)))
    reps = n // N
    a_pt, b_pt = (((x.repeat(reps, 1, 1), y.repeat(reps, 1, 1)),
                   inf.repeat(reps))
                  for (x, y), inf in affine_pairs(curve, aff))
    (gx, gy), ginf = EK.batch_affine_add(curve, a_pt, b_pt)
    (wx, wy), winf = EK.batch_affine_add_plain(curve, a_pt, b_pt)
    assert torch.equal(gx, wx) and torch.equal(gy, wy) \
        and torch.equal(ginf, winf)


# ---------------------------------------------------------------------------
# BLS12-377 and BLS12-381: the Fq12 tower, the pairing, Groth16 and GM17
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["bls12_377", "bls12_381"])
def bls12_pairing(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the field kernels have no CPU form")
    return getattr(CI, f"{request.param}_pairing")()


def test_fq6_fq12_on_the_kernels_match_plain(bls12_pairing):
    """Fq6 and Fq12 multiply, inverse, Frobenius (Fq2 coefficients), the
    Granger-Scott square and the curve's line shape on the field kernels
    against the same calls on the CPU's plain versions."""
    E = bls12_pairing
    F, P = E.fqk, E.fp.modulus
    x = torch.from_numpy(np.stack([F.const(rand_below(P, 12, seed=s))
                                   for s in range(5)]))
    y = x.roll(1, 0)
    r = F.mul(F.conjugate(x), F.inv(x))               # on the CPU
    u = F.mul(F.frob(r, 2), r)                        # cyclotomic
    S = F.sf
    line = F.mul_by_014 if E.twist_type == "M" else F.mul_by_034
    ops = {"fq6 mul": lambda x, y, u: S.mul(x[..., :6, :], y[..., 6:, :]),
           "fq6 inv": lambda x, y, u: S.inv(x[..., :6, :]),
           "mul": lambda x, y, u: F.mul(x, y),
           "inv": lambda x, y, u: F.inv(x),
           "frob1": lambda x, y, u: F.frob(x, 1),
           "frob3": lambda x, y, u: F.frob(x, 3),
           "cyclotomic_square": lambda x, y, u: F.cyclotomic_square(u),
           "line": lambda x, y, u: line(x, y[..., :2, :], y[..., 2:4, :],
                                        y[..., 8:10, :])}
    for name, op in ops.items():
        got = op(x.cuda(), y.cuda(), u.cuda())
        assert torch.equal(got.cpu(), op(x, y, u)), name


def test_bls12_pairing_matches_host_oracle(bls12_pairing):
    """e(2P, 3Q) on the card against HostBls12Pairing; its r-th power is
    one."""
    from gingerlib_tpu_torch.curves import pairing_host
    from gingerlib_tpu_torch.fields import fp, towers as T
    from gingerlib_tpu_torch.ops import limbs
    from gingerlib_tpu_torch.proofs.groth16_host import host_curves
    E = bls12_pairing
    g1, g2, fr = host_curves(E.name)
    p2, q3 = g1.mul(g1.gen, 2), g2.mul(g2.gen, 3)
    fp.reset_launch_counts()
    gt = E.pairing(E.g1.affine_from_ints(*p2), E.g2.affine_from_ints(*q3))
    assert fp.launch_counts["inv_bea"] >= 1
    H = getattr(pairing_host, f"host_{E.name}_pairing")()
    assert T.ext_to_ints(E.fqk, gt) == H.pairing(p2, q3)
    r = fr.modulus
    assert torch.equal(T.ext_pow_const(E.fqk, gt, limbs.bits_msb_first(
        r, r.bit_length())), E.fqk.tensor("one", gt.device))


@pytest.mark.parametrize("family", ["bls12_377", "bls12_381"])
def test_bls12_groth16_and_gm17_on_the_gpu(family):
    """Groth16 and GM17 over the 1-constraint circuit on the card: setup's
    GT is the host oracle's, each proof the closed-form one, verify
    accepts it and refuses a wrong input."""
    _groth16_and_gm17_on_the_gpu(family)


def test_mnt6298_groth16_and_gm17_on_the_gpu():
    """The same over MNT6-298 (19 digits: G1, G2 over Fq3, GT in Fq6 and Fr
    all at the odd width)."""
    _groth16_and_gm17_on_the_gpu("mnt6298")


def _groth16_and_gm17_on_the_gpu(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the field kernels have no CPU form")
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.proofs import gm17, gm17_host, groth16, \
        groth16_host
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
    eng = getattr(CI, f"{family}_engine")()
    cs = one_constraint_circuit(eng.g1.scalar_field)
    inputs = cs.input_values[1:]
    wrong = [inputs[0] + 1] + inputs[1:]
    toxic = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)
    params = groth16.generate_parameters(eng, cs, **toxic)
    assert fp.fp_to_ints(eng.fp, params.vk.alpha_g1_beta_g2) == \
        host_alpha_beta(123, 456, family)
    proof = groth16.create_proof(eng, params, compile_r1cs(cs),
                                 cs.assignment(), r=31337, s=71717)
    assert groth16.proof_to_ints(eng, proof) == groth16_host.expected_proof(
        family, cs, **toxic, r=31337, s=71717)
    assert groth16.verify_proof(eng, params.vk, proof, inputs)
    assert not groth16.verify_proof(eng, params.vk, proof, wrong)
    g_toxic, rand = dict(alpha=123, beta=456, t=314159), dict(d1=11, d2=22,
                                                              r=333)
    params = gm17.generate_parameters(eng, cs, **g_toxic)
    proof = gm17.create_proof(eng, params, gm17.compile_circuit(cs),
                              cs.assignment(), **rand)
    assert groth16.proof_to_ints(eng, proof) == \
        gm17_host.expected_gm17_proof(family, cs, **g_toxic, **rand)
    assert gm17.verify_proof(eng, params.vk, proof, inputs)
    assert not gm17.verify_proof(eng, params.vk, proof, wrong)


# ---------------------------------------------------------------------------
# SW6 and MNT6-298 (49 and 19 digits): the pairings and the golden bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["mnt6298", "sw6"])
def test_odd_width_pairings_on_the_gpu(family):
    """e(G1, G2) on the card against the python-int oracle (and SW6's
    against the pinned GT of the reference's 782-bit loop); GT^r = 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the field kernels have no CPU form")
    from gingerlib_tpu_torch.curves import pairing_host
    from gingerlib_tpu_torch.fields import fp, towers as T
    from gingerlib_tpu_torch.ops import limbs
    from gingerlib_tpu_torch.proofs.groth16_host import host_curves
    from test_torch_cases import SW6_GT_G1G2
    E = getattr(CI, f"{family}_pairing")()
    g1, g2, fr = host_curves(family)
    fp.reset_launch_counts()
    gt = E.pairing(E.g1.generator_affine, E.g2.generator_affine)
    assert fp.launch_digits["mont_mul"].get(E.fp.n_digits, 0) > 0
    want = getattr(pairing_host, f"host_{family}_pairing")().pairing(
        g1.gen, g2.gen)
    assert T.ext_to_ints(E.fqk, gt) == want
    if family == "sw6":
        assert want == SW6_GT_G1G2
    r = fr.modulus
    assert torch.equal(T.ext_pow_const(E.fqk, gt, limbs.bits_msb_first(
        r, r.bit_length())), E.fqk.tensor("one", gt.device))


def test_mnt6298_golden_proof_bytes_on_the_gpu():
    """A = [2]G1, B = G2, C = G1 over MNT6-298 as CUDA tensors, written as
    the hand-derived bytes and read back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gingerlib_tpu_torch.proofs import groth16
    from gingerlib_tpu_torch.utils import serialize
    from test_torch_cases import GOLDEN_MNT6298_PROOF, mnt6298_golden_points
    eng = CI.mnt6298_engine()
    a, b, c = mnt6298_golden_points()
    proof = groth16.Proof(a=eng.g1.affine_from_ints(*a),
                          b=eng.g2.affine_from_ints(*b),
                          c=eng.g1.affine_from_ints(*c))
    raw = serialize.proof_to_bytes(eng, proof)
    assert raw == bytes.fromhex(GOLDEN_MNT6298_PROOF)
    back, used = serialize.proof_from_bytes(eng, raw)
    assert used == len(raw)
    assert groth16.proof_to_ints(eng, back) == {"a": a, "b": b, "c": c}


# ---------------------------------------------------------------------------
# the twisted-Edwards curves, Pedersen and the signatures (the 16-digit rows)
# ---------------------------------------------------------------------------

def _te_host_mul(gg, P, k):
    """[k] P in python ints through the TE gadget's host helpers."""
    acc = (0, 1)
    for bit in bin(k)[2:]:
        acc = gg._host_double(acc)
        if bit == "1":
            acc = gg._host_add(acc, P)
    return acc


@pytest.mark.parametrize("name", ["jubjub", "edwards_bls12", "edwards_sw6"])
def test_te_group_laws_on_the_gpu(name):
    """64 seeded multiples as lanes of one loop, four against python ints;
    dbl = add, associativity, P + (-P) = 0, P + 0 = P; [r] G = 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the field kernels have no CPU form")
    import random
    from gingerlib_tpu_torch.curves import points
    from gingerlib_tpu_torch.gadgets.std.te_groups import TEGroupGadget
    from gingerlib_tpu_torch.curves.points import affine_ints
    te = getattr(CI, name)()
    gg = TEGroupGadget.for_curve(te)
    r = te.scalar_field.modulus
    rng = random.Random(64)
    ks = [rng.randrange(1, r) for _ in range(64)]
    P = points.mul_ints(te, te.generator(()), ks)
    Q, R = (tuple(c.roll(s, 0) for c in P) for s in (1, 2))
    assert list(zip(*affine_ints(te, tuple(c[:4] for c in P)))) == \
        [_te_host_mul(gg, te.generator_host, k) for k in ks[:4]]
    assert bool(te.eq(te.double(P), te.add(P, P)).all())
    assert bool(te.eq(te.add(te.add(P, Q), R),
                      te.add(P, te.add(Q, R))).all())
    assert bool(te.is_zero(te.add(P, te.neg(P))).all())
    assert bool(te.eq(te.add(P, te.zero((64,))), P).all())
    assert bool(te.is_zero(points.mul_ints(te, te.generator(()), [r])).all())


def test_pedersen_and_bowe_hopwood_on_the_gpu():
    """Pedersen over Edwards-BLS12 at window 4 x 8: the seeded setup's
    generators, an evaluation and a commitment against python ints; the
    Bowe-Hopwood hash over MNT6-753 G1 (2 x 2) of a short input against
    ``BoweHopwoodHost``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the field kernels have no CPU form")
    import random
    from gingerlib_tpu_torch.gadgets.std.te_groups import TEGroupGadget
    from gingerlib_tpu_torch.primitives.commitment import PedersenCommitment
    from gingerlib_tpu_torch.primitives.group_hash_host import \
        mnt6753_g1_group_hash
    from gingerlib_tpu_torch.curves.points import affine_host
    from gingerlib_tpu_torch.primitives.pedersen import (BoweHopwoodCRH,
                                                         PedersenWindow)
    te = CI.edwards_bls12()
    gg = TEGroupGadget.for_curve(te)
    r = te.scalar_field.modulus
    comm = PedersenCommitment(te, PedersenWindow(4, 8)).setup(
        random.Random(7))
    rng = random.Random(7)
    gens = [_te_host_mul(gg, te.generator_host, rng.randrange(1, r))
            for _ in range(9)]
    assert comm.crh.generators_host == gens[:8]
    assert comm.rand_base_host == gens[8]
    data, rnd = b"m!\x05", 123456789
    bits = [(b >> i) & 1 for b in data for i in range(8)]
    want = (0, 1)
    for w in range(8):
        m = sum(b << i for i, b in enumerate(bits[4 * w:4 * w + 4]))
        want = gg._host_add(want, _te_host_mul(gg, gens[w], m))
    assert affine_host(te, comm.crh.evaluate(data)) == want
    assert affine_host(te, comm.commit(data, rnd)) == gg._host_add(
        want, _te_host_mul(gg, gens[8], rnd))
    g6 = CI.mnt6753_g1()
    host = mnt6753_g1_group_hash(2, 2).setup(random.Random(3))
    bh = BoweHopwoodCRH(g6, PedersenWindow(2, 2)).setup(random.Random(3))
    for bits in ([1, 1, 0, 1], [1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1, 0]):
        x, y = affine_host(g6, bh.evaluate_bits(bits))
        assert ([x], [y]) == tuple(host.evaluate_bits(bits))


def test_schnorr_and_vrf_on_the_gpu():
    """Schnorr (the JAX test's seed) and the VRF (its seed, the 64 x 4
    group hash) on the card against ``HostSchnorr`` and ``HostVrf``; verify
    refuses message + 1, proof_to_hash a wrong message."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the field kernels have no CPU form")
    import random
    from gingerlib_tpu_torch.primitives.group_hash_host import \
        mnt6753_g1_group_hash
    from gingerlib_tpu_torch.curves.points import affine_host
    from gingerlib_tpu_torch.primitives.pedersen import (BoweHopwoodCRH,
                                                         PedersenWindow)
    from gingerlib_tpu_torch.primitives.poseidon import (PoseidonHash,
                                                         PoseidonParams)
    from gingerlib_tpu_torch.primitives.schnorr import FieldBasedSchnorr
    from gingerlib_tpu_torch.primitives.signatures_host import (HostSchnorr,
                                                                HostVrf)
    from gingerlib_tpu_torch.primitives.vrf import FieldBasedEcVrf
    g6 = CI.mnt6753_g1()
    h = PoseidonHash(PoseidonParams.mnt4753())
    hs, rng_h = HostSchnorr(), random.Random(1231275789)
    pk_h, sk_h = hs.keygen(rng_h)
    sig_h = hs.sign(pk_h, sk_h, [424242], rng_h)
    sch, rng = FieldBasedSchnorr(g6, h), random.Random(1231275789)
    pk, sk = sch.keygen(rng)
    sig = sch.sign(pk, sk, [424242], rng)
    x, y = affine_host(g6, pk)
    assert ([x], [y]) == pk_h and (sig.e, sig.s) == sig_h
    assert sch.verify(pk, [424242], sig)
    assert not sch.verify(pk, [424243], sig)
    assert sch.keyverify(pk)
    rng_h, rng = random.Random(9174123), random.Random(9174123)
    hv = HostVrf(mnt6753_g1_group_hash(64, 4).setup(rng_h))
    vrf = FieldBasedEcVrf(g6, h, BoweHopwoodCRH(g6, PedersenWindow(
        64, 4)).setup(rng))
    vpk_h, vsk_h = hv.keygen(rng_h)
    proof_h = hv.prove(vpk_h, vsk_h, [987654321], rng_h)
    vpk, vsk = vrf.keygen(rng)
    proof = vrf.prove(vpk, vsk, [987654321], rng)
    assert (([proof.gamma[0]], [proof.gamma[1]]), proof.c, proof.s) == \
        proof_h
    assert vrf.proof_to_hash(vpk, [987654321], proof) == \
        hv.proof_to_hash(vpk_h, [987654321], proof_h)
    with pytest.raises(ValueError):
        vrf.proof_to_hash(vpk, [987654322], proof)


@pytest.mark.parametrize("name", ["JUBJUB_FQ", "BLS12_377_FR"])
def test_field_kernels_at_16_digits(cuda, name):
    """K1, add/sub/neg and K2 at 16 digits at the twisted-Edwards layouts:
    a formula's stacked products [4, 1024, 1, 16], the curve constant
    broadcast against them, a strided coordinate view, one element's
    inverse."""
    from gingerlib_tpu_torch.fields import fp
    F = _field(name)
    nd, p = F.n_digits, F.modulus
    vals = [0, 1, p - 1] + rand_below(p, 2 * 4096 - 3, seed=16)
    a = _digits(F, vals[:4096], cuda).reshape(4, 1024, 1, nd)
    b = _digits(F, vals[4096:], cuda).reshape(4, 1024, 1, nd)
    d = a[0, 7]
    for x, y in ((a, b), (d, b), (a[:, ::2], b[:, 1::2])):
        assert torch.equal(fp.mont_mul(F, x, y), fp.mont_mul_plain(F, x, y))
        assert torch.equal(fp.add_mod(F, x, y), fp.add_mod_plain(F, x, y))
        assert torch.equal(fp.sub_mod(F, x, y), fp.sub_mod_plain(F, x, y))
    x = a[:, ::3]
    assert torch.equal(fp.neg_mod(F, x), fp.neg_mod_plain(F, x))
    one = a[1, 5, 0][None]
    assert torch.equal(fp.inv_bea(F, one), fp.inv_bea_plain(F, one))
