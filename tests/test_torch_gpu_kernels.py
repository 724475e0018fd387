"""The port's field, curve, pow-chain, Poseidon and RNS kernels against their
plain PyTorch versions, under pytest, on a machine with an NVIDIA GPU:

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
from test_torch_cases import (affine_pairs, inv_inputs, poseidon_states,
                              pow_edge_exponents, proj_pairs, rand_below,
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
        assert torch.equal(EK.unpack_limbs(tree), want_tree)
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
                                  "BLS12_377_FR"])
def test_inv_bea_on_the_hardest_inputs(cuda, name):
    """K2 at 48, 24 and 16 digits on the inputs of the host test of its
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
def test_rns_affine_kernels_at_tile_edges(curve, points, n):
    """K8's pre and post against their plain versions on n lanes around
    the tile of 16, special lanes first (one lane: a doubling, then an
    ordinary pair), with the tree's inverses between them."""
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
FIELDS = ["MNT4753_FQ", "BLS12_377_FQ", "BLS12_377_FR"]   # 48, 24, 16 digits


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
    vals += [((1 << (32 * k)) - 1) % p for k in range(1, F.n_digits // 2)]
    vals += [(p - (1 << (32 * k))) % p for k in range(1, F.n_digits // 2)]
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
