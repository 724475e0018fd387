"""Port: what a tile of the RNS kernels computes (csrc/rns_core.cuh, K7 and
K8), as a numpy model, against the vectorized model of
gingerlib_tpu_torch/ops/rns.py, on ``device="cpu"``.

The model takes the constant blocks as the kernels take them
(``rns_kernels.kernel_consts``, ``ec_rns`` ``kernel_block``), reads the
tensor cores' B operands back out of fragment order by the layout of the
PTX ISA (independently of ``mma_fragments``), and computes each inner
product as the kernels do: byte planes, four u8 x u8 products summed in s32
(asserted to fit), recombined as 2^16 hh + 2^8 (hl + lh) + ll, then the
channel reduction by mu = floor(2^32 / m) and, for the CRT, the one-pass
carry with three borrow chains.  Held at tolerance 0 against
``_base_extend`` (both directions, both alpha estimates), ``to_rns_digits``
and ``from_rns_digits`` on MNT4-753 and BLS12-377 Fq, over every residue at
m_i - 1, all zeros, 0, 1 and p - 1, CRT inputs near 4p and 16p, and a
seeded batch.  Also: the inversion tree's paired down-sweep (one K7 launch
a level) against the two-call form, and the classes of widths that
chip_smoke.py reports the RNS kernels' launches in.
"""

import numpy as np
import pytest
import torch

from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.ops import ec_kernels as EK
from gingerlib_tpu_torch.ops import ec_rns as ER
from gingerlib_tpu_torch.ops import limbs as tlimbs
from gingerlib_tpu_torch.ops import rns as trns
from gingerlib_tpu_torch.ops import rns_kernels as RK
from test_torch_cases import from_fragments

torch.set_num_threads(1)
MASK32 = (1 << 32) - 1
ROWS = ("m", "mu", "sig", "w", "qsig", "pB", "mainv", "tsig", "ncorrAB",
        "ncorrBA", "p32")


def tile_product(a, b):
    """a [rows, K] x b [K, N], both below 2^16, as the tensor cores run it;
    K <= 64."""
    assert a.shape[1] <= 64 and a.min() >= 0 and b.min() >= 0
    assert a.max() < 1 << 16 and b.max() < 1 << 16
    al, ah, bl, bh = a & 0xFF, a >> 8, b & 0xFF, b >> 8
    ll, mid, hh = al @ bl, al @ bh + ah @ bl, ah @ bh
    assert max(ll.max(), mid.max(), hh.max()) < 1 << 31     # exact in s32
    return (hh << 16) + (mid << 8) + ll


def redl(v, m, mu):
    """v mod m up to one m, [0, 2m), for 32-bit v, as the kernels reduce:
    v - umulhi(v, mu) m."""
    v = np.asarray(v, np.uint64) & MASK32
    q = (v * np.asarray(mu, np.uint64)) >> np.uint64(32)
    return ((v - q * np.asarray(m, np.uint64)) & np.uint64(MASK32)).astype(
        np.int64)


def red(v, m, mu):
    """v mod m: redl, then one conditional subtract."""
    r = redl(v, m, mu)
    return np.where(r >= m, r - m, r)


def red64(v, rows, cols, lazy=False):
    """v < 2^46 mod the channels' moduli at the packed columns ``cols``
    (up to one m where ``lazy``)."""
    m, mu, p32 = (rows[r][cols] for r in ("m", "mu", "p32"))
    v = np.asarray(v, np.int64)
    r = redl(redl(v & MASK32, m, mu) + (v >> 32) * p32, m, mu)
    return r if lazy else np.where(r >= m, r - m, r)


class Field:
    def __init__(self, name):
        F = {"mnt4753": TP.MNT4753_FQ, "bls12_377": TP.BLS12_377_FQ}[name]
        self.p, self.nd = F.modulus, F.n_digits
        self.ctx = trns.make_context(self.p)
        block = RK.kernel_consts(self.p).astype(np.int64)
        assert RK.N_ROWS == len(ROWS)
        head = len(ROWS) * RK.LANES
        self.rows = dict(zip(ROWS, block[:head].reshape(len(ROWS), -1)))
        ext = block[head:].reshape(2, -1)
        self.ext = {"A": from_fragments(ext[0], 64, 64),
                    "B": from_fragments(ext[1], 64, 64)}
        curve = getattr(TCI, name + "_g1")("cpu", ec_rns=True)
        self.ec = ER.consts(curve)
        eb = self.ec.kernel_block().astype(np.int64)
        head = 5 * RK.LANES
        self.kp = eb[head:head + 192].reshape(3, 64)
        self.md = eb[head + 192:head + 256]
        d_words = 2 * 8 * 2 * 64
        self.D = from_fragments(eb[head + 256:head + 256 + d_words], 64, 64)
        self.P2 = from_fragments(eb[head + 256 + d_words:], 64, 128)

    def cols(self, base):
        k = self.ctx.k
        return np.arange(k) + (0 if base == "A" else RK.B_ROW)

    def residues(self, values):
        ra, rb = trns.to_rns(self.ctx, values, "cpu")
        return ra.numpy(), rb.numpy()


@pytest.fixture(scope="module", params=["bls12_377", "mnt4753"])
def field(request):
    return Field(request.param)


def edge_residues(F):
    """Residue rows of both bases: every residue at m_i - 1, all zeros, and
    those of 0, 1, p - 1 and a seeded batch."""
    k = F.ctx.k
    rng = np.random.default_rng(9)
    vals = [0, 1, F.p - 1] + [int.from_bytes(rng.bytes(100), "little") % F.p
                              for _ in range(13)]
    ra, rb = F.residues(vals)
    top_a = F.rows["m"][:k][None] - 1
    top_b = F.rows["m"][RK.B_ROW:RK.B_ROW + k][None] - 1
    zero = np.zeros((1, k), np.int64)
    return (np.concatenate([top_a, zero, ra]),
            np.concatenate([top_b, zero, rb]))


def extend_model(F, x, src, exact):
    """The base extension of the rows x [n, k] from base ``src``: sigmas,
    alpha from the weights, the tile product with the fragment-ordered
    matrix, the finish (acc + alpha (-|M_src|)) mod m in one 64-bit
    reduction."""
    rows, k = F.rows, F.ctx.k
    sc = F.cols(src)
    dc = F.cols("B" if src == "A" else "A")
    sigma = red(x * rows["sig"][sc], rows["m"][sc], rows["mu"][sc])
    t = (sigma * rows["w"][sc]).sum(-1) + (trns.ALPHA_OFF if exact else 0)
    assert t.max() < 1 << 32
    alpha = t >> trns.W_BITS
    a = np.zeros((x.shape[0], 64), np.int64)
    a[:, :k] = sigma
    acc = tile_product(a, F.ext[src])[:, :k]
    ncorr = rows["ncorrAB" if src == "A" else "ncorrBA"][dc]
    assert alpha.max() < 1 << 7
    return red64(acc + alpha[:, None] * ncorr, rows, dc)


def test_extension_model_equals_the_vectorized_model(field):
    ra, rb = edge_residues(field)
    for src, x in (("A", ra), ("B", rb)):
        for exact in (False, True):
            want = trns._base_extend(field.ctx, torch.from_numpy(x), src,
                                     exact).numpy()
            assert np.array_equal(extend_model(field, x, src, exact), want)


def mont_model(F, xa, xb, ya, yb):
    """The RNS multiply as the kernels run it: the folded constants
    (-p^-1 sigma on base A, M_A^-1 and M_A^-1 sigma on base B), the two
    extensions' products, one reduction of s + q p before M_A^-1, and
    residues left up to one m where they only feed a product."""
    rows, k = F.rows, F.ctx.k
    ca, cb = F.cols("A"), F.cols("B")
    full = lambda v, c: red(v, rows["m"][c], rows["mu"][c])
    lazy = lambda v, c: redl(v, rows["m"][c], rows["mu"][c])
    sg = full(lazy(xa * ya, ca) * rows["qsig"][ca], ca)
    sb = lazy(xb * yb, cb)
    qb = ext_sums(F, sg, "A", False, lazy=True)
    u = lazy(sb + qb * rows["pB"][cb], cb)
    assert u.max() < 2 * rows["m"][cb].max()
    tb = full(u * rows["mainv"][cb], cb)
    tg = full(u * rows["tsig"][cb], cb)
    return ext_sums(F, tg, "B", True), tb


def ext_sums(F, sigma, src, exact, lazy=False):
    """The extension from the sigmas themselves (what the multiply hands
    the tensor cores)."""
    rows, k = F.rows, F.ctx.k
    sc, dc = F.cols(src), F.cols("B" if src == "A" else "A")
    alpha = ((sigma * rows["w"][sc]).sum(-1)
             + (trns.ALPHA_OFF if exact else 0)) >> trns.W_BITS
    a = np.zeros((sigma.shape[0], 64), np.int64)
    a[:, :k] = sigma
    acc = tile_product(a, F.ext[src])[:, :k]
    ncorr = rows["ncorrAB" if src == "A" else "ncorrBA"][dc]
    return red64(acc + alpha[:, None] * ncorr, rows, dc, lazy)


def test_mont_model_equals_the_vectorized_model(field):
    ra, rb = edge_residues(field)
    ya, yb = np.roll(ra, 3, 0), np.roll(rb, 3, 0)
    want = trns.mont_mul_rns(field.ctx, (torch.from_numpy(ra),
                                         torch.from_numpy(rb)),
                             (torch.from_numpy(ya), torch.from_numpy(yb)))
    for got, w in zip(mont_model(field, ra, rb, ya, yb), want):
        assert np.array_equal(got, w.numpy())


def test_to_rns_model_equals_the_vectorized_model(field):
    F, nd, k = field, field.nd, field.ctx.k
    rng = np.random.default_rng(10)
    vals = [0, 1, F.p - 1, (1 << 16 * nd) - 1] + [
        int.from_bytes(rng.bytes(100), "little") % F.p for _ in range(12)]
    digits = tlimbs.to_digits_batch(vals, nd)
    a = np.zeros((len(vals), 64), np.int64)
    a[:, :nd] = digits
    acc = tile_product(a, F.P2)
    want_a, want_b = trns.to_rns_digits(F.ctx, torch.from_numpy(digits))
    assert np.array_equal(red64(acc[:, :k], F.rows, F.cols("A")),
                          want_a.numpy())
    assert np.array_equal(
        red64(acc[:, RK.B_ROW:RK.B_ROW + k], F.rows, F.cols("B")),
        want_b.numpy())


def crt_tail(col, kp, nd):
    """One row's digit columns -> digits: the carries of digits 0..nd beside
    three borrow chains (v - p, v - 2p, v - 3p), then v - k p for the
    largest k that does not borrow."""
    carry, borrow, dig = 0, [0, 0, 0], []
    for j in range(nd + 1):
        s = int(col[j]) + carry
        d, carry = s & 0xFFFF, s >> 16
        dig.append(d)
        for i in range(3):
            borrow[i] = int(d - int(kp[i][j]) - borrow[i] < 0)
    k = 3 - sum(borrow)
    if k:
        b = 0
        for j in range(nd):
            s = dig[j] - int(kp[k - 1][j]) - b
            b = int(s < 0)
            dig[j] = s + (b << 16)
    return dig[:nd]


def crt_model(F, ra):
    rows, k, sc = F.rows, F.ctx.k, F.cols("A")
    sigma = red(ra * rows["sig"][sc], rows["m"][sc], rows["mu"][sc])
    alpha = ((sigma * rows["w"][sc]).sum(-1) + trns.ALPHA_OFF) >> trns.W_BITS
    a = np.zeros((ra.shape[0], 64), np.int64)
    a[:, :k] = sigma
    cols = tile_product(a, F.D) - alpha[:, None] * F.md[None]
    return np.asarray([crt_tail(c, F.kp, F.nd) for c in cols], np.int64)


def test_crt_model_equals_the_vectorized_model(field):
    F, p = field, field.p
    rng = np.random.default_rng(11)
    vals = [0, 1, p - 1, p, 2 * p - 1, 2 * p, 3 * p - 1, 3 * p, 4 * p - 1,
            4 * p, 4 * p + 1, 16 * p - 1, 16 * p, 16 * p + 12345]
    vals += [int.from_bytes(rng.bytes(100), "little") % (3 * p)
             for _ in range(10)]
    ra, _ = F.residues(vals)
    ra_edge, _ = edge_residues(F)
    for x in (ra, ra_edge[:2]):
        want = trns.from_rns_digits(F.ctx, torch.from_numpy(x),
                                    tlimbs.to_digits(p, F.nd), F.nd)
        assert np.array_equal(crt_model(F, x), want.numpy())
    got = tlimbs.from_digits_batch(crt_model(F, ra))
    assert got[:9] == [v % p for v in vals[:9]]


def test_the_s32_sums_hold_64_terms():
    """A partial sum of the tile products has at most 64 terms of at most
    255 * 255: below 2^22, and the merged hl + lh below 2^23; the
    recombined sum of 64 products of two 16-bit values stays below 2^36."""
    assert 64 * 255 * 255 < 1 << 22 and 2 * 64 * 255 * 255 < 1 << 23
    full = np.full((1, 64), 0xFFFF, np.int64)
    assert tile_product(full, full.T)[0, 0] == 64 * 0xFFFF ** 2 < 1 << 38
    assert 64 * (1 << 14) * (1 << 16) <= 1 << 36


def test_kernel_block_of_the_curve_holds_its_tables(field):
    """The curve's block of csrc/ec_rns.cu: the digits of p, 2p, 3p and M_A,
    |2^16j|_m against the packed columns and the digits of M_A/m_i, exact
    and zero beyond their widths."""
    F, nd, k = field, field.nd, field.ctx.k
    for i in range(3):
        assert tlimbs.from_digits_batch(F.kp[i:i + 1])[0] == (i + 1) * F.p
        assert not F.kp[i, nd + 1:].any()
    D, MD = trns.crt_digit_matrices(F.ctx)
    w = F.ec.wdt
    assert np.array_equal(F.D[:k, :w], D) and not F.D[k:].any() \
        and not F.D[:, w:].any()
    assert np.array_equal(F.md[:w], MD) and not F.md[w:].any()
    P2 = trns.pos_rns_matrix(F.ctx, nd)
    assert np.array_equal(F.P2[:nd, :k], P2[:, :k])
    assert np.array_equal(F.P2[:nd, RK.B_ROW:RK.B_ROW + k], P2[:, k:])
    assert not F.P2[nd:].any() and not F.P2[:, k:RK.B_ROW].any() \
        and not F.P2[:, RK.B_ROW + k:].any()


def test_mma_fragments_refuses_what_the_product_cannot_take():
    with pytest.raises(ValueError):
        RK.mma_fragments(np.zeros((48, 8), np.int64))
    with pytest.raises(ValueError):
        RK.mma_fragments(np.full((32, 8), 1 << 16, np.int64))


# ---------------------------------------------------------------------------
# the inversion tree's down-sweep: one K7 launch a level
# ---------------------------------------------------------------------------

def two_call_tree(curve, den, dead):
    """The RNS tree as it ran with two K7 calls a down-sweep level: the
    parents times the right children, then times the left ones."""
    C = ER.consts(curve)
    p, nd, ctx = C.p, C.nd, C.ctx
    mul = RK.mont_mul_rns_plain
    n = den.shape[0]
    n_pad = max(RK.LANES, 1 << max(0, (n - 1).bit_length()))
    one = C.row("one_tree", den.device)
    x = torch.where(dead[:, None], one, den)
    x = torch.cat([x, one.expand(n_pad - n, RK.LANES)])
    levels = [x]
    while levels[-1].shape[0] > 1:
        levels.append(mul(p, levels[-1][0::2], levels[-1][1::2]))
    ra, _ = RK.unpack_rns(ctx, levels[-1])
    root = trns.from_rns_digits(ctx, ra, tlimbs.to_digits(p, nd), nd)
    inv_root = ER.fpmod.inv_mod(curve.fp, root)
    inv = mul(p, RK.pack_rns(ctx, *trns.to_rns_digits(ctx, inv_root)),
              C.row("c_root", den.device))
    for child in reversed(levels[:-1]):
        left, right = child[0::2], child[1::2]
        inv = torch.stack([mul(p, inv, right), mul(p, inv, left)],
                          dim=1).reshape(child.shape)
    return inv[:n].masked_fill(dead[:, None], 0)


@pytest.mark.parametrize("name", ["bls12_377", "mnt4753"])
def test_paired_down_sweep_equals_two_calls(name):
    """Non-power-of-two N with dead lanes, the first and last among them:
    the same residues as the two-call form, and inverses times
    denominators give M_A^2 in every live lane."""
    curve = getattr(TCI, name + "_g1")("cpu", ec_rns=True)
    C = ER.consts(curve)
    ctx, p = C.ctx, C.p
    rng = np.random.default_rng(12)
    vals = [int.from_bytes(rng.bytes(100), "little") % (p - 1) + 1
            for _ in range(13)]
    den = RK.pack_rns(ctx, *trns.to_rns(ctx, vals, "cpu"))
    dead = torch.zeros(13, dtype=torch.bool)
    dead[[0, 5, 12]] = True
    got = ER.tree_inverse_rns(curve, den, dead)
    assert torch.equal(got, two_call_tree(curve, den, dead))
    inv = trns.from_rns(ctx, RK.unpack_rns(ctx, got)[0])
    for v, i, off in zip(vals, inv, dead.tolist()):
        assert i == 0 if off else v * i % p == ctx.MA * ctx.MA % p


def test_down_sweep_multiply_pairs_parents_with_siblings():
    p = TP.BLS12_377_FQ.modulus
    ctx = trns.make_context(p)
    rows = RK.pack_rns(ctx, *trns.to_rns(ctx, list(range(3, 15)), "cpu"))
    parent, child = rows[:3], rows[3:9]
    got = RK.mont_mul_rns_down(p, parent, child)
    for e in range(6):
        assert torch.equal(got[e], RK.mont_mul_rns_plain(
            p, parent[e // 2:e // 2 + 1], child[e ^ 1:(e ^ 1) + 1])[0])
    with pytest.raises(ValueError, match="children"):
        RK.mont_mul_rns_down(p, parent, child[:5])
    with pytest.raises(ValueError, match="CUDA"):
        RK.mont_mul_rns_down_cuda(p, parent, child)


def test_rns_launch_width_classes():
    """chip_smoke.py's classes for K7 and K8: up to four tiles (the tree's
    narrow levels and roots), then octaves."""
    assert [EK.width_class("rns_mont", n) for n in (1, 16, 64, 65, 128,
                                                    1 << 18)] == [
        "1-2^6", "1-2^6", "1-2^6", "2^6-2^7", "2^6-2^7", "2^17-2^18"]
    assert EK.width_class("ecr_pre", 16376) == "2^13-2^14"
    assert EK.width_class("ecr_post", 8) == "1-2^6"
