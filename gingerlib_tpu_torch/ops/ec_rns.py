"""Batched affine addition with RNS multiplies: kernel K8 and its plain
version.

Counterpart of ``gingerlib_tpu/ops/pallas_ec_rns.py``: the contract of
``ec_kernels.batch_affine_add`` (positional Montgomery digits in and out,
canonical, flags ``[N]`` bool), with every field multiply in the double-base
RNS of ``ops/rns.py``.  Two kernels and a tree between them, each dispatched
on where its tensors live -- no fallback and no switch:

* ``ecr_pre`` -> ``csrc/ec_rns.cu``; replaces ``_ecr_pre_kernel``.  Flags from
  digit equality, the four coordinates into RNS at the scale M_A (one
  multiply by ``c_norm`` each), lambda's numerator and denominator.
* ``tree_inverse_rns``: the shared inversion of the denominators as an RNS
  product tree (up-sweep, root, down-sweep) whose multiplies are K7
  (``rns_kernels.mont_mul_rns``, the TPU's ``_ecr_tree_kernel``); dead
  lanes enter as ``one_tree``; the root is CRT'd to digits, inverted by
  ``fp.inv_mod`` (K2) and re-entered times ``c_root``; each down-sweep
  level is one K7 launch (``rns_kernels.mont_mul_rns_down``: each parent
  times the sibling of each of its children).
* ``ecr_post`` -> ``csrc/ec_rns.cu``; replaces ``_ecr_post_kernel``.  lambda,
  x3, y3 in RNS, exit by ``k_out``, CRT to canonical digits, the
  completeness selects.

Scale discipline (pallas_ec_rns.py:12-23): leaves d M_A; the root rho M_A
becomes rho^-1 R^2 through ``inv_mod`` and rho^-1 M_A after one multiply by
c_root = M_A^3 R^-2; every down-sweep multiply keeps node^-1 M_A.  The
tree pairs lanes ``0::2`` / ``1::2`` over a power-of-two pad of at least
128 lanes, as the JAX package does, so that its intermediate residues are
the JAX package's too.

Residues travel packed (``rns_kernels``: ``[N, 128]`` int32).  The kernels
take MNT4-753 (48 digits, 59 channels) and BLS12-377 G1 (24 digits) and
raise on any other width on a GPU; the plain versions take every width.
Launch counts: ``ecr_pre``, ``ecr_post`` in ``fields.fp.launch_counts``; the
tree's multiplies count under ``rns_mont``, its root under ``inv_bea`` and
``mont_mul``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields import fp as fpmod
from . import ec_kernels as EK
from . import rns
from . import rns_kernels as RK
from .limbs import DTYPE, to_digits

KERNEL_DIGITS = (24, 48)          # widths the K8 kernels are built for
_EC_ROWS = ("c_norm", "k_out", "a_rns", "p4", "p12")   # ec_rns.cu EcRow


def supports(curve) -> bool:
    """True where the RNS addition exists for ``curve``: a curve over the
    base field whose RNS context fits the packed layout (64 channels a
    base)."""
    return curve.F.K == 1 and \
        rns.make_context(curve.fp.modulus).k <= RK.B_ROW


class _Consts:
    """What the plain versions and the kernels of one curve take."""

    def __init__(self, curve):
        params = curve.fp
        p, nd = params.modulus, params.n_digits
        ctx = rns.make_context(p)
        R = params.r
        a_plain = fpmod.fp_to_int(params, curve.a.reshape(-1).cpu())
        self.ctx, self.p, self.nd, self.wdt = ctx, p, nd, rns.crt_width(ctx)
        self.rows = {name: RK.rns_row(ctx, v) for name, v in {
            "c_norm": ctx.MA * ctx.MA % p * pow(R, -1, p) % p,
            "c_root": pow(ctx.MA, 3, p) * pow(R, -2, p) % p,
            "k_out": R,
            "a_rns": a_plain * ctx.MA % p,
            "one_tree": ctx.MA % p,
            "p4": 4 * p,             # subtraction offsets: values, not mod p
            "p12": 12 * p,
        }.items()}
        self.rows["m"] = RK.kernel_consts(p)[:RK.LANES].astype(np.int32)
        self._tensors = {}

    def row(self, name, device):
        """The packed row ``name`` as a [1, 128] int32 tensor, cached."""
        key = (name, str(device))
        hit = self._tensors.get(key)
        if hit is None:
            hit = torch.from_numpy(self.rows[name]).to(device)[None]
            self._tensors[key] = hit
        return hit

    def kernel_block(self) -> np.ndarray:
        """The curve's block of ``csrc/ec_rns.cu`` (uint32): rows [5, 128],
        the digits of p, 2p and 3p [3, 64], the digits of M_A [64], then
        the digits of M_A/m_i [64, 64] and |2^16j|_m [64, 128] (digit j
        against the packed channel columns), both zero-padded and in
        fragment order (``rns_kernels.mma_fragments``)."""
        ctx, nd, k = self.ctx, self.nd, self.ctx.k
        if self.wdt > RK.KMAX:
            raise ValueError(f"CRT width {self.wdt} exceeds {RK.KMAX} "
                             f"digits")
        kp = np.zeros((3, 64), np.int64)
        for i in range(3):
            kp[i, :nd + 1] = to_digits((i + 1) * self.p, nd + 1)
        D, MD = rns.crt_digit_matrices(ctx)
        md = np.zeros(64, np.int64)
        md[:self.wdt] = MD
        P2 = rns.pos_rns_matrix(ctx, nd)
        p2 = np.zeros((RK.KMAX, RK.LANES), np.int64)
        p2[:nd, :k] = P2[:, :k]
        p2[:nd, RK.B_ROW:RK.B_ROW + k] = P2[:, k:]
        parts = [self.rows[name].astype(np.int64) for name in _EC_ROWS]
        parts += [kp.reshape(-1), md]
        head = np.concatenate(parts).astype(np.uint32)
        return np.concatenate([
            head, RK.mma_fragments(RK.pad_matrix(D, RK.KMAX, 64)).reshape(-1),
            RK.mma_fragments(p2).reshape(-1)])

    def device_block(self, device) -> torch.Tensor:
        key = ("block", str(device))
        hit = self._tensors.get(key)
        if hit is None:
            hit = torch.from_numpy(self.kernel_block().view(np.int32)).to(
                device)
            self._tensors[key] = hit
        return hit


def consts(curve) -> _Consts:
    """The RNS constants of ``curve``, made once and kept on the curve."""
    hit = curve.__dict__.get("_ec_rns_consts")
    if hit is None:
        hit = _Consts(curve)
        curve.__dict__["_ec_rns_consts"] = hit
    return hit


# ---------------------------------------------------------------------------
# channelwise helpers on packed residues (plain versions)
# ---------------------------------------------------------------------------

def _add(C, a, b):
    return (a + b) % C.row("m", a.device)


def _sub_off(C, a, off: str, b):
    """a + (c p - b): ``off`` names the row of c p >= value(b)."""
    m = C.row("m", a.device)
    return (a + (C.row(off, a.device) + m - b) % m) % m


# ---------------------------------------------------------------------------
# pre
# ---------------------------------------------------------------------------

def ecr_pre_plain(curve, x1, y1, x2, y2, inf1, inf2):
    """(num, den, x1r, y1r, x2r, inf3, dead): lambda's numerator and
    denominator and the first point's and second x in RNS at the scale
    M_A (packed [N, 128] int32), the flag of a result at infinity and of a
    lane kept out of the inversion tree ([N] bool)."""
    C = consts(curve)
    p, nd, ctx = C.p, C.nd, C.ctx
    n = x1.shape[0]
    X1, Y1, X2, Y2 = (v.reshape(n, nd) for v in (x1, y1, x2, y2))
    same_x = (X1 == X2).all(-1)          # canonical digits: direct equality
    same_y = (Y1 == Y2).all(-1)
    ninf = ~inf1 & ~inf2
    dbl = same_x & same_y & ninf
    anti = same_x & ~same_y & ninf
    inf3 = (inf1 & inf2) | anti | (dbl & (Y1 == 0).all(-1))
    dead = inf3 | inf1 | inf2
    cn = C.row("c_norm", x1.device)

    def conv(v):                          # value v R -> v M_A
        return RK.mont_mul_rns_plain(
            p, RK.pack_rns(ctx, *rns.to_rns_digits(ctx, v)), cn)

    x1r, y1r, x2r, y2r = (conv(v) for v in (X1, Y1, X2, Y2))
    dxr = _sub_off(C, x2r, "p4", x1r)                       # < 7p
    dyr = _sub_off(C, y2r, "p4", y1r)
    xx = RK.mont_mul_rns_plain(p, x1r, x1r)                 # < 3p
    t3 = _add(C, _add(C, xx, xx), xx)                       # < 9p
    txa = _add(C, t3, C.row("a_rns", x1.device))            # < 10p
    y1d = _add(C, y1r, y1r)                                 # < 6p
    sel = dbl[:, None]
    return (torch.where(sel, txa, dyr), torch.where(sel, y1d, dxr),
            x1r, y1r, x2r, inf3, dead)


def _check_widths(curve, what: str):
    EK._check_curve(curve, what)
    nd = curve.fp.n_digits
    if nd not in KERNEL_DIGITS:
        raise NotImplementedError(
            f"{what}: the RNS curve kernels are built for n_digits in "
            f"{KERNEL_DIGITS}, not {nd} ({curve.fp.name})")


def ecr_pre_cuda(curve, x1, y1, x2, y2, inf1, inf2):
    """Launch the pre kernel on CUDA coordinates [N, 1, nd] (or [N, nd]),
    possibly strided views."""
    _check_widths(curve, "ecr_pre")
    C = consts(curve)
    params = curve.fp
    n = x1.shape[0]
    ops = [EK._rows(params, t, n, "ecr_pre") for t in (x1, y1, x2, y2)]
    dev = EK._same_device([t for t, _ in ops], "ecr_pre")
    fl = [EK._flags(f, n, dev, "ecr_pre") for f in (inf1, inf2)]
    outs = [torch.empty((n, RK.LANES), dtype=RK.PACKED_DTYPE, device=dev)
            for _ in range(5)]
    inf3 = torch.empty(n, dtype=torch.bool, device=dev)
    dead = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return (*outs, inf3, dead)
    rc = fpmod._kernel("gl_ecr_pre")(
        C.ctx.k, C.nd, EK._ptrs([t for t, _ in ops]),
        EK._table(ctypes.c_longlong, [s for _, s in ops]),
        EK._ptrs([f for f, _ in fl]),
        EK._table(ctypes.c_longlong, [s for _, s in fl]),
        *(o.data_ptr() for o in outs), inf3.data_ptr(), dead.data_ptr(), n,
        RK.device_consts(C.p, dev).data_ptr(),
        C.device_block(dev).data_ptr(), fpmod._raw_stream(outs[0]))
    EK._launched(rc, "ecr_pre", "ecr_pre", n, C.nd)
    return (*outs, inf3, dead)


def ecr_pre(curve, x1, y1, x2, y2, inf1, inf2):
    if x1.is_cuda or x2.is_cuda:
        return ecr_pre_cuda(curve, x1, y1, x2, y2, inf1, inf2)
    return ecr_pre_plain(curve, x1, y1, x2, y2, inf1, inf2)


# ---------------------------------------------------------------------------
# post
# ---------------------------------------------------------------------------

def ecr_post_plain(curve, num, dinv, x1r, y1r, x2r, x1, y1, x2, y2, inf1,
                   inf2, inf3):
    """(x3, y3), canonical Montgomery digits in the coordinates' shape:
    lambda = num * dinv, the chord (or tangent) in RNS, the exit to digits,
    and the completeness selects; infinity comes out as (0, 0)."""
    C = consts(curve)
    p, nd, ctx = C.p, C.nd, C.ctx
    n = x1.shape[0]

    def mul(a, b):
        return RK.mont_mul_rns_plain(p, a, b)

    lam = mul(num, dinv)                                    # < 3p
    ll = mul(lam, lam)                                      # < 3p
    x3r = _sub_off(C, _sub_off(C, ll, "p4", x1r), "p4", x2r)   # < 11p
    dx13 = _sub_off(C, x1r, "p12", x3r)                     # < 15p
    y3r = _sub_off(C, mul(lam, dx13), "p4", y1r)            # < 7p
    kout = C.row("k_out", num.device)

    def out(v):                           # value R < 3p -> canonical digits
        ra, _ = RK.unpack_rns(ctx, mul(v, kout))
        return rns.from_rns_digits(ctx, ra, to_digits(p, nd), nd)

    x3, y3 = out(x3r), out(y3r)
    m1, m2, mz = inf1[:, None], inf2[:, None], inf3[:, None]
    X1, Y1, X2, Y2 = (v.reshape(n, nd) for v in (x1, y1, x2, y2))
    xo = torch.where(m1, X2, torch.where(m2, X1, x3))
    yo = torch.where(m1, Y2, torch.where(m2, Y1, y3))
    shape = EK._point_shape(x1, n, nd)
    return (xo.masked_fill(mz, 0).reshape(shape),
            yo.masked_fill(mz, 0).reshape(shape))


def _residues(x, n: int, what: str):
    if x.dtype != RK.PACKED_DTYPE or tuple(x.shape) != (n, RK.LANES):
        raise ValueError(f"{what}: residues must be int32 [{n}, {RK.LANES}],"
                         f" got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() & 15:
        x = x.clone()
    return x


def ecr_post_cuda(curve, num, dinv, x1r, y1r, x2r, x1, y1, x2, y2, inf1,
                  inf2, inf3):
    """Launch the post kernel: residues dense [N, 128] int32 on the device,
    coordinates as for ``ecr_pre_cuda``."""
    _check_widths(curve, "ecr_post")
    C = consts(curve)
    params = curve.fp
    n = x1.shape[0]
    res = [_residues(t, n, "ecr_post") for t in (num, dinv, x1r, y1r, x2r)]
    ops = [EK._rows(params, t, n, "ecr_post") for t in (x1, y1, x2, y2)]
    dev = EK._same_device(res + [t for t, _ in ops], "ecr_post")
    fl = [EK._flags(f, n, dev, "ecr_post") for f in (inf1, inf2, inf3)]
    shape = EK._point_shape(x1, n, C.nd)
    x3 = torch.empty(shape, dtype=DTYPE, device=dev)
    y3 = torch.empty(shape, dtype=DTYPE, device=dev)
    if n == 0:
        return x3, y3
    rc = fpmod._kernel("gl_ecr_post")(
        C.ctx.k, C.nd, C.wdt, *(r.data_ptr() for r in res),
        EK._ptrs([t for t, _ in ops]),
        EK._table(ctypes.c_longlong, [s for _, s in ops]),
        EK._ptrs([f for f, _ in fl]),
        EK._table(ctypes.c_longlong, [s for _, s in fl]),
        x3.data_ptr(), y3.data_ptr(), n,
        RK.device_consts(C.p, dev).data_ptr(),
        C.device_block(dev).data_ptr(), fpmod._raw_stream(x3))
    EK._launched(rc, "ecr_post", "ecr_post", n, C.nd)
    return x3, y3


def ecr_post(curve, num, dinv, x1r, y1r, x2r, x1, y1, x2, y2, inf1, inf2,
             inf3):
    if x1.is_cuda or x2.is_cuda or num.is_cuda:
        return ecr_post_cuda(curve, num, dinv, x1r, y1r, x2r, x1, y1, x2,
                             y2, inf1, inf2, inf3)
    return ecr_post_plain(curve, num, dinv, x1r, y1r, x2r, x1, y1, x2, y2,
                          inf1, inf2, inf3)


# ---------------------------------------------------------------------------
# the inversion tree
# ---------------------------------------------------------------------------

def tree_inverse_rns(curve, den, dead, plain: bool = False):
    """Inverses (scale M_A, packed) of the denominators ``den`` [N, 128]
    (scale M_A) with one field inversion; dead lanes enter as one and come
    out as zero.  The multiplies are K7 (``plain``: its plain version)."""
    C = consts(curve)
    params, p, nd, ctx = curve.fp, C.p, C.nd, C.ctx
    mul = RK.mont_mul_rns_plain if plain else RK.mont_mul_rns
    n = den.shape[0]
    n_pad = max(RK.LANES, 1 << max(0, (n - 1).bit_length()))
    one = C.row("one_tree", den.device)
    x = torch.where(dead[:, None], one, den)
    if n_pad != n:
        x = torch.cat([x, one.expand(n_pad - n, RK.LANES)])
    levels = [x]
    cur = x
    while cur.shape[0] > 1:
        cur = mul(p, cur[0::2], cur[1::2])
        levels.append(cur)
    # root: CRT -> digits -> inverse (K2) -> back at the M_A scale
    ra, _ = RK.unpack_rns(ctx, levels[-1])
    root = rns.from_rns_digits(ctx, ra, to_digits(p, nd), nd)     # rho M_A
    inv_root = fpmod.inv_mod(params, root)                      # rho^-1 R^2
    inv = mul(p, RK.pack_rns(ctx, *rns.to_rns_digits(ctx, inv_root)),
              C.row("c_root", den.device))                      # rho^-1 M_A
    down = RK.mont_mul_rns_down_plain if plain else RK.mont_mul_rns_down
    for child in reversed(levels[:-1]):     # node i: parent i/2, sibling i^1
        inv = down(p, inv, child)
    return inv[:n].masked_fill(dead[:, None], 0)


# ---------------------------------------------------------------------------
# the batched affine addition as a whole
# ---------------------------------------------------------------------------

def _batch_affine_add(curve, a_pt, b_pt, plain: bool):
    (x1, y1), inf1 = a_pt
    (x2, y2), inf2 = b_pt
    pre = ecr_pre_plain if plain else ecr_pre
    post = ecr_post_plain if plain else ecr_post
    num, den, x1r, y1r, x2r, inf3, dead = pre(curve, x1, y1, x2, y2, inf1,
                                              inf2)
    dinv = tree_inverse_rns(curve, den, dead, plain=plain)
    x3, y3 = post(curve, num, dinv, x1r, y1r, x2r, x1, y1, x2, y2, inf1,
                  inf2, inf3)
    return (x3, y3), inf3


def batch_affine_add_rns_plain(curve, a_pt, b_pt):
    """The plain version of the RNS path: pre, tree and post as array code
    (the tree's root inversion by ``fp.inv_mod``, as on the kernel path)."""
    return _batch_affine_add(curve, a_pt, b_pt, plain=True)


def batch_affine_add_rns(curve, a_pt, b_pt):
    """``SWCurveOps.batch_affine_add`` with RNS multiplies: pre kernel, K7
    tree, post kernel on a GPU; the plain versions on the CPU.  Same
    contract and the same digits as ``ec_kernels.batch_affine_add``."""
    (x1, _), _ = a_pt
    (x2, _), _ = b_pt
    return _batch_affine_add(curve, a_pt, b_pt,
                             plain=not (x1.is_cuda or x2.is_cuda))
