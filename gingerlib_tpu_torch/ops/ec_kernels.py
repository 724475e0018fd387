"""Fused curve kernels for short-Weierstrass curves over a prime field.

Counterpart of ``gingerlib_tpu/ops/pallas_ec.py``.  Three kernel groups, each
a wrapper that launches hand-written CUDA when its tensors live on a GPU and
runs the plain PyTorch version beside it when they live on the CPU -- no
fallback and no switch, as in ``fields/fp.py``:

* ``proj_add``       -> ``csrc/ec_add.cu``; replaces ``proj_add_dm``.  Unified
  projective addition, a whole batch in one launch.  Plain version:
  ``SWCurveOps.add``.
* ``affine_pre`` / ``affine_post`` -> ``csrc/ec_affine.cu``; replace the two
  kernels behind ``batch_affine_add_fused`` / ``batch_affine_add_dm``: the
  batched affine addition before and after its shared inversion.  Plain
  versions: the array form, over any tower field (G2 runs it on the GPU too).
* ``batch_inverse``  -> ``csrc/inv_tree.cu``; replaces ``_batch_inverse_dm``.
  Shared inversion of a batch, one field inversion in all (through
  ``fp.inv_mod``).  Plain version: ``fp.batch_inverse_tree``; one level of
  each of its two kernels has its own (``inv_up_plain``, ``inv_down_plain``).

``batch_affine_add`` strings pre, inversion and post together; it is what
``SWCurveOps.batch_affine_add`` calls.

The TPU kernels work on digit-major ``[128, lanes]`` tiles with flags as
``[8, lanes]`` rows; the port keeps its own boundary: coordinates
``[N, 1, n_digits]`` (or ``[N, n_digits]``) int64 digits in Montgomery form,
flags ``[N]`` bool, any N.  Operands may be strided views (the even and odd
halves of a tree level) or a row expanded over the batch: the kernels take a
row stride per operand.  The kernels exist for curves over the base field
(``F.K == 1``) at 16, 24 and 48 digits; anything else on a GPU raises.

Each wrapper counts its launches in ``fields.fp.launch_counts`` (the
inversion's two kernels, ``inv_up`` and ``inv_down``, each under its own
key).  All are bound by their integer multiply-adds on an H100, except
``affine_pre`` (bytes);
``chip_smoke.py`` computes the bounds and ``PERF.md`` holds the times.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields import fp as fpmod
from ..fields import towers as T
from ..fields.fp import KERNEL_DIGITS, launch_counts
from ..ops.limbs import DTYPE, limbs32

INV_RUN = 8   # elements a thread of the inversion kernels walks (>= 2)


def supports(curve) -> bool:
    """True where the fused kernels exist for ``curve``: a curve over the
    base field at a digit width the kernels are built for."""
    return curve.F.K == 1 and curve.fp.n_digits in KERNEL_DIGITS


# ---------------------------------------------------------------------------
# what the kernels are given
# ---------------------------------------------------------------------------

def _curve_consts(curve) -> int:
    """Host address of [p | a | one] as 32-bit limbs for ``curve``, made
    once and kept on the curve so that the address stays valid (a field
    alone has ``FpParams.kernel_consts``)."""
    hit = curve.__dict__.get("_kernel_consts")
    if hit is None:
        params = curve.fp
        hit = np.ascontiguousarray(np.concatenate([
            params.modulus_limbs32.astype(np.uint32),
            limbs32(curve.a.reshape(-1).cpu().numpy()),
            limbs32(params.one_mont)]))
        object.__setattr__(curve, "_kernel_consts", hit)
    return hit.ctypes.data


def _check_curve(curve, what: str):
    if curve.F.K != 1:
        raise NotImplementedError(
            f"{what}: the curve kernels cover curves over the base field, "
            f"not {curve.name} over a degree-{curve.F.K} extension")


def _rows(params, x, n: int, what: str):
    """``x``: [n, nd] or [n, 1, nd] CUDA digits, possibly a strided or
    expanded view -> (tensor to keep alive, row stride in digits)."""
    if x.dim() == 3:
        if x.shape[1] != 1:
            raise ValueError(f"{what}: expected one component, got "
                             f"{tuple(x.shape)}")
        x = x[:, 0]
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"{what}: expected {n} rows, got {tuple(x.shape)}")
    fpmod._check_operand(params, x, what)
    stride = x.stride(0) if n > 1 else 0
    if x.stride(1) != 1 or stride < 0 or stride % 2 or x.data_ptr() & 15:
        x = x.contiguous()
        if x.data_ptr() & 15:
            x = x.clone()
        stride = x.shape[1]
    return x, stride


def _flags(f, n: int, device, what: str):
    if f.dtype != torch.bool or f.shape != (n,):
        raise ValueError(f"{what}: flags must be bool [{n}], got {f.dtype} "
                         f"{tuple(f.shape)}")
    if f.device != device:
        raise ValueError(f"{what}: flags on {f.device}, operands on {device}")
    stride = f.stride(0) if n > 1 else 0
    if stride < 0:
        f = f.contiguous()
        stride = 1
    return f, stride


def _table(ctype, values):
    return (ctype * len(values))(*values)


def _ptrs(tensors):
    return _table(ctypes.c_void_p, [t.data_ptr() for t in tensors])


def _same_device(tensors, what: str):
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: operands on {dev} and {t.device}")
    return dev


def _launched(rc: int, what: str, key: str):
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed (code {rc})")
    launch_counts[key] += 1


def _point_shape(x, n: int, nd: int):
    return (n, 1, nd) if x.dim() == 3 else (n, nd)


# ---------------------------------------------------------------------------
# K4: unified projective addition
# ---------------------------------------------------------------------------

def proj_add_plain(curve, P3, Q3):
    """The plain version: ``SWCurveOps.add`` (add-1998-cmo-2, dbl-2007-bl and
    the completeness selects as array code)."""
    return curve.add(P3, Q3)


def proj_add_cuda(curve, P3, Q3):
    """Launch the projective-addition kernel on CUDA triples of
    [N, 1, nd] (or [N, nd]) coordinates."""
    _check_curve(curve, "proj_add")
    params = curve.fp
    nd = params.n_digits
    n = P3[0].shape[0]
    ops = [_rows(params, t, n, "proj_add") for t in (*P3, *Q3)]
    dev = _same_device([t for t, _ in ops], "proj_add")
    shape = _point_shape(P3[0], n, nd)
    outs = [torch.empty(shape, dtype=DTYPE, device=dev) for _ in range(3)]
    if n == 0:
        return tuple(outs)
    rc = fpmod._kernel("gl_ec_proj_add")(
        nd, _ptrs([t for t, _ in ops]),
        _table(ctypes.c_longlong, [s for _, s in ops]), _ptrs(outs), n,
        _curve_consts(curve), params.inv32,
        int(curve.a_is_zero), fpmod._raw_stream(outs[0]))
    _launched(rc, "proj_add", "ec_proj_add")
    return tuple(outs)


def proj_add(curve, P3, Q3):
    """P + Q for batches of projective points, right for every input
    (equal, opposite, infinity); the values of ``SWCurveOps.add``."""
    if P3[0].is_cuda or Q3[0].is_cuda:
        return proj_add_cuda(curve, P3, Q3)
    return proj_add_plain(curve, P3, Q3)


# ---------------------------------------------------------------------------
# K5: batched affine addition, before and after the shared inversion
# ---------------------------------------------------------------------------

def affine_pre_plain(curve, x1, y1, x2, y2, inf1, inf2):
    """(num, den, inf3): lambda's numerator and denominator per lane and the
    flag of a result at infinity.  Array code over ``curve.F`` (any tower).
    Lanes whose result does not depend on lambda keep whatever difference
    they have, possibly a zero denominator."""
    F = curve.F
    dx = F.sub(x2, x1)
    dy = F.sub(y2, y1)
    same_x = F.is_zero(dx)
    same_y = F.is_zero(dy)
    ninf = ~inf1 & ~inf2
    dbl = same_x & same_y & ninf
    anti = same_x & ~same_y & ninf
    # doubling lanes: lambda = (3 x^2 + a) / 2y ; others: lambda = dy / dx
    xx = F.sqr(x1)
    three_xx_a = F.add(F.add(F.double(xx), xx), curve.a)
    sel = dbl[..., None, None]
    num = torch.where(sel, three_xx_a, dy)
    den = torch.where(sel, F.double(y1), dx)
    inf3 = (inf1 & inf2) | anti | (dbl & F.is_zero(y1))
    return num, den, inf3


def affine_post_plain(curve, num, dinv, x1, y1, x2, y2, inf1, inf2, inf3):
    """(x3, y3) from lambda = num * dinv, with the completeness selects;
    infinity comes out as (0, 0)."""
    F = curve.F
    lam = F.mul(num, dinv)
    x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    m1 = inf1[..., None, None]
    m2 = inf2[..., None, None]
    mz = inf3[..., None, None]
    x_out = torch.where(m1, x2, torch.where(m2, x1, x3))
    y_out = torch.where(m1, y2, torch.where(m2, y1, y3))
    zero = torch.zeros_like(x_out)
    return torch.where(mz, zero, x_out), torch.where(mz, zero, y_out)


def affine_pre_cuda(curve, x1, y1, x2, y2, inf1, inf2):
    _check_curve(curve, "affine_pre")
    params = curve.fp
    nd = params.n_digits
    n = x1.shape[0]
    ops = [_rows(params, t, n, "affine_pre") for t in (x1, y1, x2, y2)]
    dev = _same_device([t for t, _ in ops], "affine_pre")
    fl = [_flags(f, n, dev, "affine_pre") for f in (inf1, inf2)]
    shape = _point_shape(x1, n, nd)
    num = torch.empty(shape, dtype=DTYPE, device=dev)
    den = torch.empty(shape, dtype=DTYPE, device=dev)
    inf3 = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return num, den, inf3
    rc = fpmod._kernel("gl_ec_affine_pre")(
        nd, _ptrs([t for t, _ in ops]),
        _table(ctypes.c_longlong, [s for _, s in ops]),
        _ptrs([f for f, _ in fl]),
        _table(ctypes.c_longlong, [s for _, s in fl]),
        num.data_ptr(), den.data_ptr(), inf3.data_ptr(), n,
        _curve_consts(curve), params.inv32,
        fpmod._raw_stream(num))
    _launched(rc, "affine_pre", "ec_affine_pre")
    return num, den, inf3


def affine_post_cuda(curve, num, dinv, x1, y1, x2, y2, inf1, inf2, inf3):
    _check_curve(curve, "affine_post")
    params = curve.fp
    nd = params.n_digits
    n = x1.shape[0]
    ops = [_rows(params, t, n, "affine_post") for t in (x1, y1, x2, y2)]
    dense = []
    for t in (num, dinv):
        t, stride = _rows(params, t, n, "affine_post")
        dense.append(t if stride == nd or n == 1 else t.contiguous())
    dev = _same_device([t for t, _ in ops] + dense, "affine_post")
    fl = [_flags(f, n, dev, "affine_post") for f in (inf1, inf2, inf3)]
    shape = _point_shape(x1, n, nd)
    x3 = torch.empty(shape, dtype=DTYPE, device=dev)
    y3 = torch.empty(shape, dtype=DTYPE, device=dev)
    if n == 0:
        return x3, y3
    rc = fpmod._kernel("gl_ec_affine_post")(
        nd, dense[0].data_ptr(), dense[1].data_ptr(),
        _ptrs([t for t, _ in ops]),
        _table(ctypes.c_longlong, [s for _, s in ops]),
        _ptrs([f for f, _ in fl]),
        _table(ctypes.c_longlong, [s for _, s in fl]),
        x3.data_ptr(), y3.data_ptr(), n,
        _curve_consts(curve), params.inv32,
        fpmod._raw_stream(x3))
    _launched(rc, "affine_post", "ec_affine_post")
    return x3, y3


def affine_pre(curve, x1, y1, x2, y2, inf1, inf2):
    if x1.is_cuda or x2.is_cuda:
        return affine_pre_cuda(curve, x1, y1, x2, y2, inf1, inf2)
    return affine_pre_plain(curve, x1, y1, x2, y2, inf1, inf2)


def affine_post(curve, num, dinv, x1, y1, x2, y2, inf1, inf2, inf3):
    if x1.is_cuda or x2.is_cuda or num.is_cuda:
        return affine_post_cuda(curve, num, dinv, x1, y1, x2, y2, inf1, inf2,
                                inf3)
    return affine_post_plain(curve, num, dinv, x1, y1, x2, y2, inf1, inf2,
                             inf3)


# ---------------------------------------------------------------------------
# K6: shared inversion
# ---------------------------------------------------------------------------

def batch_inverse_plain(params, a):
    """The plain version: ``fp.batch_inverse_tree`` (pairwise products up a
    log-depth tree, one inversion, inverses pushed back down)."""
    return fpmod.batch_inverse_tree(params, a)


def _runs_of(params, x):
    """[N, nd] -> [ceil(N / INV_RUN), INV_RUN, nd] with zeros replaced by one
    and the last run filled up with ones, and the mask [runs, INV_RUN] of
    real non-zero elements."""
    n, nd = x.shape
    run = INV_RUN
    runs = -(-n // run)
    one = params.tensor("one_mont", x.device)
    live = (x != 0).any(-1)
    v = torch.where(live[:, None], x, one)
    pad = runs * run - n
    if pad:
        v = torch.cat([v, one.expand(pad, nd)])
        live = torch.cat([live, live.new_zeros(pad)])
    return v.reshape(runs, run, nd), live.reshape(runs, run)


def inv_up_plain(params, x):
    """One level of the up sweep as array code: (prefix products inside each
    run of ``INV_RUN`` consecutive elements [N, nd], the run products
    [ceil(N / INV_RUN), nd]); a zero element counts as one."""
    n, nd = x.shape
    v, _ = _runs_of(params, x)
    cols = [v[:, 0]]
    for j in range(1, INV_RUN):
        cols.append(fpmod.mont_mul(params, cols[-1], v[:, j]))
    return torch.stack(cols, dim=1).reshape(-1, nd)[:n], cols[-1]


def inv_down_plain(params, x, pre, rinv):
    """One level of the down sweep as array code: the inverses of ``x``
    [N, nd] from the prefix products ``pre`` of ``inv_up_plain`` and the
    inverses ``rinv`` of its run products; zero where x is zero."""
    n, nd = x.shape
    v, live = _runs_of(params, x)
    pv, _ = _runs_of(params, pre)
    r = rinv
    out = [None] * INV_RUN
    for j in range(INV_RUN - 1, 0, -1):
        out[j] = fpmod.mont_mul(params, r, pv[:, j - 1])
        r = fpmod.mont_mul(params, r, v[:, j])
    out[0] = r
    res = torch.stack(out, dim=1).masked_fill(~live[:, :, None], 0)
    return res.reshape(-1, nd)[:n]


def unpack_limbs(pre):
    """The up kernel's prefix products, kept as packed 32-bit limbs
    [N, nd / 2] int32, as digits [N, nd]."""
    w = pre.to(DTYPE) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        pre.shape[0], -1)


def _inv_operand(params, a, what: str):
    fpmod._check_operand(params, a, what)
    if a.dim() != 2:
        raise ValueError(f"{what}: expected [N, nd], got {tuple(a.shape)}")
    x = a.contiguous()
    if x.data_ptr() & 15:
        x = x.clone()
    return x


def inv_up_cuda(params, a):
    """Launch the up-sweep kernel on a CUDA batch [N, nd], N >= 1: (prefix
    products as packed limbs [N, nd / 2] int32, run products
    [ceil(N / INV_RUN), nd])."""
    x = _inv_operand(params, a, "inv_up")
    n, nd = x.shape
    pre = torch.empty((n, nd // 2), dtype=torch.int32, device=x.device)
    roots = torch.empty((-(-n // INV_RUN), nd), dtype=DTYPE, device=x.device)
    rc = fpmod._kernel("gl_inv_tree_up")(
        nd, x.data_ptr(), pre.data_ptr(), roots.data_ptr(), n, INV_RUN,
        params.kernel_consts.ctypes.data, params.inv32,
        fpmod._raw_stream(x))
    _launched(rc, "inv_up", "inv_tree_up")
    return pre, roots


def inv_down_cuda(params, a, pre, rinv):
    """Launch the down-sweep kernel: the inverses of the CUDA batch ``a``
    from ``pre`` of ``inv_up_cuda`` and the inverses ``rinv`` of its run
    products."""
    x = _inv_operand(params, a, "inv_down")
    rinv = _inv_operand(params, rinv, "inv_down")
    n, nd = x.shape
    if pre.shape != (n, nd // 2) or pre.dtype != torch.int32 \
            or not pre.is_contiguous() or rinv.shape[0] != -(-n // INV_RUN):
        raise ValueError("inv_down: pre and rinv are not those of inv_up on "
                         "this batch")
    _same_device([x, pre, rinv], "inv_down")
    out = torch.empty_like(x)
    rc = fpmod._kernel("gl_inv_tree_down")(
        nd, x.data_ptr(), pre.data_ptr(), rinv.data_ptr(), out.data_ptr(), n,
        INV_RUN, params.kernel_consts.ctypes.data, params.inv32,
        fpmod._raw_stream(x))
    _launched(rc, "inv_down", "inv_tree_down")
    return out


def batch_inverse_cuda(params, a):
    """The shared inversion of a CUDA batch [N, nd] by the two kernels: up
    sweep, recursion over the run products (the last one through
    ``fp.inv_mod``), down sweep."""
    x = _inv_operand(params, a, "batch_inverse")
    if x.shape[0] == 0:
        return torch.empty_like(x)
    if x.shape[0] == 1:
        return fpmod.inv_mod(params, x)
    pre, roots = inv_up_cuda(params, x)
    return inv_down_cuda(params, x, pre, batch_inverse_cuda(params, roots))


def batch_inverse(params, a):
    """Inverses of a flat batch [N, nd] in Montgomery form with one field
    inversion; zeros pass through as zeros."""
    if a.is_cuda:
        return batch_inverse_cuda(params, a)
    return batch_inverse_plain(params, a)


# ---------------------------------------------------------------------------
# the batched affine addition as a whole
# ---------------------------------------------------------------------------

def batch_affine_add_plain(curve, a_pt, b_pt):
    """Array form over ``curve.F``: pre, the tower's shared-inversion tree,
    post.  The plain version of the kernel path, and the path of curves over
    extension fields on any device."""
    (x1, y1), inf1 = a_pt
    (x2, y2), inf2 = b_pt
    num, den, inf3 = affine_pre_plain(curve, x1, y1, x2, y2, inf1, inf2)
    dinv = T.ext_batch_inverse_tree(curve.F, den)
    x3, y3 = affine_post_plain(curve, num, dinv, x1, y1, x2, y2, inf1, inf2,
                               inf3)
    return (x3, y3), inf3


def batch_affine_add(curve, a_pt, b_pt):
    """Pairwise affine addition of ((x, y), inf) batches over a base-field
    curve with ONE shared inversion: pre kernel, inversion kernels, post
    kernel on a GPU; the plain versions on the CPU."""
    (x1, y1), inf1 = a_pt
    (x2, y2), inf2 = b_pt
    if not (x1.is_cuda or x2.is_cuda):
        return batch_affine_add_plain(curve, a_pt, b_pt)
    num, den, inf3 = affine_pre_cuda(curve, x1, y1, x2, y2, inf1, inf2)
    nd = curve.fp.n_digits
    dinv = batch_inverse_cuda(curve.fp, den.reshape(-1, nd)).reshape(den.shape)
    x3, y3 = affine_post_cuda(curve, num, dinv, x1, y1, x2, y2, inf1, inf2,
                              inf3)
    return (x3, y3), inf3
