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
* ``batch_inverse``  -> ``csrc/inv_tree.cu``; replaces ``_inv_tree_rec`` /
  ``_batch_inverse_dm``.  Shared inversion of a batch, one field inversion
  in all, over tiles of ``INV_TILE`` elements: one launch of the tail kernel
  up to a tile (the tree, the root's inverse, the way down), else up kernel,
  the inversion of the tiles' products, down kernel.  Plain version:
  ``fp.batch_inverse_tree``; each of the three kernels has its own
  (``inv_up_plain``, ``inv_tail_plain``, ``inv_down_plain``).

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
inversion's three kernels each under its own key, ``inv_tree_up``,
``inv_tree_tail``, ``inv_tree_down``).  All are bound by their integer
multiply-adds on an H100, except ``affine_pre`` (bytes); ``chip_smoke.py``
computes the bounds and ``PERF.md`` holds the times.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields import fp as fpmod
from ..fields import towers as T
from ..fields.fp import KERNEL_DIGITS, launch_counts
from ..ops.limbs import DTYPE, limbs32

INV_TILE = 512   # elements of a tile of the inversion kernels (csrc's B)


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


def _launched(rc: int, what: str, key: str, n: int | None = None):
    """Raises for a failed launch, else counts it (and, given the batch
    width n, counts it by width too)."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed (code {rc})")
    launch_counts[key] += 1
    if key in launch_widths:
        launch_widths[key][n] = launch_widths[key].get(n, 0) + 1


def _point_shape(x, n: int, nd: int):
    return (n, 1, nd) if x.dim() == 3 else (n, nd)


# The curve kernels' launches by batch width, beside ``launch_counts``:
# {kernel: {width: launches}}; ``launches_by_class`` groups them.  The RNS
# kernels (ops/rns_kernels.py, ops/ec_rns.py) count here too.
RNS_KERNELS = ("rns_mont", "ecr_pre", "ecr_post")
launch_widths = {k: {} for k in ("ec_proj_add", "ec_affine_pre",
                                 "ec_affine_post", "inv_tree_up",
                                 "inv_tree_tail", "inv_tree_down")
                 + RNS_KERNELS}


def reset_launch_widths():
    for v in launch_widths.values():
        v.clear()


def width_class(key: str, n: int) -> str:
    """The class of a launch of ``key`` on n lanes: for K4 one lane (the
    window fold's additions), 2 to 2^10, 2^10 + 1 to 2^15 (the Fenwick
    steps' 16,376 lanes and the projective tree's upper levels) or wider;
    for K5 and K6 one tile of the inversion ("1-2^9" up to ``INV_TILE``
    lanes: the tail's widths), for the RNS kernels up to 2^6 elements
    (four tiles of 16: the RNS tree's narrow levels and roots), then
    octaves, "2^(e-1)-2^e" above 2^(e-1) and up to 2^e."""
    if key == "ec_proj_add":
        if n == 1:
            return "1"
        if n <= 1 << 10:
            return "2-2^10"
        return "2^10-2^15" if n <= 1 << 15 else "over_2^15"
    first = 1 << 6 if key in RNS_KERNELS else INV_TILE
    if n <= first:
        return f"1-2^{first.bit_length() - 1}"
    e = (n - 1).bit_length()
    return f"2^{e - 1}-2^{e}"


def launches_by_class(key: str) -> dict:
    """{class: launches} of ``key`` since ``reset_launch_widths``."""
    out = {}
    for n, c in sorted(launch_widths[key].items()):
        label = width_class(key, n)
        out[label] = out.get(label, 0) + c
    return out


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
    _launched(rc, "proj_add", "ec_proj_add", n)
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
    _launched(rc, "affine_pre", "ec_affine_pre", n)
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
    _launched(rc, "affine_post", "ec_affine_post", n)
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


def _nonzero_or_one(params, x):
    one = params.tensor("one_mont", x.device)
    return torch.where((x != 0).any(-1, keepdim=True), x, one)


def inv_up_plain(params, x):
    """What the up kernel computes, as array code: (the trees of the tiles
    of ``INV_TILE`` consecutive elements of ``x`` [N, nd], N > 0, as digits
    [tiles, 2 INV_TILE - 1, nd], the tiles' products [tiles, nd]).  A tree
    holds its levels one after the other, the leaves first (zero past N);
    node i of a level of width w/2 is node i times node i + w/2 of the
    level below, a zero leaf counting as one."""
    n, nd = x.shape
    tiles = -(-n // INV_TILE)
    level = torch.cat([x, x.new_zeros(tiles * INV_TILE - n, nd)]).reshape(
        tiles, INV_TILE, nd)
    levels = [level]
    level = _nonzero_or_one(params, level)
    while level.shape[1] > 1:
        h = level.shape[1] // 2
        level = fpmod.mont_mul_plain(params, level[:, :h], level[:, h:])
        levels.append(level)
    return torch.cat(levels, dim=1), level[:, 0]


def inv_tail_plain(params, x):
    """What the tail kernel computes: the inverses of ``x`` [N, nd],
    N <= ``INV_TILE``, zero where x is zero -- ``fp.batch_inverse_tree``."""
    return fpmod.batch_inverse_tree(params, x)


def inv_down_plain(params, tree, rinv, n: int):
    """What the down kernel computes, as array code: the inverses of the n
    elements whose trees ``inv_up_plain`` made (``tree``, digits), from the
    inverses ``rinv`` [tiles, nd] of the tiles' products; zero where an
    element is zero.  The children (a, b) of a node with inverse r get r b
    and r a."""
    inv = rinv[:, None]
    hi = tree.shape[1] - 1
    w = 2
    while w <= INV_TILE:
        lo = hi - w
        a, b = tree[:, lo:lo + w // 2], tree[:, lo + w // 2:hi]
        inv = torch.cat([
            fpmod.mont_mul_plain(params, inv, _nonzero_or_one(params, b)),
            fpmod.mont_mul_plain(params, inv, _nonzero_or_one(params, a))],
            dim=1)
        hi, w = lo, 2 * w
    leaves = tree[:, :INV_TILE]
    inv = inv.masked_fill(~(leaves != 0).any(-1, keepdim=True), 0)
    return inv.reshape(-1, tree.shape[-1])[:n]


def unpack_limbs(words):
    """Packed 32-bit limbs [..., nd / 2] int32 (the up kernel's trees) as
    digits [..., nd]."""
    w = words.to(DTYPE) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2)


def _inv_operand(params, a, what: str):
    fpmod._check_operand(params, a, what)
    if a.dim() != 2:
        raise ValueError(f"{what}: expected [N, nd], got {tuple(a.shape)}")
    x = a.contiguous()
    if x.data_ptr() & 15:
        x = x.clone()
    return x


def _inv_consts(params) -> int:
    """Host address of [p | R^3 | R] mod p as 32-bit limbs, the inversion
    kernels' constants, made once and kept on ``params``."""
    hit = params.__dict__.get("_inv_tree_consts")
    if hit is None:
        hit = np.ascontiguousarray(np.concatenate([
            params.modulus_limbs32.astype(np.uint32),
            limbs32(params.r3_digits), limbs32(params.one_mont)]))
        params.__dict__["_inv_tree_consts"] = hit
    return hit.ctypes.data


def _inv_launch(params, name, key, n, *ptrs, stream):
    rc = fpmod._kernel(name)(params.n_digits, *ptrs, n, INV_TILE,
                             _inv_consts(params), params.inv32, stream)
    _launched(rc, name[3:], key, n)


def inv_up_cuda(params, a):
    """Launch the up kernel on a CUDA batch [N, nd], N > ``INV_TILE``:
    (the tiles' trees as packed limbs [tiles, 2 INV_TILE - 1, nd / 2]
    int32, the tiles' products [tiles, nd])."""
    x = _inv_operand(params, a, "inv_up")
    n, nd = x.shape
    tiles = -(-n // INV_TILE)
    tree = torch.empty((tiles, 2 * INV_TILE - 1, nd // 2), dtype=torch.int32,
                       device=x.device)
    roots = torch.empty((tiles, nd), dtype=DTYPE, device=x.device)
    _inv_launch(params, "gl_inv_tree_up", "inv_tree_up", n, x.data_ptr(),
                tree.data_ptr(), roots.data_ptr(),
                stream=fpmod._raw_stream(x))
    return tree, roots


def inv_tail_cuda(params, a):
    """Launch the tail kernel on a CUDA batch [N, nd], 0 < N <=
    ``INV_TILE``: the inverses, zero where an element is zero."""
    x = _inv_operand(params, a, "inv_tail")
    n = x.shape[0]
    if not 0 < n <= INV_TILE:
        raise ValueError(f"inv_tail: takes 1 to {INV_TILE} elements, not {n}")
    out = torch.empty_like(x)
    _inv_launch(params, "gl_inv_tree_tail", "inv_tree_tail", n, x.data_ptr(),
                out.data_ptr(), stream=fpmod._raw_stream(x))
    return out


def inv_down_cuda(params, tree, rinv, n: int):
    """Launch the down kernel: the inverses of the n elements whose trees
    ``inv_up_cuda`` made, from the inverses ``rinv`` of their products."""
    rinv = _inv_operand(params, rinv, "inv_down")
    nd = params.n_digits
    tiles = -(-n // INV_TILE)
    if tree.shape != (tiles, 2 * INV_TILE - 1, nd // 2) \
            or tree.dtype != torch.int32 or not tree.is_contiguous() \
            or rinv.shape[0] != tiles:
        raise ValueError("inv_down: tree and rinv are not those of inv_up on "
                         f"{n} elements")
    _same_device([tree, rinv], "inv_down")
    out = torch.empty((n, nd), dtype=DTYPE, device=rinv.device)
    _inv_launch(params, "gl_inv_tree_down", "inv_tree_down", n,
                tree.data_ptr(), rinv.data_ptr(), out.data_ptr(),
                stream=fpmod._raw_stream(rinv))
    return out


def batch_inverse_cuda(params, a):
    """The shared inversion of a CUDA batch [N, nd] by the three kernels:
    the tail alone up to ``INV_TILE`` elements, else up, the inversion of
    the tiles' products (by the same means), down."""
    x = _inv_operand(params, a, "batch_inverse")
    n = x.shape[0]
    if n == 0:
        return torch.empty_like(x)
    if n <= INV_TILE:
        return inv_tail_cuda(params, x)
    tree, roots = inv_up_cuda(params, x)
    return inv_down_cuda(params, tree, batch_inverse_cuda(params, roots), n)


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
