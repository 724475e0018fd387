"""The RNS Montgomery multiply: kernel K7 and its plain version.

Counterpart of ``gingerlib_tpu/ops/pallas_rns.py``.  Three functions,
dispatched on where the residues live, as in ``fields/fp.py`` -- no
fallback and no switch:

* ``mont_mul_rns_cuda`` -> ``csrc/rns_mont.cu``; replaces
  ``mont_mul_rns_pallas`` (``_rns_mont_kernel``, pallas_rns.py:171-207).
  Tiles of 16 elements a block, the channelwise steps on the CUDA cores,
  the two base extensions as byte-split products on the integer tensor
  cores (``csrc/rns_core.cuh``, source note there and in the ``.cu`` file).
* ``mont_mul_rns_plain``: the vectorized model of ``ops/rns.py`` on the
  unpacked residues.
* ``mont_mul_rns``: the kernel for CUDA residues, the plain version for CPU
  ones.

Packed layout, the port's boundary for residues: ``[N, 128]`` int32, base A
in columns 0..k-1 and base B in columns 64..63+k, every other column zero --
the transpose of the JAX package's ``pack_rns`` tile ``[128, N]`` uint32
(``utils/convert.py`` carries one into the other).  Residues are below
2^14.  Both versions compute x * y * M_A^-1 mod p with the JAX package's
alpha estimates, so they give its residues, not only its values mod p.

``mont_mul_rns_down`` is the inversion tree's down-sweep in one launch:
each parent times the sibling of each of its two children.

The kernel counts its launches in ``fields.fp.launch_counts["rns_mont"]``
(and by width in ``ec_kernels.launch_widths``).  Its constants
(``kernel_consts``) are the channel rows and the two extension matrices,
split into bytes by ``mma_fragments`` in the order the tensor cores' B
operand takes them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import fp as fpmod
from . import ec_kernels as EK
from . import rns

LANES = 128
B_ROW = 64            # base-B channels start at this column
PACKED_DTYPE = torch.int32
KMAX = 64             # the K of every tensor-core product, padded

# rows of the constant block, in the order of rns_core.cuh's enum Row
_ROWS = ("m", "mu", "sig", "w", "qsig", "pB", "mainv", "tsig", "ncorrAB",
         "ncorrBA", "p32")
N_ROWS = len(_ROWS)


def _rows(vals_a, vals_b, fill=0):
    out = np.full((LANES,), fill, dtype=np.uint64)
    out[:len(vals_a)] = vals_a
    out[B_ROW:B_ROW + len(vals_b)] = vals_b
    return out


def mma_fragments(mat) -> np.ndarray:
    """A [K, N] matrix of values below 2^16 (K a multiple of 32, N of 8) as
    the B operand of ``mma.m16n8k32.u8`` in ``csrc/rns_core.cuh``: its low
    and high bytes in fragment order, uint32 [K/32, N/8, 2, 32, 2] (k-step,
    n-tile, byte plane, lane, register).  Lane 4 g + t holds, in register
    r, the bytes of rows 32 s + 16 r + 4 t .. + 3 of column 8 j + g, the
    first in the low byte."""
    mat = np.asarray(mat, np.int64)
    K, N = mat.shape
    if K % 32 or N % 8 or mat.min() < 0 or mat.max() >= 1 << 16:
        raise ValueError(f"mma_fragments: a [{K}, {N}] matrix of values "
                         f"below 2^16 with K % 32 == N % 8 == 0")
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    s = np.arange(K // 32)[:, None, None, None, None, None]
    j = np.arange(N // 8)[None, :, None, None, None, None]
    pl = np.arange(2)[None, None, :, None, None, None]
    r = np.arange(2)[None, None, None, None, :, None]
    i = np.arange(4)
    rows = 32 * s + 16 * r + (4 * t)[:, None, None] + i
    cols = 8 * j + g[:, None, None] + 0 * i
    byte = (mat[rows, cols] >> (8 * pl)) & 0xFF
    return (byte << (8 * i)).sum(-1).astype(np.uint32)


def pad_matrix(mat, k: int, n: int) -> np.ndarray:
    """``mat`` in the top left corner of a [k, n] int64 matrix of zeros."""
    out = np.zeros((k, n), np.int64)
    out[:mat.shape[0], :mat.shape[1]] = mat
    return out


@functools.lru_cache(maxsize=8)
def kernel_consts(p: int) -> np.ndarray:
    """The constant block of ``csrc/rns_core.cuh`` for the field of ``p``,
    as uint32: rows [11, 128] (moduli, floor(2^32 / m), sigma factors,
    alpha weights; -p^-1 times the sigma factor (A words), p and M_A^-1
    (B words), M_A^-1 times the sigma factor (B words); the alpha
    corrections -|M_A| (B words) and -|M_B| (A words); 2^32 mod m; words
    outside the channels m = 1 and zeros), then the extension matrices
    A -> B and B -> A, each [64, 64] (zero beyond k) in fragment order
    (``mma_fragments``)."""
    ctx = rns.make_context(p)
    k = ctx.k
    if k > B_ROW:
        raise ValueError(f"{k} channels a base exceed the packed layout's "
                         f"{B_ROW}")
    m = _rows(ctx.mA, ctx.mB, fill=1)
    mA, mB = np.asarray(ctx.mA, np.uint64), np.asarray(ctx.mB, np.uint64)
    sA, sB = np.asarray(ctx.sigA, np.uint64), np.asarray(ctx.sigB, np.uint64)
    rows = {
        "m": m,
        "mu": np.asarray([(1 << 32) // int(v) for v in m], np.uint64)
        .clip(max=0xFFFFFFFF),
        "sig": _rows(ctx.sigA, ctx.sigB),
        "w": _rows(ctx.wA, ctx.wB),
        "qsig": _rows(np.asarray(ctx.negpinv_A, np.uint64) * sA % mA,
                      [0] * k),
        "pB": _rows([0] * k, ctx.p_B),
        "mainv": _rows([0] * k, ctx.MAinv_B),
        "tsig": _rows([0] * k, np.asarray(ctx.MAinv_B, np.uint64) * sB % mB),
        # A -> B corrects on the B words, B -> A on the A words
        "ncorrAB": _rows([0] * k, (mB - ctx.MA_modB.astype(np.uint64)) % mB),
        "ncorrBA": _rows((mA - ctx.MB_modA.astype(np.uint64)) % mA, [0] * k),
        "p32": np.asarray([(1 << 32) % int(v) for v in m], np.uint64),
    }
    ext = [mma_fragments(pad_matrix(e, KMAX, B_ROW)).reshape(-1)
           for e in (ctx.extAB, ctx.extBA)]
    return np.concatenate([np.stack([rows[r] for r in _ROWS]).reshape(-1)
                           .astype(np.uint32), *ext])


_DEVICE_CONSTS: dict = {}


def device_consts(p: int, device) -> torch.Tensor:
    """``kernel_consts(p)`` as an int32 tensor on ``device``, cached."""
    key = (p, str(device))
    hit = _DEVICE_CONSTS.get(key)
    if hit is None:
        hit = torch.from_numpy(kernel_consts(p).view(np.int32)).to(device)
        _DEVICE_CONSTS[key] = hit
    return hit


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def pack_rns(ctx: rns.RNSContext, ra, rb):
    """(resA, resB) [N, k] -> packed [N, 128] int32."""
    out = torch.zeros((ra.shape[0], LANES), dtype=PACKED_DTYPE,
                      device=ra.device)
    out[:, :ctx.k] = ra
    out[:, B_ROW:B_ROW + ctx.k] = rb
    return out


def unpack_rns(ctx: rns.RNSContext, packed):
    """packed [N, 128] -> (resA, resB) [N, k] int64."""
    p64 = packed.to(torch.int64)
    return p64[:, :ctx.k], p64[:, B_ROW:B_ROW + ctx.k]


def rns_row(ctx: rns.RNSContext, value: int) -> np.ndarray:
    """The packed residues [128] of the integer ``value`` (int32)."""
    return _rows([value % m for m in ctx.mA],
                 [value % m for m in ctx.mB]).astype(np.int32)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def mont_mul_rns_plain(p: int, x, y):
    """x * y * M_A^-1 mod p on packed residues, by the vectorized model."""
    ctx = rns.make_context(p)
    return pack_rns(ctx, *rns.mont_mul_rns(ctx, unpack_rns(ctx, x),
                                           unpack_rns(ctx, y)))


def _packed_rows(x, n: int, what: str):
    """A CUDA operand [n, 128] (or [1, 128] for all rows) -> (tensor to
    keep alive, row stride in words)."""
    if x.dtype != PACKED_DTYPE or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"{what}: residues must be int32 [N, {LANES}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got one on "
                         f"{x.device}")
    if x.shape[0] not in (n, 1):
        raise ValueError(f"{what}: expected {n} rows or one, got "
                         f"{x.shape[0]}")
    if x.stride(1) != 1 or x.stride(0) < 0 or x.data_ptr() & 15 \
            or x.stride(0) % 4:
        x = x.contiguous()
    return x, (x.stride(0) if x.shape[0] == n and n > 1 else 0)


def _launch(p: int, x, y, n: int, x_shift: int = 0, y_xor: int = 0):
    """One K7 launch over n elements: element e multiplies row e >> x_shift
    of x by row e ^ y_xor of y."""
    ctx = rns.make_context(p)
    xc, xs = _packed_rows(x, n >> x_shift, "rns_mont")
    yc, ys = _packed_rows(y, n, "rns_mont")
    if xc.device != yc.device:
        raise ValueError(f"rns_mont: operands on {xc.device} and "
                         f"{yc.device}")
    if n >= 1 << 31:
        raise ValueError(f"rns_mont: batch of {n} is too large")
    out = torch.empty((n, LANES), dtype=PACKED_DTYPE, device=xc.device)
    consts = device_consts(p, xc.device)
    rc = fpmod._kernel("gl_rns_mont")(
        ctx.k, xc.data_ptr(), xs, x_shift, yc.data_ptr(), ys, y_xor,
        out.data_ptr(), n, consts.data_ptr(), fpmod._raw_stream(xc))
    if n:
        EK._launched(rc, "rns_mont", "rns_mont", n, -(-p.bit_length() // 16))
    elif rc != 0:
        raise RuntimeError(f"rns_mont: kernel launch failed (code {rc})")
    return out


def mont_mul_rns_cuda(p: int, x, y):
    """Launch the RNS-multiply kernel on CUDA residues [N, 128] (either
    operand may be one row for all)."""
    return _launch(p, x, y, max(x.shape[0], y.shape[0]))


def mont_mul_rns(p: int, x, y):
    """x * y * M_A^-1 mod p on packed residues [N, 128] int32: the kernel
    for CUDA tensors, the plain version for CPU ones."""
    if x.is_cuda or y.is_cuda:
        return mont_mul_rns_cuda(p, x, y)
    return mont_mul_rns_plain(p, x, y)


# ---------------------------------------------------------------------------
# the inversion tree's down-sweep: out[e] = parent[e // 2] * child[e ^ 1]
# ---------------------------------------------------------------------------

def _check_down(parent, child):
    if child.shape[0] != 2 * parent.shape[0]:
        raise ValueError(f"rns_mont_down: {child.shape[0]} children for "
                         f"{parent.shape[0]} parents")


def mont_mul_rns_down_plain(p: int, parent, child):
    """Each parent times the sibling of each of its two children: the
    parents repeated twice against the children with each pair swapped."""
    _check_down(parent, child)
    sibling = child.reshape(-1, 2, LANES).flip(1).reshape(-1, LANES)
    return mont_mul_rns_plain(p, parent.repeat_interleave(2, 0), sibling)


def mont_mul_rns_down_cuda(p: int, parent, child):
    """The same in one K7 launch: element e takes row e >> 1 of ``parent``
    and row e ^ 1 of ``child``."""
    _check_down(parent, child)
    return _launch(p, parent, child, child.shape[0], x_shift=1, y_xor=1)


def mont_mul_rns_down(p: int, parent, child):
    """``parent`` [N, 128], ``child`` [2N, 128] packed residues -> [2N, 128]:
    row e is parent[e // 2] * child[e ^ 1] * M_A^-1 mod p.  The kernel for
    CUDA tensors, the plain version for CPU ones."""
    if parent.is_cuda or child.is_cuda:
        return mont_mul_rns_down_cuda(p, parent, child)
    return mont_mul_rns_down_plain(p, parent, child)
