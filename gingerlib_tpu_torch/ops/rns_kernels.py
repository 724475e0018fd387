"""The RNS Montgomery multiply: kernel K7 and its plain version.

Counterpart of ``gingerlib_tpu/ops/pallas_rns.py``.  Three functions,
dispatched on where the residues live, as in ``fields/fp.py`` -- no
fallback and no switch:

* ``mont_mul_rns_cuda`` -> ``csrc/rns_mont.cu``; replaces
  ``mont_mul_rns_pallas`` (``_rns_mont_kernel``, pallas_rns.py:171-207).
  One warp an element, the two base extensions as 64-bit integer inner
  products against constant matrices in shared memory
  (``csrc/rns_core.cuh``, source note there and in the ``.cu`` file).
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

The kernel counts its launches in ``fields.fp.launch_counts["rns_mont"]``.
Its constants (``kernel_consts``) are exact integers: the channel rows and
the two k x k extension matrices, without the TPU's 7-bit bf16 splits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import fp as fpmod
from ..fields.fp import launch_counts
from . import rns

LANES = 128
B_ROW = 64            # base-B channels start at this column
PACKED_DTYPE = torch.int32

# rows of the constant block, in the order of rns_core.cuh's enum Row
_ROWS = ("m", "mu", "sig", "w", "negpinv", "pB", "mainv", "corrAB",
         "corrBA", "p32")


def _rows(vals_a, vals_b, fill=0):
    out = np.full((LANES,), fill, dtype=np.uint64)
    out[:len(vals_a)] = vals_a
    out[B_ROW:B_ROW + len(vals_b)] = vals_b
    return out


@functools.lru_cache(maxsize=8)
def kernel_consts(p: int) -> np.ndarray:
    """The constant block of ``csrc/rns_core.cuh`` for the field of ``p``,
    as uint32: rows [10, 128] (moduli, floor(2^32 / m), sigma factors,
    alpha weights, -p^-1, p, M_A^-1, the two -alpha correction rows,
    2^32 mod m; words outside the channels m = 1 and zeros), then
    EXT_AB [k, 64] and EXT_BA [k, 64]."""
    ctx = rns.make_context(p)
    k = ctx.k
    if k > B_ROW:
        raise ValueError(f"{k} channels a base exceed the packed layout's "
                         f"{B_ROW}")
    m = _rows(ctx.mA, ctx.mB, fill=1)
    rows = {
        "m": m,
        "mu": np.asarray([(1 << 32) // int(v) for v in m], np.uint64)
        .clip(max=0xFFFFFFFF),
        "sig": _rows(ctx.sigA, ctx.sigB),
        "w": _rows(ctx.wA, ctx.wB),
        "negpinv": _rows(ctx.negpinv_A, [0] * k),
        "pB": _rows([0] * k, ctx.p_B),
        "mainv": _rows([0] * k, ctx.MAinv_B),
        "corrAB": _rows([0] * k, ctx.MA_modB),     # A -> B: on B columns
        "corrBA": _rows(ctx.MB_modA, [0] * k),     # B -> A: on A columns
        "p32": np.asarray([(1 << 32) % int(v) for v in m], np.uint64),
    }
    ext = np.zeros((2, k, B_ROW), np.uint64)
    ext[0, :, :k] = ctx.extAB
    ext[1, :, :k] = ctx.extBA
    return np.concatenate([np.stack([rows[r] for r in _ROWS]).reshape(-1),
                           ext.reshape(-1)]).astype(np.uint32)


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


def mont_mul_rns_cuda(p: int, x, y):
    """Launch the RNS-multiply kernel on CUDA residues [N, 128] (either
    operand may be one row for all)."""
    ctx = rns.make_context(p)
    n = max(x.shape[0], y.shape[0])
    xc, xs = _packed_rows(x, n, "rns_mont")
    yc, ys = _packed_rows(y, n, "rns_mont")
    if xc.device != yc.device:
        raise ValueError(f"rns_mont: operands on {xc.device} and "
                         f"{yc.device}")
    if n >= 1 << 31:
        raise ValueError(f"rns_mont: batch of {n} is too large")
    out = torch.empty((n, LANES), dtype=PACKED_DTYPE, device=xc.device)
    consts = device_consts(p, xc.device)
    rc = fpmod._kernel("gl_rns_mont")(
        ctx.k, xc.data_ptr(), xs, yc.data_ptr(), ys, out.data_ptr(), n,
        consts.data_ptr(), fpmod._raw_stream(xc))
    if rc != 0:
        raise RuntimeError(f"rns_mont: kernel launch failed (code {rc})")
    if n:
        launch_counts["rns_mont"] += 1
    return out


def mont_mul_rns(p: int, x, y):
    """x * y * M_A^-1 mod p on packed residues [N, 128] int32: the kernel
    for CUDA tensors, the plain version for CPU ones."""
    if x.is_cuda or y.is_cuda:
        return mont_mul_rns_cuda(p, x, y)
    return mont_mul_rns_plain(p, x, y)
