"""Multi-scalar multiplication: the part of ``gingerlib_tpu/ops/msm.py`` that
the JAX package runs below 2^12 points -- batched double-and-add plus a tree
reduction -- and the fixed-base form used by setup.

The bucketed (Pippenger) paths for 2^12 points and more rest on the curve
kernels that are not ported yet; ``msm_bucketed`` says so instead of running
the small-size path at a size it was not meant for.
"""

from __future__ import annotations

import torch

from ..curves.sw import SWCurveOps

NAIVE_BELOW = 1 << 12   # points; the JAX package's own threshold


def _tree_reduce(curve: SWCurveOps, pts):
    """Sum a batch of projective points [N, ...] in log depth -> [1, ...]."""
    cur = pts
    while cur[0].shape[0] > 1:
        n = cur[0].shape[0]
        if n % 2:
            cur = tuple(torch.cat([c, z], dim=0)
                        for c, z in zip(cur, curve.zero((1,))))
        cur = curve.add(tuple(c[0::2] for c in cur),
                        tuple(c[1::2] for c in cur))
    return cur


def _msm_lanes(curve: SWCurveOps, jobs):
    """The MSMs of ``jobs`` in ONE double-and-add loop: the lanes of all
    jobs are concatenated, multiplied by their scalars together (the loop's
    wall time hardly depends on the lane count), split again and
    tree-reduced per job."""
    sizes = [j[0].shape[0] for j in jobs]
    xs = torch.cat([j[0] for j in jobs], dim=0)
    ys = torch.cat([j[1] for j in jobs], dim=0)
    sd = torch.cat([j[2] for j in jobs], dim=0)
    pts = curve.from_affine(xs, ys)
    if any(j[3] is not None for j in jobs):
        inf = torch.cat([
            j[3] if j[3] is not None else torch.zeros(
                n, dtype=torch.bool, device=xs.device)
            for j, n in zip(jobs, sizes)], dim=0)
        pts = curve.select(inf, curve.zero((xs.shape[0],)), pts)
    prods = curve.mul_scalar_digits(pts, sd)
    return [tuple(c[0] for c in _tree_reduce(curve, seg))
            for seg in zip(*(c.split(sizes, dim=0) for c in prods))]


def msm_naive(curve: SWCurveOps, xs, ys, scalar_digits, inf_mask=None):
    """sum_i [k_i]P_i by per-point double-and-add and a tree reduction, at
    any size.  Affine points [N, K, nd], standard-form scalars [N, nd'],
    ``inf_mask`` marking points at infinity.  Returns a projective point."""
    return _msm_lanes(curve, [(xs, ys, scalar_digits, inf_mask)])[0]


def msm_batched(curve: SWCurveOps, jobs):
    """Prover-facing entry for several independent MSMs over one curve.

    jobs: list of (xs, ys, scalar_digits, inf_mask or None).  Returns one
    projective point per job; the values are those of separate
    ``msm_naive`` calls.  Every job must be below 2^12 points, where the
    JAX package takes the double-and-add form on its accelerator path too;
    larger jobs raise ``NotImplementedError``.
    """
    for xs, _, _, _ in jobs:
        if xs.shape[0] >= NAIVE_BELOW:
            raise NotImplementedError(
                f"MSM of {xs.shape[0]} points: the hybrid Pippenger path "
                f"for >= {NAIVE_BELOW} points arrives with the "
                f"curve-addition and inversion-tree kernels (next slice of "
                f"the port)")
    return _msm_lanes(curve, jobs)


def msm_bucketed(curve: SWCurveOps, xs, ys, scalar_digits, inf_mask=None):
    """Prover-facing entry for one MSM: ``msm_batched`` with one job."""
    return msm_batched(curve, [(xs, ys, scalar_digits, inf_mask)])[0]


def fixed_base_msm(curve: SWCurveOps, base_affine, scalar_digits):
    """[k_i]G for many scalars of one base: the base broadcast over the
    batch, then batched double-and-add.  Returns projective points [N]."""
    gx, gy = base_affine
    shape = (scalar_digits.shape[0],) + tuple(gx.shape[-2:])
    return curve.mul_scalar_digits(
        curve.from_affine(gx.expand(shape), gy.expand(shape)), scalar_digits)
