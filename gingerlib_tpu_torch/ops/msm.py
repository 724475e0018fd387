"""Multi-scalar multiplication.  Counterpart of ``gingerlib_tpu/ops/msm.py``.

Three forms and one dispatch:

* ``msm_naive``: per-point double-and-add and a tree reduction.  The prover
  takes it below 2^12 points (the JAX package's own threshold on its
  accelerator path), several jobs sharing one loop (``msm_batched``); it is
  also the oracle the bucketed forms are held against.
* ``msm_hybrid``: Pippenger for curves over the base field (G1), built on the
  fused curve kernels of ``ops/ec_kernels.py``.
* ``msm_affine``: Pippenger with ``curve.batch_affine_add`` over any tower
  field: the prover's path for G2 (array code), and the RNS path (K7, K8 of
  ``ops/ec_rns.py``) over a G1 curve built with ``ec_rns=True``.
* ``fixed_base_table`` / ``fixed_base_msm_windowed``: [k_i]G for many
  scalars of one base through a table of the base's windowed multiples:
  setup's path (ginger-lib's ``fixed_base.rs``); ``fixed_base_msm``, the
  batched double-and-add over the broadcast base, is the oracle it is held
  against.

The bucketed forms avoid scatters: per c-bit window the points are sorted by
their window digit, a dyadic partial-sum tree is built over the sorted
points, the prefix sum "all points with digit < b" is read off the tree for
every bucket b at once (Fenwick decomposition), and the window sum follows
from  sum_b b*S_b = sum_{b>=1} (Total - prefix_b).  A chunk of windows is
flattened into the lane axis (window-major; N is padded to a power of two,
so adjacent pairs never cross a window), so every tree level and every
Fenwick step is ONE batched addition over chunk*N lanes, with one shared
inversion where the addition is affine.

The projective Pippenger ``msm()`` of the JAX package (its CPU path) is not
ported.
"""

from __future__ import annotations

import torch

from ..curves.sw import SWCurveOps
from ..fields import fp as fpmod
from ..fields import host_ext
from . import ec_kernels as EK

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


# ---------------------------------------------------------------------------
# what the two bucketed forms share
# ---------------------------------------------------------------------------

def default_window(n: int) -> int:
    """Window width that keeps N + 2^c * log N per window small across the
    nbits/c windows."""
    if n < (1 << 8):
        return 3
    if n < (1 << 12):
        return 6
    if n < (1 << 16):
        return 9
    if n < (1 << 20):
        return 11
    return 13


def _window_digits(scalar_digits, c: int, nbits: int):
    """[N, nd] base-2^16 digits -> [W, N] c-bit window values (c <= 32)."""
    W = -(-nbits // c)
    nd = scalar_digits.shape[1]
    out = []
    for w in range(W):
        j, r = divmod(w * c, 16)
        v = scalar_digits[:, j] >> r
        if j + 1 < nd:
            v = v | (scalar_digits[:, j + 1] << (16 - r))
        if j + 2 < nd and r > 0 and c > 32 - r:
            v = v | (scalar_digits[:, j + 2] << (32 - r))
        out.append(v & ((1 << c) - 1))
    return torch.stack(out)


def _window_chunks(curve, xs, ys, scalar_digits, c, nbits, inf_mask,
                   window_chunk):
    """Pads N to a power of two (with points at infinity) and the window
    count to a multiple of the chunk (all-zero windows sum to infinity).
    Returns (xs, ys, inf_mask, c, W, key chunks [n_chunks, wc, N])."""
    if nbits is None:
        nbits = curve.scalar_field.modulus_bits
    nbits = min(nbits, 16 * scalar_digits.shape[1])   # all the digits hold
    n = xs.shape[0]
    if inf_mask is None:
        inf_mask = torch.zeros(n, dtype=torch.bool, device=xs.device)
    n2 = 1 << max(0, (n - 1).bit_length())
    if n2 != n:
        pad = n2 - n
        xs = torch.cat([xs, xs.new_zeros((pad,) + xs.shape[1:])])
        ys = torch.cat([ys, ys.new_zeros((pad,) + ys.shape[1:])])
        scalar_digits = torch.cat([
            scalar_digits,
            scalar_digits.new_zeros((pad,) + scalar_digits.shape[1:])])
        inf_mask = torch.cat([inf_mask, inf_mask.new_ones(pad)])
        n = n2
    if c is None:
        c = default_window(n)
    W = -(-nbits // c)
    windows = _window_digits(scalar_digits, c, nbits)          # [W, N]
    if window_chunk is None:
        window_chunk = int(min(8, W, max(1, (1 << 23) // max(n, 1))))
    Wp = -(-W // window_chunk) * window_chunk
    if Wp != W:
        windows = torch.cat([windows, windows.new_zeros((Wp - W, n))])
    return (xs, ys, inf_mask, c, W,
            windows.reshape(Wp // window_chunk, window_chunk, n))


def _sorted_chunk(xs, ys, inf_mask, keys):
    """One chunk of windows, keys [wc, N]: the points sorted by key inside
    each window, flattened window-major to wc*N lanes, as (x, y, inf).
    The sort is stable, so CPU and GPU pair up the same points.  Bucket-0
    points never contribute: they are flagged, and the coordinates of all
    flagged lanes are zeroed so that equal garbage cannot pass for a
    doubling lane.  Also returns the sorted keys."""
    keys_s, order = torch.sort(keys, dim=1, stable=True)
    flat = order.reshape(-1)
    inf = inf_mask.index_select(0, flat) | (keys_s.reshape(-1) == 0)
    m = inf[:, None, None]
    x = xs.index_select(0, flat).masked_fill_(m, 0)
    y = ys.index_select(0, flat).masked_fill_(m, 0)
    return keys_s, (x, y, inf)


def _bucket_counts(keys_s, c: int):
    """m[w, b-1] = number of points of window w with key < b, b = 1..2^c-1,
    flattened to [wc * B]."""
    wc = keys_s.shape[0]
    bvals = torch.arange(1, 1 << c, dtype=keys_s.dtype, device=keys_s.device)
    return torch.searchsorted(keys_s, bvals.expand(wc, -1).contiguous(),
                              right=False).reshape(-1)


def _halves(t3):
    return tuple(t[0::2] for t in t3), tuple(t[1::2] for t in t3)


def _gather(t3, idx):
    return tuple(t.index_select(0, idx) for t in t3)


def _aff_add(add, a, b):
    """The batched affine addition ``add`` (``curve.batch_affine_add`` or
    the positional kernels' ``ec_kernels.batch_affine_add``) on flat
    (x, y, inf) triples."""
    (x, y), inf = add(((a[0], a[1]), a[2]), ((b[0], b[1]), b[2]))
    return x, y, inf


def _aff_select(mask, a, b):
    m = mask[:, None, None]
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(mask, a[2], b[2]))


def _aff_to_proj(curve, a):
    """(x, y, inf) -> projective, infinity as (0, 1, 0)."""
    x, y, inf = a
    m = inf[:, None, None]
    one = curve.F.tensor("one", x.device)
    return (x.masked_fill(m, 0), torch.where(m, one, y),
            one.expand(x.shape).masked_fill(m, 0))


def _fenwick_prefixes(levels, n: int, counts, n_buckets: int, acc, step):
    """Prefix sums at ``counts`` [wc * B] over the stored tree levels of a
    chunk: each count decomposes into dyadic blocks, one masked batched
    addition per level, the per-window root (level log2 N) included.
    ``step(acc, level, node_index, take)`` returns acc plus the level's
    nodes at ``node_index`` in the lanes of ``take``, acc elsewhere."""
    win_id = torch.arange(counts.shape[0], dtype=counts.dtype,
                          device=counts.device) // n_buckets
    offset = torch.zeros_like(counts)
    for l in range(len(levels) - 1, -1, -1):
        nodes_per_win = n >> l
        bit = (counts >> l) & 1
        idx = torch.clamp(offset >> l, max=nodes_per_win - 1)
        acc = step(acc, levels[l], win_id * nodes_per_win + idx, bit == 1)
        offset = offset + (bit << l)
    return acc


def _fold_windows(curve, wsums, c: int):
    """sum_w 2^(c*w) * S_w over projective window sums [W, K, nd], most
    significant window first, c doublings a window.  Over the base field
    every step is one launch of the projective-addition kernel on a GPU
    (P + P takes its doubling branch: the values of ``double``)."""
    if curve.F.K == 1:
        def add(p, q):
            return EK.proj_add(curve, p, q)

        def double(p):
            return EK.proj_add(curve, p, p)
    else:
        add, double = curve.add, curve.double
    W = wsums[0].shape[0]
    res = tuple(t[W - 1:W] for t in wsums)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            res = double(res)
        res = add(res, tuple(t[w:w + 1] for t in wsums))
    return tuple(t[0] for t in res)


# ---------------------------------------------------------------------------
# hybrid Pippenger: curves over the base field, fused kernels
# ---------------------------------------------------------------------------

def msm_hybrid(curve: SWCurveOps, xs, ys, scalar_digits,
               c: int | None = None, nbits: int | None = None,
               inf_mask=None, window_chunk: int | None = None,
               affine_cutoff: int = 1 << 15):
    """Variable-base MSM  sum_i [k_i]P_i  for a curve over the base field.

    xs, ys: affine coordinates [N, 1, nd]; scalar_digits: standard-form
    digits [N, nd_r]; inf_mask: optional [N] bool of points at infinity.
    Returns a projective point.

    Tree levels with at least ``affine_cutoff`` output lanes use the batched
    affine addition (pre kernel, shared inversion, post kernel: ~7
    multiplies a lane and one field inversion a level); smaller levels, the
    Fenwick walk and the bucket fold use the fused projective addition (14
    multiplies a lane, no inversion).  The window sum is
    B*Total - sum_b prefix_b: one negation instead of B per-bucket
    subtractions.  The default cutoff is the JAX package's, kept so that
    results stay comparable; it is not tuned for this card.  The affine
    levels call the positional kernels directly, as the JAX package's
    ``msm_hybrid`` calls ``batch_affine_add_dm``: a curve's ``ec_rns``
    changes ``msm_affine``, not this form.
    """
    if curve.F.K != 1:
        raise NotImplementedError(
            f"msm_hybrid: {curve.name} is over a degree-{curve.F.K} "
            f"extension; use msm_affine")
    xs, ys, inf_mask, c, W, chunks = _window_chunks(
        curve, xs, ys, scalar_digits, c, nbits, inf_mask, window_chunk)
    n = xs.shape[0]
    wc = chunks.shape[1]
    B = (1 << c) - 1

    def padd(p, q):
        return EK.proj_add(curve, p, q)

    def positional(a_pt, b_pt):
        return EK.batch_affine_add(curve, a_pt, b_pt)

    def fenwick_step(acc, level, gidx, take):
        kind, v = level
        node = _gather(v, gidx)
        if kind == "aff":
            node = _aff_to_proj(curve, node)
        return curve.select(take, padd(acc, node), acc)

    def one_chunk(keys):
        """(Total, sum_b prefix_b) per window of the chunk, projective
        [wc, 1, nd].  The tree levels live only as long as this call."""
        keys_s, pt = _sorted_chunk(xs, ys, inf_mask, keys)
        cur = ("aff", pt)
        levels = [cur]
        cols = wc * n
        while cols > wc:
            kind, v = cur
            if kind == "aff" and cols // 2 >= affine_cutoff:
                cur = ("aff", _aff_add(positional, *_halves(v)))
            else:
                if kind == "aff":
                    v = _aff_to_proj(curve, v)
                cur = ("proj", padd(*_halves(v)))
            levels.append(cur)
            cols //= 2
        kind, total = cur
        if kind == "aff":
            total = _aff_to_proj(curve, total)

        acc = _fenwick_prefixes(levels, n, _bucket_counts(keys_s, c), B,
                                curve.zero((wc * B,)), fenwick_step)
        # pad B -> 2^c per window with infinity, then c fold levels
        zero = curve.zero((wc, 1))
        acc = tuple(torch.cat([a.reshape((wc, B) + a.shape[1:]), z], dim=1)
                    .reshape((wc * (B + 1),) + a.shape[1:])
                    for a, z in zip(acc, zero))
        cols = wc * (B + 1)
        while cols > wc:
            acc = padd(*_halves(acc))
            cols //= 2
        return total, acc

    parts = [one_chunk(keys) for keys in chunks]
    total = tuple(torch.cat([p[0][k] for p in parts])[:W] for k in range(3))
    psum = tuple(torch.cat([p[1][k] for p in parts])[:W] for k in range(3))
    wsums = padd(curve.mul_const(total, B), curve.neg(psum))
    return _fold_windows(curve, wsums, c)


# ---------------------------------------------------------------------------
# batched-affine Pippenger: any tower field, array code
# ---------------------------------------------------------------------------

def _affine_tree_levels(curve, pt, stop: int):
    """Dyadic up-sweep over flat (x, y, inf) lanes until ``stop`` lanes are
    left: levels[l] holds the sums of 2^l adjacent sorted points."""
    levels = [pt]
    while pt[0].shape[0] > stop:
        pt = _aff_add(curve.batch_affine_add, *_halves(pt))
        levels.append(pt)
    return levels


def msm_affine(curve: SWCurveOps, xs, ys, scalar_digits,
               c: int | None = None, nbits: int | None = None,
               inf_mask=None, window_chunk: int | None = None):
    """Variable-base MSM with batched-affine additions throughout: every
    addition is ``curve.batch_affine_add`` (~7 field multiplies with the
    shared inversion, against 14 for the unified projective form).  Same
    contract as ``msm_hybrid``, over any tower field (xs, ys [N, K, nd]).
    A chunk of windows shares each addition, hence each root inversion."""
    xs, ys, inf_mask, c, W, chunks = _window_chunks(
        curve, xs, ys, scalar_digits, c, nbits, inf_mask, window_chunk)
    n = xs.shape[0]
    wc = chunks.shape[1]
    B = (1 << c) - 1
    F = curve.F

    def fenwick_step(acc, level, gidx, take):
        return _aff_select(take, _aff_add(curve.batch_affine_add, acc,
                                          _gather(level, gidx)), acc)

    def one_chunk(keys):
        """Window sums of the chunk as affine (x, y, inf) [wc]."""
        keys_s, pt = _sorted_chunk(xs, ys, inf_mask, keys)
        levels = _affine_tree_levels(curve, pt, wc)
        total = levels[-1]
        lanes = wc * B
        zero = xs.new_zeros((lanes,) + xs.shape[1:])
        acc = (zero, zero, torch.ones(lanes, dtype=torch.bool,
                                      device=xs.device))
        px, py, pinf = _fenwick_prefixes(
            levels, n, _bucket_counts(keys_s, c), B, acc, fenwick_step)
        # suffix_b = Total - prefix_b ; window sum = sum_b suffix_b
        win_id = torch.arange(lanes, device=xs.device) // B
        suffix = _aff_add(curve.batch_affine_add, _gather(total, win_id),
                          (px, F.neg(py), pinf))
        # pad B = 2^c - 1 to 2^c per window with infinity, then reduce
        pad = (suffix[0].new_zeros((wc, 1) + xs.shape[1:]),) * 2 + (
            pinf.new_ones((wc, 1)),)
        padded = tuple(torch.cat([s.reshape((wc, B) + s.shape[1:]), z], dim=1)
                       .reshape((wc * (B + 1),) + s.shape[1:])
                       for s, z in zip(suffix, pad))
        return _affine_tree_levels(curve, padded, wc)[-1]

    parts = [one_chunk(keys) for keys in chunks]
    wx, wy, winf = (torch.cat([p[k] for p in parts])[:W] for k in range(3))
    return _fold_windows(curve, _aff_to_proj(curve, (wx, wy, winf)), c)


# ---------------------------------------------------------------------------
# prover-facing entries
# ---------------------------------------------------------------------------

def msm_batched(curve: SWCurveOps, jobs, c: int | None = None):
    """Prover-facing entry for several independent MSMs over one curve.

    jobs: list of (xs, ys, scalar_digits, inf_mask or None).  Returns one
    projective point per job.  The jobs below 2^12 points share one
    double-and-add loop (the values of separate ``msm_naive`` calls); each
    larger job goes to Pippenger on its own: ``msm_hybrid`` where the fused
    curve kernels cover the curve, else ``msm_affine``.
    """
    out = [None] * len(jobs)
    small = [i for i, j in enumerate(jobs) if j[0].shape[0] < NAIVE_BELOW]
    if small:
        for i, res in zip(small, _msm_lanes(curve, [jobs[i] for i in small])):
            out[i] = res
    bucketed = msm_hybrid if EK.supports(curve) else msm_affine
    for i, (xs, ys, sd, inf) in enumerate(jobs):
        if out[i] is None:
            out[i] = bucketed(curve, xs, ys, sd, c=c, inf_mask=inf)
    return out


def msm_bucketed(curve: SWCurveOps, xs, ys, scalar_digits, inf_mask=None,
                 c: int | None = None):
    """Prover-facing entry for one MSM: ``msm_batched`` with one job."""
    return msm_batched(curve, [(xs, ys, scalar_digits, inf_mask)], c=c)[0]


def fixed_base_msm(curve: SWCurveOps, base_affine, scalar_digits):
    """[k_i]G for many scalars of one base: the base broadcast over the
    batch, then batched double-and-add.  Returns projective points [N]."""
    gx, gy = base_affine
    shape = (scalar_digits.shape[0],) + tuple(gx.shape[-2:])
    return curve.mul_scalar_digits(
        curve.from_affine(gx.expand(shape), gy.expand(shape)), scalar_digits)


# ---------------------------------------------------------------------------
# fixed base: the windowed table (setup's path)
# ---------------------------------------------------------------------------

def _window_bases(curve: SWCurveOps, base_affine, w: int, W: int):
    """2^k B_i = 2^(w i + k) B for i < W, k < w, as affine (x, y)
    [W, w, K, nd] on the curve's device: the chain of w W - 1 doublings of
    one point, walked by a host ladder in python ints (one modular inverse a
    doubling, milliseconds in all), where the device would pay ~30 launches
    a doubling over Fq and ten times that over Fq2 or Fq3."""
    F, fq = curve.F, curve.fp
    p, K, nd = fq.modulus, F.K, fq.n_digits
    nr = 0 if K == 1 else fpmod.fp_to_int(fq, torch.as_tensor(
        F.nonresidue())[0])
    hmul, hinv = host_ext.ext_ops(p, nr, K)
    a = [v % p for v in host_ext.flatten(curve.a_host)]
    x = fpmod.fp_to_ints(fq, base_affine[0].reshape(K, nd).cpu())
    y = fpmod.fp_to_ints(fq, base_affine[1].reshape(K, nd).cpu())
    xs, ys = [], []
    for step in range(W * w):
        if step:
            if not any(y):
                raise ValueError("fixed_base_table: the base has even order")
            xx = hmul(x, x)
            lam = hmul([(3 * u + v) % p for u, v in zip(xx, a)],
                       hinv([2 * v % p for v in y]))
            x3 = [(u - 2 * v) % p for u, v in zip(hmul(lam, lam), x)]
            y = [(u - v) % p for u, v in zip(
                hmul(lam, [(u - v) % p for u, v in zip(x, x3)]), y)]
            x = x3
        xs.extend(x)
        ys.extend(y)
    return tuple(torch.from_numpy(fpmod.fp_from_ints(fq, v).reshape(
        W, w, K, nd)).to(curve.device) for v in (xs, ys))


def fixed_base_table(curve: SWCurveOps, base_affine, w: int, nbits: int):
    """The windowed multiples of one base (``fixed_base.rs:15-43``,
    ``get_window_table``): ((tx, ty), tinf) [W, 2^w, K, nd] and [W, 2^w] with
    T[i][j] = j 2^(w i) B, W = ceil(nbits / w), infinity as the flag with
    (0, 0) as coordinates: the JAX package's table, entry for entry.

    The points 2^k 2^(w i) B come from a host ladder (``_window_bases``);
    the multiples of all W windows then grow together in w levels, level k
    adding 2^k 2^(w i) B to entries 0 .. 2^k - 1 to give entries 2^k ..
    2^(k+1) - 1: ONE batched affine addition a level
    (``curve.batch_affine_add``: the curve kernels K5/K6 over the base
    field, the array form over Fq2), where the JAX package doubles and adds
    (two a level)."""
    W = -(-nbits // w)
    bx, by = _window_bases(curve, base_affine, w, W)
    K, nd = bx.shape[-2:]
    tx = bx.new_zeros((W, 1 << w, K, nd))
    ty = bx.new_zeros((W, 1 << w, K, nd))
    tinf = torch.ones((W, 1 << w), dtype=torch.bool, device=bx.device)
    for k in range(w):
        n = 1 << k
        (x, y), inf = curve.batch_affine_add(
            ((tx[:, :n].reshape(W * n, K, nd), ty[:, :n].reshape(W * n, K, nd)),
             tinf[:, :n].reshape(W * n)),
            ((bx[:, k:k + 1].expand(W, n, K, nd).reshape(W * n, K, nd),
              by[:, k:k + 1].expand(W, n, K, nd).reshape(W * n, K, nd)),
             tinf.new_zeros(W * n)))
        tx[:, n:2 * n] = x.reshape(W, n, K, nd)
        ty[:, n:2 * n] = y.reshape(W, n, K, nd)
        tinf[:, n:2 * n] = inf.reshape(W, n)
    return (tx, ty), tinf


# Every lane of the query's first tree level holds about a dozen field
# elements at once (the gathered points, the addition's numerators,
# denominators and inverses, its results).  A chunk of scalars is sized so
# that one of them, over that level's lanes, takes at most this many bytes
# of int64 digits: 8,192 scalars over MNT4-753 G1 (first level 2^19 lanes,
# ~2.5 GB in all), 4,096 over its G2.
_WINDOWED_LEVEL_BYTES = 1 << 28


def windowed_chunk(n_windows: int, K: int, nd: int) -> int:
    """Scalars a chunk of ``fixed_base_msm_windowed``: a power of two."""
    half = 1 << max(0, (n_windows - 1).bit_length() - 1)   # first level
    lanes = max(1, _WINDOWED_LEVEL_BYTES // (half * K * nd * 8))
    return 1 << (lanes.bit_length() - 1)


def fixed_base_msm_windowed(curve: SWCurveOps, table, scalar_digits,
                            w: int, nbits: int):
    """[k_i]B through a ``fixed_base_table`` of B (``fixed_base.rs:69-79``,
    ``windowed_mul``, batch-first): per scalar one table entry a window,
    then a tree of batched affine additions across the windows, padded to
    a power of two with infinity.  scalar_digits: standard-form digits
    [N, nd_r].  Returns ((x, y), inf), affine [N, K, nd] and [N], infinity
    as (0, 0).  The scalars go in chunks of ``windowed_chunk`` (memory)."""
    (tx, ty), tinf = table
    K, nd = tx.shape[-2:]
    digits = _window_digits(scalar_digits, w, nbits)      # [Ws, N]
    Ws, N = digits.shape
    if Ws > tx.shape[0]:
        raise ValueError(f"fixed_base_msm_windowed: {Ws} windows of scalars "
                         f"against a table of {tx.shape[0]}")
    W2 = 1 << max(0, (Ws - 1).bit_length())
    win = torch.arange(Ws, device=digits.device)[:, None]
    step = windowed_chunk(W2, K, nd)
    outs = []
    for s in range(0, N, step):
        d = digits[:, s:s + step]
        n = d.shape[1]
        gx = tx.new_zeros((W2, n, K, nd))
        gy = tx.new_zeros((W2, n, K, nd))
        gi = tinf.new_ones((W2, n))
        gx[:Ws] = tx[win, d]
        gy[:Ws] = ty[win, d]
        gi[:Ws] = tinf[win, d]
        # tree across the windows: window i with window i + h, so that
        # both operands of a level are contiguous views
        while gx.shape[0] > 1:
            h = gx.shape[0] // 2
            (gx, gy), gi = curve.batch_affine_add(
                ((gx[:h].reshape(h * n, K, nd), gy[:h].reshape(h * n, K, nd)),
                 gi[:h].reshape(h * n)),
                ((gx[h:].reshape(h * n, K, nd), gy[h:].reshape(h * n, K, nd)),
                 gi[h:].reshape(h * n)))
            gx, gy, gi = (gx.reshape(h, n, K, nd), gy.reshape(h, n, K, nd),
                          gi.reshape(h, n))
        outs.append((gx[0], gy[0], gi[0]))
    if not outs:
        empty = tx.new_zeros((0, K, nd))
        return (empty, empty.clone()), tinf.new_zeros(0)
    xs, ys, inf = (torch.cat([o[k] for o in outs]) for k in range(3))
    return (xs, ys), inf
