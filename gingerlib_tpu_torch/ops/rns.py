"""Residue-number-system (RNS) Montgomery arithmetic: context, python-int
golden model, and the vectorized model as PyTorch functions.

Counterpart of ``gingerlib_tpu/ops/rns.py`` (the port keeps its own copy).
Scheme (Kawamura et al., CHES 2000; Bajard-Didier-Kornerup): two coprime
bases A = {m_1..m_k}, B = {m'_1..m'_k} of 14-bit primes with M_A, M_B >
2^GUARD_BITS * p, and Montgomery reduction with R = M_A:

    s   = x * y                 (channelwise, both bases)
    q_A = s_A * (-p^-1 mod M_A) (channelwise in A)
    q_B = BaseExtend_{A->B}(q_A)
    t_B = (s_B + q_B * p) * M_A^-1   (channelwise in B; exact division)
    t_A = BaseExtend_{B->A}(t_B)
    t = x y M_A^-1 (mod p), t < 3p

Base extension: sigma_i = |x_i (M/m_i)^-1|_{m_i}, x = sum_i sigma_i M/m_i -
alpha M with alpha = floor(sum_i sigma_i / m_i), estimated from integer
weights w_i = floor(2^25 / m_i): sum sigma_i w_i underestimates 2^25 S by
less than k * 2^14 <= ALPHA_OFF, so

  - with the offset ALPHA_OFF the floor is exact whenever x/M < 1 - 2^-5
    (the t-extension, where t < 3p << M), and
  - without it the estimate never overestimates (the q-extension): an
    underestimate gives q + M_A, hence t + p, absorbed by the bounds.

The q-extension's estimate is part of the function: the residues of a
multiply (not only its value mod p) are those of the JAX package because
the port takes the very same estimate.

Value bounds: with mul inputs < c p and M > 2^g p, outputs are < 3p
whenever 2^g > c^2; g = 10 admits c = 24, the headroom the curve formulas of
``ops/ec_rns.py`` use between multiplies.

Residues are ``int64`` tensors ``[N, k]`` per base (exact for every product
and sum here).  The inner products over channels (base extensions, the
positional <-> RNS conversions) run as float64 matrix products: every term
and partial sum is an integer below 2^53, so they are exact on any device
and in any order of summation.  The kernels of ``ops/rns_kernels.py`` and
``ops/ec_rns.py`` compute the same functions.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from . import limbs as L

CH_BITS = 14
CH_MIN = 3 << (CH_BITS - 2)   # primes in (0.75, 1) * 2^14
CH_MAX = 1 << CH_BITS
W_BITS = 25                   # alpha weights w_i = floor(2^25 / m_i)
ALPHA_OFF = 1 << 20           # exact-floor offset (>= k * 2^14 error)
# Kawamura alpha terms sigma_i * w_i <= (m_i - 1) * floor(2^W_BITS / m_i)
# <= 2^W_BITS - w_min < 2^25 each; the 32-bit alpha sum of the kernels
# peaks at MAX_K * (2^25 - 2^11) = 2^31 - 2^17.  MAX_K guards it: raising
# W_BITS, CH_BITS or the channel count must trip this assert rather than
# silently corrupt every base extension.
MAX_K = 64
assert MAX_K * ((1 << W_BITS) - (1 << (W_BITS - CH_BITS))) < 2 ** 31, \
    "alpha row-sum would overflow int32"
GUARD_BITS = 10               # M > 2^10 p: mul inputs may reach 24p


def _sieve_primes(lo: int, hi: int):
    sieve = np.ones(hi, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(hi ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i::i] = False
    return [int(i) for i in range(hi - 1, lo, -1) if sieve[i]]


@dataclass(frozen=True)
class RNSContext:
    """Precomputed tables for one prime field p under a double RNS base."""

    p: int
    k: int
    mA: tuple          # k channel moduli of base A (R = M_A)
    mB: tuple
    MA: int
    MB: int
    # Kawamura sigma factors: |(M/m_i)^-1|_{m_i}
    sigA: tuple
    sigB: tuple
    # alpha weights floor(2^W_BITS / m_i)
    wA: tuple
    wB: tuple
    # base-extension matrices C[i][j] = |M_src/m_i|_{m_dst_j}
    extAB: np.ndarray  # [k, k]  A -> B
    extBA: np.ndarray
    # -alpha correction rows: |M_src|_{m_dst_j}
    MA_modB: np.ndarray
    MB_modA: np.ndarray
    # channelwise constants
    negpinv_A: tuple   # |-p^-1|_{m_i}, base A
    p_B: tuple         # |p|_{m'_j}
    MAinv_B: tuple     # |M_A^-1|_{m'_j}
    r_mod_p: int = field(init=False, default=0)      # M_A mod p

    def __post_init__(self):
        object.__setattr__(self, "r_mod_p", self.MA % self.p)


@functools.lru_cache(maxsize=8)
def make_context(p: int) -> RNSContext:
    k = -(-(p.bit_length() + GUARD_BITS) // (CH_BITS - 1))
    primes = _sieve_primes(CH_MIN, CH_MAX)
    while True:
        if len(primes) < 2 * k:
            raise ValueError("not enough 14-bit channel primes")
        mA = tuple(primes[:k])
        mB = tuple(primes[k:2 * k])
        MA = 1
        for m in mA:
            MA *= m
        MB = 1
        for m in mB:
            MB *= m
        if MA >> GUARD_BITS > p and MB >> GUARD_BITS > p:
            break
        k += 1
    assert k <= MAX_K, \
        f"k={k} channels would overflow the int32 alpha sum (MAX_K={MAX_K})"

    def sig(ms, M):
        return tuple(pow(M // m % m, -1, m) for m in ms)

    def ext_matrix(src, dst, Msrc):
        C = np.zeros((len(src), len(dst)), dtype=np.uint32)
        for i, mi in enumerate(src):
            big = Msrc // mi
            for j, mj in enumerate(dst):
                C[i, j] = big % mj
        return C

    return RNSContext(
        p=p, k=k, mA=mA, mB=mB, MA=MA, MB=MB,
        sigA=sig(mA, MA), sigB=sig(mB, MB),
        wA=tuple((1 << W_BITS) // m for m in mA),
        wB=tuple((1 << W_BITS) // m for m in mB),
        extAB=ext_matrix(mA, mB, MA),
        extBA=ext_matrix(mB, mA, MB),
        MA_modB=np.asarray([MA % m for m in mB], dtype=np.uint32),
        MB_modA=np.asarray([MB % m for m in mA], dtype=np.uint32),
        negpinv_A=tuple((-pow(p, -1, m)) % m for m in mA),
        p_B=tuple(p % m for m in mB),
        MAinv_B=tuple(pow(MA % m, -1, m) for m in mB),
    )


# ---------------------------------------------------------------------------
# python-int golden model
# ---------------------------------------------------------------------------

def to_rns_int(ctx: RNSContext, x: int):
    """x (< M) -> (residues_A, residues_B) as tuples of ints."""
    return (tuple(x % m for m in ctx.mA), tuple(x % m for m in ctx.mB))


def from_rns_int(ctx: RNSContext, xa) -> int:
    """CRT reconstruction from base A residues."""
    x = 0
    for i, m in enumerate(ctx.mA):
        Mi = ctx.MA // m
        x += xa[i] * (pow(Mi, -1, m) * Mi)
    return x % ctx.MA


def _alpha_est(sigmas, ws, exact: bool) -> int:
    """floor(sum sigma_i/m_i) from integer weights: exact with the offset
    (t-extension), never an overestimate without it (q-extension)."""
    t = sum(s * w for s, w in zip(sigmas, ws))
    if exact:
        t += ALPHA_OFF
    return t >> W_BITS


def base_extend_int(ctx: RNSContext, x_src, src: str,
                    exact: bool = True) -> tuple:
    """Extend residues from base `src` to the other base (golden model)."""
    if src == "A":
        ms, sig, ws, C, Mcorr, dst = (ctx.mA, ctx.sigA, ctx.wA, ctx.extAB,
                                      ctx.MA_modB, ctx.mB)
    else:
        ms, sig, ws, C, Mcorr, dst = (ctx.mB, ctx.sigB, ctx.wB, ctx.extBA,
                                      ctx.MB_modA, ctx.mA)
    sigmas = [x * s % m for x, s, m in zip(x_src, sig, ms)]
    alpha = _alpha_est(sigmas, ws, exact)
    out = []
    for j, mj in enumerate(dst):
        acc = sum(s * int(C[i, j]) for i, s in enumerate(sigmas))
        acc -= alpha * int(Mcorr[j])
        out.append(acc % mj)
    return tuple(out)


def mont_mul_rns_int(ctx: RNSContext, x, y):
    """(xa, xb), (ya, yb) -> (ta, tb) with t = x y M_A^-1 mod p."""
    xa, xb = x
    ya, yb = y
    sa = tuple(a * b % m for a, b, m in zip(xa, ya, ctx.mA))
    sb = tuple(a * b % m for a, b, m in zip(xb, yb, ctx.mB))
    qa = tuple(s * c % m for s, c, m in zip(sa, ctx.negpinv_A, ctx.mA))
    qb = base_extend_int(ctx, qa, "A", exact=False)
    tb = tuple((s + q * pj) * mi % m
               for s, q, pj, mi, m in zip(sb, qb, ctx.p_B,
                                          ctx.MAinv_B, ctx.mB))
    ta = base_extend_int(ctx, tb, "B", exact=True)
    return (ta, tb)


# ---------------------------------------------------------------------------
# vectorized model (channels on the last axis, int64 tensors)
# ---------------------------------------------------------------------------

_TABLES: dict = {}


def _table(ctx: RNSContext, name: str, device, build, dtype=L.DTYPE):
    """The constant ``name`` of ``ctx`` (numpy from ``build()``) as a tensor
    on ``device``, cached."""
    key = (ctx.p, name, str(device), dtype)
    hit = _TABLES.get(key)
    if hit is None:
        hit = torch.from_numpy(np.asarray(build(), dtype=np.int64)).to(
            device=device, dtype=dtype)
        _TABLES[key] = hit
    return hit


def _row(ctx, name, values, device):
    return _table(ctx, name, device, lambda: [int(v) for v in values])[None]


def _dot(a, C):
    """Exact a @ C for non-negative int64 tensors whose products and sums
    stay below 2^53 (every use here: at most 2^36), as a float64 product."""
    return torch.matmul(a.to(torch.float64), C).round().to(L.DTYPE)


def to_rns(ctx: RNSContext, xs, device=None) -> tuple:
    """list of python ints -> (resA [N, k], resB [N, k]) on ``device``."""
    device = resolve_device(device)
    ra = np.asarray([[x % m for m in ctx.mA] for x in xs], np.int64)
    rb = np.asarray([[x % m for m in ctx.mB] for x in xs], np.int64)
    ra = ra.reshape(len(xs), ctx.k)
    rb = rb.reshape(len(xs), ctx.k)
    return torch.from_numpy(ra).to(device), torch.from_numpy(rb).to(device)


def from_rns(ctx: RNSContext, ra) -> list:
    """residues (base A) -> python ints via CRT."""
    ra = ra.detach().cpu().numpy() if isinstance(ra, torch.Tensor) \
        else np.asarray(ra)
    return [from_rns_int(ctx, [int(v) for v in row]) for row in ra]


def _base_extend(ctx: RNSContext, x, src: str, exact: bool):
    """Vectorized Kawamura extension: x [N, k] -> [N, k] in the other
    base."""
    dev = x.device
    if src == "A":
        ms, sig, ws = ctx.mA, ctx.sigA, ctx.wA
        C, Mcorr, md = "extAB", ctx.MA_modB, ctx.mB
    else:
        ms, sig, ws = ctx.mB, ctx.sigB, ctx.wB
        C, Mcorr, md = "extBA", ctx.MB_modA, ctx.mA
    ms_t = _row(ctx, "m" + src, ms, dev)
    md_t = _row(ctx, "m" + ("B" if src == "A" else "A"), md, dev)
    sigma = x * _row(ctx, "sig" + src, sig, dev) % ms_t          # [N, k]
    t = (sigma * _row(ctx, "w" + src, ws, dev)).sum(-1)
    if exact:
        t = t + ALPHA_OFF
    alpha = t >> W_BITS                                          # [N]
    mat = _table(ctx, C, dev, lambda: getattr(ctx, C), torch.float64)
    acc = _dot(sigma, mat)
    corr = alpha[:, None] * _row(ctx, "corr" + src, Mcorr, dev)
    return (acc - corr) % md_t


def mont_mul_rns(ctx: RNSContext, x, y):
    """Vectorized RNS Montgomery multiply.  x, y: (resA, resB) [N, k];
    returns (resA, resB) of x*y*M_A^-1 mod p (values < 3p)."""
    xa, xb = x
    ya, yb = y
    dev = xa.device
    mA = _row(ctx, "mA", ctx.mA, dev)
    mB = _row(ctx, "mB", ctx.mB, dev)
    sa = xa * ya % mA
    sb = xb * yb % mB
    qa = sa * _row(ctx, "negpinv_A", ctx.negpinv_A, dev) % mA
    qb = _base_extend(ctx, qa, "A", exact=False)
    sqp = (sb + qb * _row(ctx, "p_B", ctx.p_B, dev) % mB) % mB
    tb = sqp * _row(ctx, "MAinv_B", ctx.MAinv_B, dev) % mB
    ta = _base_extend(ctx, tb, "B", exact=True)
    return (ta, tb)


# ---------------------------------------------------------------------------
# positional <-> RNS conversions
# ---------------------------------------------------------------------------
#
# to: x given as nd 16-bit digits -> residues: x mod m = sum_j d_j |2^16j|_m,
# a constant [nd, 2k] product.  from: CRT x = sum_i sigma_i M/m_i - alpha M
# accumulated in positional digit columns (constant digit matrices), then
# carry-resolved; valid for values < 4p, reduced canonical by conditional
# subtracts.

def pos_rns_matrix(ctx: RNSContext, nd: int) -> np.ndarray:
    """P2 [nd, 2k]: |2^(16 j)|_{m_i} over base A then base B."""
    ms = list(ctx.mA) + list(ctx.mB)
    P2 = np.zeros((nd, 2 * ctx.k), np.int64)
    for i, m in enumerate(ms):
        acc = 1 % m
        for j in range(nd):
            P2[j, i] = acc
            acc = acc * ((1 << 16) % m) % m
    return P2


def to_rns_digits(ctx: RNSContext, digits):
    """positional digits [N, nd] (plain value < 2^(16 nd)) -> (resA, resB)
    [N, k]."""
    nd = digits.shape[-1]
    dev = digits.device
    P2 = _table(ctx, f"P2_{nd}", dev, lambda: pos_rns_matrix(ctx, nd),
                torch.float64)
    ms = _row(ctx, "mAB", list(ctx.mA) + list(ctx.mB), dev)
    acc = _dot(digits, P2) % ms
    return acc[:, :ctx.k], acc[:, ctx.k:]


def crt_width(ctx: RNSContext) -> int:
    """Digits of the CRT accumulation: wide enough for sum_i sigma_i M_A/m_i
    < k M_A, with a spare digit."""
    return -(-(ctx.MA.bit_length() + 8) // 16) + 1


def crt_digit_matrices(ctx: RNSContext):
    """D [k, crt_width]: digit j of M_A/m_i; MD [crt_width]: digits of
    M_A."""
    nd_w = crt_width(ctx)
    D = np.stack([L.to_digits(ctx.MA // m, nd_w) for m in ctx.mA])
    return D, L.to_digits(ctx.MA, nd_w)


def from_rns_digits(ctx: RNSContext, ra, p_digits, nd: int):
    """residues (base A) [N, k] -> canonical positional digits [N, nd]
    (plain form), valid for represented values < 4p.

    CRT in digit space: sigma [N, k] x D [k, nd_wide], minus alpha*M_A
    digits, carry-resolved, then three conditional subtracts of p on nd+1
    digits."""
    dev = ra.device
    sigma = ra * _row(ctx, "sigA", ctx.sigA, dev) % _row(ctx, "mA", ctx.mA,
                                                         dev)
    t = (sigma * _row(ctx, "wA", ctx.wA, dev)).sum(-1) + ALPHA_OFF
    alpha = t >> W_BITS                                           # [N]
    D = _table(ctx, "crtD", dev, lambda: crt_digit_matrices(ctx)[0],
               torch.float64)
    MD = _table(ctx, "crtMD", dev, lambda: crt_digit_matrices(ctx)[1])
    nd_w = D.shape[1]
    cols = _dot(sigma, D)                        # columns < k 2^30 < 2^36
    cols_n = L.normalize(cols, nd_w + 1)
    sub_n = L.normalize(alpha[:, None] * MD[None], nd_w + 1)
    diff, _borrow = L.sub_with_borrow(cols_n, sub_n)
    out = diff[:, :nd + 1]
    pdw = torch.zeros(nd + 1, dtype=L.DTYPE, device=dev)
    pdw[:nd] = torch.as_tensor(np.asarray(p_digits, np.int64), device=dev)
    pd = pdw.expand(out.shape)
    for _ in range(3):
        d, b = L.sub_with_borrow(out, pd)
        out = torch.where((b == 0)[:, None], d, out)
    return out[:, :nd]
