"""Fixed-width big-integer arithmetic on batched 16-bit digit tensors.

A big integer is an ``int64`` tensor whose last axis holds ``n`` little-endian
digits in base ``2**16``; all leading axes are batch axes.  The layout is the
JAX package's (``gingerlib_tpu/ops/limbs.py``) with ``int64`` in place of
``uint32``, so its arrays convert with a cast; ``fields/fp.py`` says why
``int64``.  With 64-bit lanes a schoolbook column sum (at most ``2n`` products
below ``2**32``) is exact without a lo/hi split, and carries are resolved in
one pass at the end.

These are the plain PyTorch building blocks: they run wherever their tensors
live.  On the GPU the field layer (``fields/fp.py``) sends multiplies, adds
and inverses to CUDA kernels instead and keeps these as the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DIGIT_BITS = 16
DIGIT_BASE = 1 << DIGIT_BITS
DIGIT_MASK = DIGIT_BASE - 1
DTYPE = torch.int64
NP_DTYPE = np.int64

# widest digit vector whose carry flags pack into one int64 (see
# _carry_lookahead); the widest field of the package, SW6 at 49 digits,
# needs 52
MAX_CARRY_WIDTH = 62


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------

def to_digits(x: int, n: int) -> np.ndarray:
    """Python int -> little-endian base-2^16 digit vector (numpy int64)."""
    if x < 0:
        raise ValueError("to_digits expects a non-negative integer")
    if x >> (DIGIT_BITS * n):
        raise ValueError(f"integer does not fit in {n} digits")
    return to_digits_batch([x], n)[0]


def to_digits_batch(xs, n: int) -> np.ndarray:
    """Bulk conversion: int.to_bytes + frombuffer -> [len(xs), n] int64."""
    xs = list(xs)
    nbytes = 2 * n
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    return (np.frombuffer(buf, dtype="<u2")
            .reshape(len(xs), n).astype(NP_DTYPE))


def from_digits(d) -> int:
    """One digit vector -> python int (host side)."""
    d = _to_numpy(d)
    if d.ndim != 1:
        raise ValueError("from_digits expects a single digit vector")
    return from_digits_batch(d[None])[0]


def from_digits_batch(d) -> list:
    """Digit tensor/array [..., n] -> flat list of python ints."""
    d = _to_numpy(d)
    flat = d.reshape(-1, d.shape[-1]).astype("<u2")
    nbytes = 2 * flat.shape[-1]
    raw = flat.tobytes()
    return [int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "little")
            for i in range(flat.shape[0])]


def limbs32(digits) -> np.ndarray:
    """Host side: 16-bit digits [..., nd] -> 32-bit limbs (uint32), flat,
    two digits a limb, ceil(nd / 2) an element (the top one half full at an
    odd nd): the form the kernels keep constants in."""
    d = np.asarray(digits, dtype=np.uint32)
    if d.shape[-1] % 2:
        d = np.concatenate([d, np.zeros(d.shape[:-1] + (1,), np.uint32)], -1)
    d = d.reshape(-1)
    return d[0::2] | (d[1::2] << 16)


def _to_numpy(d) -> np.ndarray:
    if isinstance(d, torch.Tensor):
        return d.detach().cpu().numpy()
    return np.asarray(d)


def bits_msb_first(x: int, nbits: int) -> np.ndarray:
    """Host side: fixed python int -> bit array (int64), MSB first."""
    return np.array([(x >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                    dtype=NP_DTYPE)


# ---------------------------------------------------------------------------
# carry handling
# ---------------------------------------------------------------------------

_POW2_CACHE: dict = {}


def _bit_positions(n: int, device):
    """(arange(n), 2**arange(n)) on ``device``, cached."""
    key = (n, str(device))
    hit = _POW2_CACHE.get(key)
    if hit is None:
        idx = torch.arange(n, dtype=DTYPE, device=device)
        hit = (idx, torch.ones_like(idx) << idx)
        _POW2_CACHE[key] = hit
    return hit


def _carry_lookahead(d, carry_in: int = 0):
    """Exact carry resolution for digits <= 2^17 - 2 (carries in {0, 1}).

    Returns (digits < 2^16, carry out of the last digit).  The JAX package
    runs a log-depth generate/propagate scan here (``lax.associative_scan``).
    PyTorch has no such scan, and does not need one: a digit either generates
    a carry (>= 2^16), propagates one (== 2^16 - 1) or absorbs it, so the
    flags of up to 62 digits pack into two int64 words whose *sum* ripples
    all carries at once in the machine's own adder -- the carry into digit i
    is bit i of (X + Y + cin) ^ X ^ Y with X = generate|propagate,
    Y = generate.
    """
    n = d.shape[-1]
    if n > MAX_CARRY_WIDTH:
        raise ValueError(f"carry resolution is built for at most "
                         f"{MAX_CARRY_WIDTH} digits, got {n}")
    idx, pow2 = _bit_positions(n + 1, d.device)
    lo = d & DIGIT_MASK
    g = d >> DIGIT_BITS
    gp = g | (lo == DIGIT_MASK)
    x = (gp * pow2[:n]).sum(-1)
    y = (g * pow2[:n]).sum(-1)
    carries = ((x + y + carry_in) ^ x ^ y).unsqueeze(-1) >> idx & 1
    out = (lo + carries[..., :n]) & DIGIT_MASK
    return out, carries[..., n]


def _split(v):
    """One local pass: keep the low 16 bits, add the rest to the next digit
    (what leaves the last digit is dropped)."""
    out = v & DIGIT_MASK
    out[..., 1:] += v[..., :-1] >> DIGIT_BITS
    return out


def normalize(x, out_digits: int | None = None, passes: int = 2):
    """Propagate carries so that every digit is < 2^16.

    ``x``: non-negative digit columns below 2^47, or below 2^62 with
    ``passes=3`` (any redundant form that the adds and products here give).
    Returns [..., out_digits]; overflow past the last digit is discarded
    (mod 2^(16*out_digits)).
    """
    n = x.shape[-1]
    if out_digits is None:
        out_digits = n
    if out_digits > n:
        x = F.pad(x, (0, out_digits - n))
    elif out_digits < n:
        x = x[..., :out_digits]
    # each local pass takes 16 bits off the excess: columns < 2^47 are
    # <= 2^16 + 2^15 after two, so the remaining carries are in {0, 1}
    for _ in range(passes):
        x = _split(x)
    y, _ = _carry_lookahead(x)
    return y


def sub_with_borrow(a, b):
    """a - b for normalized inputs: (diff mod 2^16n, borrow_out), where
    borrow_out is 1 where b > a.  Two's complement in base 2^16:
    a + ~b + 1, the +1 entering as the carry into digit 0."""
    s = a + (DIGIT_MASK - b)
    y, carry_out = _carry_lookahead(s, carry_in=1)
    return y, 1 - carry_out


def is_zero(a):
    return (a == 0).all(-1)


def eq(a, b):
    return (a == b).all(-1)


# ---------------------------------------------------------------------------
# multiplication
# ---------------------------------------------------------------------------

def mul_wide_raw(a, b, out_digits: int | None = None):
    """Schoolbook product -> un-normalized column sums.

    a: [..., n], b: [..., m] digits.  Result [..., out_digits] (default
    n + m): out[k] = sum_i a[i] * b[k - i], exact in int64 as long as the
    sums stay below 2^63 (normalized inputs: below min(n, m) * 2^32).

    Gather-free: pad b with zeros, view it as the Hankel matrix
    H[k, j] = b[k + j - (n-1)] (overlapping windows, no copy), and contract
    it with a reversed -- one multiply and one sum over [..., out_digits, n].
    """
    n, m = a.shape[-1], b.shape[-1]
    if out_digits is None:
        out_digits = n + m
    if m > out_digits:
        b = b[..., :out_digits]
        m = out_digits
    windows = F.pad(b, (n - 1, out_digits - m)).unfold(-1, n, 1)
    return (windows * a.flip(-1).unsqueeze(-2)).sum(-1)


def mul_lo(a, b, n_out: int, passes: int = 2):
    """Low n_out digits of a*b (the product mod 2^(16*n_out)).  ``a`` may
    be un-normalized as long as the column sums stay below 2^62; say so
    with ``passes=3``."""
    return normalize(
        mul_wide_raw(a[..., :n_out], b[..., :n_out], n_out), n_out, passes)


def shr1(w):
    """(w >> 1) across the digit axis (normalized digits)."""
    nxt = F.pad(w[..., 1:], (0, 1))
    return (w >> 1) | ((nxt & 1) << (DIGIT_BITS - 1))


def scalar_bits_msb_first(scalar_digits):
    """[..., nd] standard-form digits -> [..., 16*nd] bits, MSB first."""
    nd = scalar_digits.shape[-1]
    shifts = torch.arange(DIGIT_BITS - 1, -1, -1, dtype=DTYPE,
                          device=scalar_digits.device)
    bits = (scalar_digits.flip(-1).unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*scalar_digits.shape[:-1], nd * DIGIT_BITS)
