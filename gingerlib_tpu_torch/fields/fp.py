"""Prime fields Fp as batched Montgomery-form digit tensors.

Counterpart of ``gingerlib_tpu/fields/fp.py``.  Elements live in Montgomery
form (``a*R mod p``, ``R = 2^(16*n_digits)``) as tensors ``[..., n_digits]``
of 16-bit little-endian digits.

Boundary dtype: ``torch.int64``, on the CPU and on the GPU alike.  The JAX
package keeps the digits in ``uint32``; PyTorch's CPU kernels hardly cover
``uint32`` arithmetic, and signed ``int32`` overflows on ``0xFFFF * 0xFFFF``
and shifts arithmetically.  ``int64`` holds every digit product and every
schoolbook column sum exactly, so the plain versions need no lo/hi split, and
one dtype everywhere means no casts between the plain path and the kernels.
A numpy array of the JAX package converts with ``astype(np.int64)``.  The
kernel wrappers raise on any other dtype.  Inside the kernels two digits are
packed into one 32-bit limb, ``(n_digits + 1) // 2`` limbs an element, and
``R`` stays ``2^(16*n_digits)``: at an odd count (19: MNT6-298, 49: SW6) the
top limb holds one digit and the multiply's last reduction row divides by
2^16 (``csrc/fp_limbs.cuh``).  The field kernels are built for
``KERNEL_DIGITS``; K3 (``pow_const``) for ``POW_DIGITS`` only.  A width that
is not built raises ``NotImplementedError`` on the card.

Dispatch (the one place where CPU and GPU part ways): ``mont_mul``,
``add_mod``, ``sub_mod``, ``neg_mod``, ``inv_bea`` and ``pow_const`` look at
where their tensors live.  If any operand is a CUDA tensor the call goes to the
hand-written kernel in ``csrc/``, whose wrapper raises unless all operands
are on that device; CPU tensors go to the plain PyTorch version beside it.
There is no fallback and no switch.

Kernels held here (source notes in the ``.cu`` files):

* ``mont_mul``  -> ``csrc/mont_mul.cu``; replaces ``mont_mul_pallas_t`` and
  its layout siblings (``gingerlib_tpu/ops/pallas_mont.py``).  One thread
  per element, CIOS on 32-bit limbs in registers; blocks stream tiles of
  operand rows through shared memory, the next tile in flight while the
  current one multiplies.  Its floor on the card is set by the integer
  multiply-adds (``2*L*L + L`` per element, ``L`` limbs), not by the
  ``3 * 2 * n_digits`` bytes of information it moves; the int64 boundary
  layout makes it move four times those bytes.
* ``inv_bea``   -> ``csrc/inv_bea.cu``; replaces ``inv_bea_pallas``.  One
  thread per element runs batched divsteps (Pornin's optimized binary GCD,
  ``csrc/fp_inv.cuh``: 31 divsteps on 64-bit approximations a pass, their
  matrix applied to the full width) until done; a latency kernel (batch of
  one on the proving path).  The operation count gives a floor only: one
  serial thread cannot come near the card's peak rate.  The plain version
  keeps the masked binary extended Euclid; the inverse is unique, so both
  give the same digits.
* ``add_mod/sub_mod/neg_mod`` -> ``csrc/fp_addsub.cu``; no TPU kernel of
  their own (XLA fused them), added because eager launches of their plain
  form would dominate the prover.  Bound by bytes; streamed as the multiply
  is.
* ``pow_const`` -> ``csrc/pow_const.cu``; replaces ``pow_const_pallas``.  A
  group of threads per element runs the whole chain of a fixed exponent in
  one launch, by a fixed window that the launcher picks from the exponent
  (``pow_window``: w = 5 and ~927 multiplies an element at 753 bits, where
  the plain version's binary ladder takes ``bits + popcount``); bound by
  that chain, a dependent one per element.  It carries ``legendre`` and
  ``sqrt_mod``.

Each wrapper counts its launches in ``launch_counts``, and by digit count
in ``launch_digits`` (``count_launch``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import limbs
from ..ops.limbs import DIGIT_BITS, DIGIT_MASK, DTYPE


@dataclass(frozen=True)
class FpParams:
    """Static description of a prime field."""

    name: str
    modulus: int
    generator: int  # multiplicative generator (non-residue), standard form
    two_adicity: int | None = None
    root_of_unity: int | None = None  # 2^two_adicity-th root, standard form

    # -- derived (computed in __post_init__) --
    n_digits: int = field(default=0)
    modulus_bits: int = field(default=0)
    r: int = field(default=0)
    r2: int = field(default=0)
    r_inv: int = field(default=0)
    nprime: int = field(default=0)  # -p^-1 mod R
    t: int = field(default=0)  # odd part: p - 1 = t * 2^two_adicity

    def __post_init__(self):
        p = self.modulus
        bits = p.bit_length()
        n = -(-bits // DIGIT_BITS)
        R = 1 << (DIGIT_BITS * n)
        object.__setattr__(self, "modulus_bits", bits)
        object.__setattr__(self, "n_digits", n)
        object.__setattr__(self, "r", R % p)
        object.__setattr__(self, "r2", (R * R) % p)
        object.__setattr__(self, "r_inv", pow(R % p, -1, p))
        object.__setattr__(self, "nprime", (-pow(p, -1, R)) % R)
        ta = self.two_adicity
        if ta is None:
            ta = 0
            q = p - 1
            while q % 2 == 0:
                q //= 2
                ta += 1
            object.__setattr__(self, "two_adicity", ta)
        object.__setattr__(self, "t", (p - 1) >> self.two_adicity)
        if self.root_of_unity is None:
            object.__setattr__(
                self, "root_of_unity", pow(self.generator, self.t, p))
        object.__setattr__(self, "_tensors", {})

    def __hash__(self):
        return hash((self.name, self.modulus))

    def __eq__(self, other):
        return isinstance(other, FpParams) and self.modulus == other.modulus \
            and self.name == other.name

    # --- host-side constant digit vectors (numpy int64) ---
    @functools.cached_property
    def modulus_digits(self) -> np.ndarray:
        return limbs.to_digits(self.modulus, self.n_digits)

    @functools.cached_property
    def nprime_digits(self) -> np.ndarray:
        return limbs.to_digits(self.nprime, self.n_digits)

    @functools.cached_property
    def one_mont(self) -> np.ndarray:
        return limbs.to_digits(self.r, self.n_digits)

    @functools.cached_property
    def r2_digits(self) -> np.ndarray:
        return limbs.to_digits(self.r2, self.n_digits)

    @functools.cached_property
    def r3_digits(self) -> np.ndarray:
        """R^3 mod p: brings the plain inverse of a Montgomery-form value
        back to Montgomery form with one multiply."""
        return limbs.to_digits(pow(self.r, 3, self.modulus), self.n_digits)

    # exponent bit arrays (MSB first) for the fixed-exponent ladder
    @functools.cached_property
    def inv_exp_bits(self) -> np.ndarray:  # p - 2
        e = self.modulus - 2
        return limbs.bits_msb_first(e, e.bit_length())

    @functools.cached_property
    def legendre_exp_bits(self) -> np.ndarray:  # (p-1)/2
        e = (self.modulus - 1) >> 1
        return limbs.bits_msb_first(e, e.bit_length())

    @functools.cached_property
    def sqrt_exp_bits(self) -> np.ndarray:  # (t-1)/2 for Tonelli-Shanks
        e = (self.t - 1) >> 1
        return limbs.bits_msb_first(e, max(1, e.bit_length()))

    @functools.cached_property
    def ts_c_mont(self) -> np.ndarray:
        """Tonelli-Shanks initial c = generator^t, in Montgomery form."""
        c = pow(self.generator, self.t, self.modulus)
        return limbs.to_digits(c * self.r % self.modulus, self.n_digits)

    # --- what the kernels take: the modulus as 32-bit limbs (host memory)
    # and -p^-1 mod 2^32 ---
    @functools.cached_property
    def modulus_limbs32(self) -> np.ndarray:
        n = (self.n_digits + 1) // 2
        return np.frombuffer(self.modulus.to_bytes(4 * n, "little"),
                             dtype="<u4").copy()

    @functools.cached_property
    def limbs_ptr(self) -> int:
        """Host address of ``modulus_limbs32`` (the array lives as long as
        this object)."""
        return self.modulus_limbs32.ctypes.data

    @functools.cached_property
    def inv32(self) -> int:
        return self.nprime & 0xFFFFFFFF

    @functools.cached_property
    def kernel_consts(self) -> np.ndarray:
        """[p | 0 | one] as 32-bit limbs in host memory: the [p | a | one]
        that the kernels of a curve take, for the field alone (a = 0)."""
        n = (self.n_digits + 1) // 2
        return np.concatenate([
            self.modulus_limbs32, np.zeros(n, dtype="<u4"),
            np.frombuffer(self.r.to_bytes(4 * n, "little"), dtype="<u4")])

    def tensor(self, name: str, device) -> torch.Tensor:
        """The constant digit vector ``name`` (``modulus_digits``,
        ``one_mont`` ...) as a tensor on ``device``, cached."""
        key = (name, str(device))
        hit = self._tensors.get(key)
        if hit is None:
            hit = torch.from_numpy(getattr(self, name)).to(device)
            self._tensors[key] = hit
        return hit


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# digit counts the kernels are built for: K1, add/sub/neg, K2 and the curve
# kernels (ops/ec_kernels.py) at all five, K3 at three
KERNEL_DIGITS = (16, 19, 24, 48, 49)
POW_DIGITS = (16, 24, 48)
launch_counts = {"mont_mul": 0, "inv_bea": 0, "fp_add": 0, "fp_sub": 0,
                 "fp_neg": 0,
                 # the curve kernels of ops/ec_kernels.py count here too
                 "ec_proj_add": 0, "ec_affine_pre": 0, "ec_affine_post": 0,
                 "inv_tree_up": 0, "inv_tree_tail": 0, "inv_tree_down": 0,
                 "pow_const": 0,
                 # and the Poseidon kernel of ops/poseidon_kernels.py
                 "poseidon_permute": 0,
                 # and the RNS kernels of ops/rns_kernels.py, ops/ec_rns.py
                 "rns_mont": 0, "ecr_pre": 0, "ecr_post": 0}


# the same launches by digit count: {kernel: {n_digits: launches}}
launch_digits = {k: {} for k in launch_counts}


def count_launch(name: str, n_digits: int | None):
    """One launch of kernel ``name`` at ``n_digits`` (None: not counted by
    width): what every wrapper calls where it launches."""
    launch_counts[name] += 1
    if n_digits is not None:
        by_width = launch_digits[name]
        by_width[n_digits] = by_width.get(n_digits, 0) + 1


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0
        launch_digits[k].clear()


def _check_operand(params: FpParams, x, what: str, built=KERNEL_DIGITS):
    if x.dtype != DTYPE:
        raise TypeError(f"{what}: digits must be {DTYPE}, got {x.dtype}")
    if x.shape[-1] != params.n_digits:
        raise ValueError(f"{what}: last axis must hold {params.n_digits} "
                         f"digits, got {x.shape[-1]}")
    if params.n_digits not in built:
        raise NotImplementedError(
            f"{what}: the CUDA kernels are built for n_digits in "
            f"{built}, not {params.n_digits} ({params.name})")
    if not x.is_cuda:
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got one "
                         f"on {x.device}")


def _raw_stream(x) -> int:
    """PyTorch's current stream on the tensor's device, which must be the
    current device (the kernels launch there)."""
    index = x.device.index
    if index != torch.cuda.current_device():
        raise ValueError(f"tensor on {x.device}, but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return torch.cuda.current_stream(index).cuda_stream


def _align(nd: int) -> int:
    """The mask of a row's address bits that must be zero: 16-byte rows at
    an even digit count, 8-byte (one digit) at an odd one, whose rows the
    kernels read digit by digit."""
    return 15 if nd % 2 == 0 else 7


def _rows(x, out_shape):
    """(tensor, rows, stride): row ``i % rows`` of the tensor, rows
    ``stride`` digits apart, is what broadcasting ``x`` to ``out_shape``
    puts at flat row ``i``.  No copy is made when ``x`` is one row, matches
    a trailing part of ``out_shape``, or is a view whose rows are evenly
    spaced (one component of an extension-field tensor, every other row of
    a table); any other layout or broadcast is materialised."""
    nd = x.shape[-1]
    align = _align(nd)
    if x.shape == out_shape and x.is_contiguous() and not x.data_ptr() & align:
        return x, x.numel() // nd, nd     # the common case, a few 10^5/proof
    lead = x.shape[:-1]
    k = len(lead)
    while k and lead[len(lead) - k] == 1:
        k -= 1                       # leading 1s broadcast for free
    core = tuple(lead[len(lead) - k:])
    if k and core != tuple(out_shape[len(out_shape) - 1 - k:-1]):
        x = x.expand(out_shape)
        core = tuple(out_shape[:-1])
        k = len(core)
    stride = _row_stride(x, k)
    if stride is None or x.data_ptr() & align:
        x = x.contiguous()
        if x.data_ptr() & align:
            x = x.clone()
        stride = nd
    rows = 1
    for s in core:
        rows *= s
    return x, rows, stride


def _row_stride(x, k: int):
    """Distance in digits between consecutive rows of the last ``k`` batch
    axes of ``x`` if it is one positive number, even at an even digit
    count, else None."""
    if x.stride(-1) != 1:
        return None
    stride = span = None
    for d in range(x.dim() - 2, x.dim() - 2 - k, -1):
        size = x.shape[d]
        if size == 1:
            continue
        if span is None:
            stride = x.stride(d)
        elif x.stride(d) != span:
            return None
        span = x.stride(d) * size
    if stride is None:
        return x.shape[-1]
    even = x.shape[-1] % 2 == 0
    return stride if stride > 0 and (stride % 2 == 0 or not even) else None


_kernel_fns: dict = {}


def _kernel(name: str):
    fn = _kernel_fns.get(name)
    if fn is None:
        from ..ops import cuda_lib
        fn = _kernel_fns[name] = cuda_lib.function(name)
    return fn


def use_kernels(fns: dict):
    """Make every wrapper launch the given C entry points ({name: function},
    as ``cuda_lib.load`` returns them) in place of those it launched so far:
    two builds of a kernel can then be held against each other under the
    same Python."""
    _kernel_fns.update(fns)


def _launch_binary(params: FpParams, a, b, name: str, op: int | None):
    """One launch of the multiply (op None) or add/sub/neg kernel."""
    _check_operand(params, a, name)
    if b is not a:
        _check_operand(params, b, name)
        if b.device != a.device:
            raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    nd = params.n_digits
    out_shape = a.shape if b.shape == a.shape else \
        torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(out_shape, dtype=DTYPE, device=a.device)
    n = out.numel() // nd
    a_c, a_rows, a_stride = _rows(a, out_shape)
    b_c, b_rows, b_stride = _rows(b, out_shape)
    if n >= 1 << 31:
        raise ValueError(f"{name}: batch of {n} elements is too large")
    if op is None:
        rc = _kernel("gl_mont_mul")(
            nd, a_c.data_ptr(), a_rows, a_stride, b_c.data_ptr(), b_rows,
            b_stride, out.data_ptr(), n, params.limbs_ptr, params.inv32,
            _raw_stream(a))
    else:
        rc = _kernel("gl_fp_addsub")(
            nd, op, a_c.data_ptr(), a_rows, a_stride, b_c.data_ptr(), b_rows,
            b_stride, out.data_ptr(), n, params.limbs_ptr, _raw_stream(a))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (code {rc})")
    if n:
        count_launch(name, nd)
    return out


def mont_mul_cuda(params: FpParams, a, b):
    """Launch the Montgomery-multiply kernel on CUDA tensors."""
    return _launch_binary(params, a, b, "mont_mul", None)


def inv_bea_cuda(params: FpParams, a):
    """Launch the inverse kernel on a CUDA tensor."""
    _check_operand(params, a, "inv_bea")
    a_c = a.contiguous()
    if a_c.data_ptr() & _align(params.n_digits):
        a_c = a_c.clone()
    out = torch.empty_like(a_c)
    n = out.numel() // params.n_digits
    rc = _kernel("gl_inv_bea")(
        params.n_digits, a_c.data_ptr(), out.data_ptr(), n,
        params.limbs_ptr, params.inv32, _raw_stream(a))
    if rc != 0:
        raise RuntimeError(f"inv_bea: kernel launch failed (code {rc})")
    if n:
        count_launch("inv_bea", params.n_digits)
    return out


# ---------------------------------------------------------------------------
# modular add / sub / neg  (Montgomery or plain form alike)
# ---------------------------------------------------------------------------

def add_mod_plain(params: FpParams, a, b):
    n = params.n_digits
    # a + b < 2p: digits <= 2^17 - 2, one spare digit catches the carry
    s, _ = limbs._carry_lookahead(F.pad(a + b, (0, 1)))
    pmod = F.pad(params.tensor("modulus_digits", s.device), (0, 1))
    diff, borrow = limbs.sub_with_borrow(s, pmod)
    return torch.where((borrow != 0).unsqueeze(-1), s, diff)[..., :n]


def sub_mod_plain(params: FpParams, a, b):
    diff, borrow = limbs.sub_with_borrow(a, b)
    # where borrowed, add p back (the wrap past the top digit is dropped)
    fixed, _ = limbs._carry_lookahead(
        diff + params.tensor("modulus_digits", diff.device))
    return torch.where((borrow != 0).unsqueeze(-1), fixed, diff)


def neg_mod_plain(params: FpParams, a):
    p_minus_a, _ = limbs.sub_with_borrow(
        params.tensor("modulus_digits", a.device), a)
    return torch.where(limbs.is_zero(a).unsqueeze(-1), a, p_minus_a)


def add_mod(params: FpParams, a, b):
    if a.is_cuda or b.is_cuda:
        return _launch_binary(params, a, b, "fp_add", 0)
    return add_mod_plain(params, a, b)


def sub_mod(params: FpParams, a, b):
    if a.is_cuda or b.is_cuda:
        return _launch_binary(params, a, b, "fp_sub", 1)
    return sub_mod_plain(params, a, b)


def neg_mod(params: FpParams, a):
    if a.is_cuda:
        return _launch_binary(params, a, a, "fp_neg", 2)
    return neg_mod_plain(params, a)


def double_mod(params: FpParams, a):
    return add_mod(params, a, a)


# ---------------------------------------------------------------------------
# Montgomery multiplication
# ---------------------------------------------------------------------------

def _cond_sub_p(params: FpParams, x):
    """x in [0, 2p) as n+1 digits -> x mod p as n digits."""
    pmod = F.pad(params.tensor("modulus_digits", x.device), (0, 1))
    diff, borrow = limbs.sub_with_borrow(x, pmod)
    return torch.where((borrow != 0).unsqueeze(-1), x,
                       diff)[..., :params.n_digits]


def _ceil_shift(x):
    return (x + DIGIT_MASK) >> DIGIT_BITS


def mont_redc(params: FpParams, t_raw):
    """Montgomery reduction of un-normalized 2n-column product sums
    (columns below 2^39): (T + ((T mod R) * N' mod R) * p) / R, reduced.

    Three shortcuts that the 64-bit lanes allow, all exact:

    * m = (T mod R) * N' mod R is taken from the raw low columns of T (any
      column form of T mod R will do); its column sums stay below
      2^39 * 2^16 * n < 2^62;
    * the low half of T + m*p is a multiple of R by construction, so all it
      hands to the high half is the integer L/R.  With columns v_k < 2^40,
      everything below the top three columns adds less than 2^-23 to L/R,
      so L/R is the ceiling of the top three columns' share, and
      ceil(ceil(x)/2^16) = ceil(x/2^16) lets it be taken column by column;
    * hence no carry pass spans more than n + 1 digits.
    """
    n = params.n_digits
    dev = t_raw.device
    m = limbs.mul_lo(t_raw, params.tensor("nprime_digits", dev), n, passes=3)
    v = t_raw + limbs.mul_wide_raw(
        m, params.tensor("modulus_digits", dev), 2 * n)
    carry = _ceil_shift(v[..., n - 1] + _ceil_shift(
        v[..., n - 2] + _ceil_shift(v[..., n - 3])))
    hi = F.pad(v[..., n:], (0, 1))
    hi[..., 0] += carry
    return _cond_sub_p(params, limbs.normalize(hi))              # < 2p -> < p


def mont_mul_plain(params: FpParams, a, b):
    """a*b*R^-1 mod p in plain PyTorch: schoolbook product, then REDC by two
    more full products.  Canonical whenever a*b < R*p, so one operand may be
    any value below R."""
    return mont_redc(params, limbs.mul_wide_raw(a, b, 2 * params.n_digits))


def mont_mul(params: FpParams, a, b):
    if a.is_cuda or b.is_cuda:
        return mont_mul_cuda(params, a, b)
    return mont_mul_plain(params, a, b)


def mont_sqr(params: FpParams, a):
    return mont_mul(params, a, a)


def to_mont(params: FpParams, a):
    """standard form -> Montgomery form (multiply by R^2)."""
    return mont_mul(params, a, params.tensor("r2_digits", a.device))


def from_mont(params: FpParams, a):
    """Montgomery form -> standard form: REDC of the zero-extended value,
    which is a Montgomery multiply by the plain integer 1."""
    return mont_mul(params, a, _plain_one(params, a.device))


def _plain_one(params: FpParams, device):
    key = ("plain_one", str(device))
    hit = params._tensors.get(key)
    if hit is None:
        hit = torch.zeros(params.n_digits, dtype=DTYPE, device=device)
        hit[0] = 1
        params._tensors[key] = hit
    return hit


def lazy_reduce(params: FpParams, x):
    """Reduce raw digit sums to a canonical residue below p.

    x: [..., n] digit columns (below 2^31) whose integer value V is below
    R, e.g. sums of fewer than 2^15 residues.  Carries are resolved first
    (the kernels take normalized digits only), then V*R^-1 by one REDC and
    a multiply by R^2 give V mod p.
    """
    v = limbs.normalize(x, params.n_digits)
    return to_mont(params, from_mont(params, v))


# ---------------------------------------------------------------------------
# inversion
# ---------------------------------------------------------------------------

def inv_bea_plain(params: FpParams, a):
    """Plain-integer a^-1 mod p by masked binary extended Euclid in plain
    PyTorch: every lane takes one case of the algorithm per iteration until
    all lanes are done.  a: plain digits [..., nd] below p; 0 -> 0."""
    nd = params.n_digits
    dev = a.device
    pdig = params.tensor("modulus_digits", dev)
    one = _plain_one(params, dev)

    def is_one(w):
        return (w == one).all(-1)

    def half_mod(w):
        odd = (w[..., :1] & 1) == 1
        wp, _ = limbs._carry_lookahead(F.pad(w + pdig, (0, 1)))
        return limbs.shr1(torch.where(odd, wp, F.pad(w, (0, 1))))[..., :nd]

    u, v = a, pdig.expand(a.shape)
    b, c = one.expand(a.shape), torch.zeros_like(a)
    if a.numel() == nd:
        if bool(limbs.is_zero(a).all()):
            return torch.zeros_like(a)
        return _inv_bea_plain_one(params, u, v, b, c, half_mod, is_one)
    for _ in range(_bea_steps(nd)):
        done = is_one(u) | is_one(v) | limbs.is_zero(u)
        if bool(done.all()):
            break
        u_odd = (u[..., 0] & 1) == 1
        v_odd = (v[..., 0] & 1) == 1
        duv, ub = limbs.sub_with_borrow(u, v)
        dvu, _ = limbs.sub_with_borrow(v, u)
        u_ge_v = ub == 0
        live = ~done
        case_u = (live & ~u_odd).unsqueeze(-1)
        case_v = (live & u_odd & ~v_odd).unsqueeze(-1)
        case_s = (live & u_odd & v_odd & u_ge_v).unsqueeze(-1)
        case_t = (live & u_odd & v_odd & ~u_ge_v).unsqueeze(-1)
        u, v, b, c = (
            torch.where(case_u, limbs.shr1(u), torch.where(case_s, duv, u)),
            torch.where(case_v, limbs.shr1(v), torch.where(case_t, dvu, v)),
            torch.where(case_u, half_mod(b), torch.where(
                case_s, sub_mod_plain(params, b, c), b)),
            torch.where(case_v, half_mod(c), torch.where(
                case_t, sub_mod_plain(params, c, b), c)))
    else:
        raise ArithmeticError("inv_bea_plain: the loop did not end")
    res = torch.where(is_one(u).unsqueeze(-1), b, c)
    return torch.where(limbs.is_zero(a).unsqueeze(-1),
                       torch.zeros_like(res), res)


def _bea_steps(nd: int) -> int:
    """Steps the binary Euclid loop may take on nd-digit values: each
    subtraction is followed by a halving, and the halvings take at most
    the bits of u and v, so 2 (16 nd + 16 nd) steps end it on any input;
    ``inv_bea_plain`` raises past this many."""
    return 4 * DIGIT_BITS * nd + 64


def _inv_bea_plain_one(params: FpParams, u, v, b, c, half_mod, is_one):
    """``inv_bea_plain``'s loop on one non-zero element: the same steps, the
    same exits and the same bound, but only the case the element takes is
    computed (the batched form evaluates all four a step and selects; for
    one lane that is four times the work, and a shared inversion's root is
    always one lane)."""
    for _ in range(_bea_steps(params.n_digits)):
        if bool((is_one(u) | is_one(v) | limbs.is_zero(u)).all()):
            break
        if not int(u[..., 0].reshape(-1)[0]) & 1:
            u, b = limbs.shr1(u), half_mod(b)
        elif not int(v[..., 0].reshape(-1)[0]) & 1:
            v, c = limbs.shr1(v), half_mod(c)
        else:
            duv, ub = limbs.sub_with_borrow(u, v)
            if not bool(ub.any()):
                u, b = duv, sub_mod_plain(params, b, c)
            else:
                v, c = limbs.sub_with_borrow(v, u)[0], \
                    sub_mod_plain(params, c, b)
    else:
        raise ArithmeticError("inv_bea_plain: the loop did not end")
    return b if bool(is_one(u).all()) else c


def inv_bea(params: FpParams, a):
    """Plain-integer inverse (0 -> 0): kernel on the GPU, plain on the CPU."""
    if a.is_cuda:
        return inv_bea_cuda(params, a)
    return inv_bea_plain(params, a)


def inv_mod(params: FpParams, a):
    """a^-1, Montgomery in and out; 0 maps to 0.  The binary Euclid inverse
    of the stored value aR is (aR)^-1; one multiply by R^3 returns it to
    Montgomery form."""
    y = inv_bea(params, a)
    return mont_mul(params, y, params.tensor("r3_digits", a.device))


# ---------------------------------------------------------------------------
# exponentiation, Legendre symbol, square root
# ---------------------------------------------------------------------------

POW_MAX_BITS = 1024   # the longest exponent the kernel takes
POW_MAX_WINDOW = 5    # the widest window the kernel's table takes


def pow_window_muls(exp_bits, w: int) -> int:
    """Multiplies of the pow kernel's fixed-window chain at window ``w``
    for an MSB-first bit array: the table a^2 .. a^(2^w - 1) (2^w - 2),
    then w squarings a digit and one multiply a non-zero digit after the
    first non-zero one (``pow_window``); 0 for an exponent without a set
    bit."""
    digits = _window_digits(exp_bits, w)
    nz = [k for k, d in enumerate(digits) if d]
    if not nz:
        return 0
    return w * (len(digits) - 1 - nz[0]) + len(nz) - 1 + (1 << w) - 2


def _window_digits(exp_bits, w: int):
    bits = [int(b != 0) for b in np.asarray(exp_bits).reshape(-1).tolist()]
    bits = [0] * (-len(bits) % w) + bits
    return [int("".join(map(str, bits[k:k + w])), 2)
            for k in range(0, len(bits), w)]


def pow_window(exp_bits):
    """(w, digits) of the pow kernel's chain for an MSB-first bit array, as
    its launcher (``csrc/pow_const.cu``) picks them: the w in 1 ..
    ``POW_MAX_WINDOW`` with the fewest multiplies (``pow_window_muls``; the
    smaller w on a tie), and the exponent's w-bit digits, most significant
    first, the bits padded on the left to a multiple of w."""
    w = min(range(1, POW_MAX_WINDOW + 1),
            key=lambda k: (pow_window_muls(exp_bits, k), k))
    return w, _window_digits(exp_bits, w)


def pow_const_plain(params: FpParams, a, exp_bits):
    """a^e for a fixed exponent given as an MSB-first bit array, Montgomery
    in and out, in plain PyTorch: square, and multiply where the bit is
    set."""
    r = params.tensor("one_mont", a.device).expand(a.shape)
    for bit in np.asarray(exp_bits).tolist():
        r = mont_mul_plain(params, r, r)
        if bit:
            r = mont_mul_plain(params, r, a)
    return r


def pow_const_cuda(params: FpParams, a, exp_bits):
    """Launch the pow-chain kernel on a CUDA tensor: the whole chain in one
    launch, by a fixed window that its launcher picks from the exponent
    (``pow_window``)."""
    _check_operand(params, a, "pow_const", POW_DIGITS)
    bits = np.ascontiguousarray(np.asarray(exp_bits) != 0, dtype=np.uint8)
    if bits.ndim != 1 or bits.size > POW_MAX_BITS:
        raise ValueError(f"pow_const: the kernel takes one exponent of at "
                         f"most {POW_MAX_BITS} bits, got shape {bits.shape}")
    a_c = a.contiguous()
    if a_c.data_ptr() & 15:
        a_c = a_c.clone()
    out = torch.empty_like(a_c)
    n = out.numel() // params.n_digits
    rc = _kernel("gl_pow_const")(
        params.n_digits, a_c.data_ptr(), out.data_ptr(), n, bits.ctypes.data,
        bits.size, params.kernel_consts.ctypes.data, params.inv32,
        _raw_stream(a))
    if rc != 0:
        raise RuntimeError(f"pow_const: kernel launch failed (code {rc})")
    if n:
        count_launch("pow_const", params.n_digits)
    return out


def pow_const(params: FpParams, a, exp_bits):
    """a^e, Montgomery in and out, for a fixed exponent given as an
    MSB-first bit array (host numpy): kernel on the GPU, plain on the CPU."""
    if a.is_cuda:
        return pow_const_cuda(params, a, exp_bits)
    return pow_const_plain(params, a, exp_bits)


def pow_dyn(params: FpParams, a, exp_digits):
    """a^e with an exponent per element, given as standard-form digits
    [..., k]: the bits of all k digits, MSB first, each a squaring and a
    selected multiply (array code over ``mont_mul``)."""
    n_bits = exp_digits.shape[-1] * DIGIT_BITS
    r = params.tensor("one_mont", a.device).expand(a.shape)
    for i in range(n_bits - 1, -1, -1):
        r = mont_sqr(params, r)
        bit = (exp_digits[..., i // DIGIT_BITS] >> (i % DIGIT_BITS)) & 1
        r = torch.where((bit != 0).unsqueeze(-1), mont_mul(params, r, a), r)
    return r


def legendre(params: FpParams, a):
    """Legendre symbol of each element: 1 (a non-zero square), -1 (not a
    square), 0 (zero), as int32."""
    s = pow_const(params, a, params.legendre_exp_bits)
    one = torch.ones((), dtype=torch.int32, device=a.device)
    sym = torch.where(limbs.eq(s, params.tensor("one_mont", a.device)),
                      one, -one)
    return torch.where(limbs.is_zero(s), torch.zeros_like(sym), sym)


def sqrt_mod(params: FpParams, a):
    """Tonelli-Shanks square root, Montgomery in and out: (root, mask).  The
    mask is False where ``a`` is not a square, and the root there is
    whatever the iterations left.

    The masked iterations of the JAX package (``two_adicity`` rounds, each
    finding the least k with b^(2^k) = 1 and squaring z m - k - 1 times),
    with each loop stopped once no lane would change any more: the same
    roots, fewer launches."""
    s = params.two_adicity
    dev = a.device
    one = params.tensor("one_mont", dev)

    w = pow_const(params, a, params.sqrt_exp_bits)     # a^((t-1)/2)
    x = mont_mul(params, a, w)                         # a^((t+1)/2)
    b = mont_mul(params, x, w)                         # a^t
    z = params.tensor("ts_c_mont", dev).expand(a.shape)  # c = g^t
    m = torch.full(a.shape[:-1], s, dtype=torch.int32, device=dev)

    for _ in range(max(s, 1)):
        # k: squarings of b until it is one (stops counting at one)
        v, k = b, torch.zeros_like(m)
        done = torch.zeros(m.shape, dtype=torch.bool, device=dev)
        for _ in range(s + 1):
            done = done | limbs.eq(v, one)
            if bool(done.all()):
                break
            k = torch.where(done, k, k + 1)
            v = torch.where(done.unsqueeze(-1), v, mont_sqr(params, v))
        active = k != 0
        if not bool(active.any()):
            break                       # no lane changes from here on
        times = m - k - 1               # squarings of z that give w
        w = z
        for i in range(max(s, 1)):
            if not bool((i < times).any()):
                break
            w = torch.where((i < times).unsqueeze(-1), mont_sqr(params, w), w)
        x2 = mont_mul(params, x, w)
        zw = mont_sqr(params, w)
        b2 = mont_mul(params, b, zw)
        sel = active.unsqueeze(-1)
        x = torch.where(sel, x2, x)
        z = torch.where(sel, zw, z)
        b = torch.where(sel, b2, b)
        m = torch.where(active, k, m)

    is_zero = limbs.is_zero(a)
    x = torch.where(is_zero.unsqueeze(-1), torch.zeros_like(x), x)
    # x^2 = a decides the mask: no x squares to a non-square
    return x, limbs.eq(mont_sqr(params, x), a) | is_zero


# ---------------------------------------------------------------------------
# batch inversion (Montgomery's trick)
# ---------------------------------------------------------------------------

def batch_inverse(params: FpParams, a, axis: int = 0):
    """Invert a whole batch with one inversion and 3 multiplies an element,
    by prefix products along ``axis`` (one launch a step, so a short axis);
    ``batch_inverse_tree`` is the log-depth form for a long flat batch.
    Zeros pass through as zeros."""
    moved = a.movedim(axis, 0)
    zero = limbs.is_zero(moved).unsqueeze(-1)
    one = params.tensor("one_mont", a.device)
    safe = torch.where(zero, one, moved)
    acc = one.expand(moved.shape[1:])
    prefix = []                         # products before each element
    for x in safe:
        prefix.append(acc)
        acc = mont_mul(params, acc, x)
    inv = inv_mod(params, acc)
    out = [None] * len(prefix)
    for i in range(len(prefix) - 1, -1, -1):
        out[i] = mont_mul(params, inv, prefix[i])
        inv = mont_mul(params, inv, safe[i])
    invs = torch.stack(out) if out else torch.empty_like(moved)
    return torch.where(zero, torch.zeros_like(invs), invs).movedim(0, axis)


def batch_inverse_tree(params: FpParams, a):
    """Invert a flat batch [N, nd] with ~3N multiplies and ONE inversion:
    pairwise products up a log-depth tree, invert the root, push the
    inverses back down.  Zeros pass through as zeros."""
    n = a.shape[0]
    zero_mask = limbs.is_zero(a).unsqueeze(-1)
    one = params.tensor("one_mont", a.device)
    x = torch.where(zero_mask, one, a)

    n2 = 1 << max(0, (n - 1).bit_length())
    if n2 != n:
        x = torch.cat([x, one.expand(n2 - n, -1)], dim=0)

    levels = [x]
    cur = x
    while cur.shape[0] > 1:
        cur = mont_mul(params, cur[0::2], cur[1::2])
        levels.append(cur)

    inv = inv_mod(params, levels[-1])  # [1, nd]
    for child in reversed(levels[:-1]):
        left, right = child[0::2], child[1::2]
        inv = torch.stack([mont_mul(params, inv, right),
                           mont_mul(params, inv, left)],
                          dim=1).reshape(child.shape)
    return torch.where(zero_mask, torch.zeros_like(a), inv[:n])


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def fp_from_int(params: FpParams, x: int) -> np.ndarray:
    """Python int -> Montgomery digit vector (host side, exact)."""
    return limbs.to_digits((x % params.modulus) * params.r % params.modulus,
                           params.n_digits)


def fp_from_ints(params: FpParams, xs) -> np.ndarray:
    p, r = params.modulus, params.r
    return limbs.to_digits_batch([int(x) % p * r % p for x in xs],
                                 params.n_digits)


def fp_to_int(params: FpParams, d) -> int:
    """Montgomery digit vector -> python int (host side)."""
    return limbs.from_digits(d) * params.r_inv % params.modulus


def fp_to_ints(params: FpParams, d) -> list:
    return [v * params.r_inv % params.modulus
            for v in limbs.from_digits_batch(d)]
