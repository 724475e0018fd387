"""Evaluation domains over prime scalar fields: radix-2 and mixed radix.

Counterpart of ``gingerlib_tpu/ops/fft.py``: a reshape-based radix-2 FFT with
``log2(m)`` decimation steps (strided slicing, no bit-reversal scatter)
followed by ``log2(m)`` combine stages, each ONE batched Montgomery multiply
of m/2 elements plus one add and one subtract.  ``MixedRadixDomain`` extends
the same scheme to sizes 2^k * 5^s (radix-5 combines as r-point DFTs), for
fields whose two-adicity is too small (MNT6-753's Fr: 15); ``best_domain``
picks the radix-2 domain where it fits.

Twiddle and power tables are built on the device, once per domain and
base, by log2(n) doubling multiplies (``_build_powers_device``).  Coset
transforms go through ``distribute_powers``; division by the vanishing
polynomial on a coset is one constant multiply, since Z(g*w^j) = g^m - 1.
The Lagrange coefficients at a point (setup's QAP) share one batched
inversion on the device.

Elements: Montgomery digit tensors [..., m, n_digits]; the element axis is
axis -2.  The scan and four-step cores of the JAX package answer to its
compiler and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fields import fp as fpmod
from ..fields.fp import FpParams
from ..ops import limbs
from . import ec_kernels


class Domain:
    """Radix-2 multiplicative subgroup of size m = 2^lg (<= 2-adicity)."""

    def __init__(self, params: FpParams, size: int, device=None):
        self.device = resolve_device(device)
        m = 1
        lg = 0
        while m < size:
            m <<= 1
            lg += 1
        if lg > params.two_adicity:
            raise ValueError(
                f"domain size 2^{lg} exceeds two-adicity "
                f"{params.two_adicity} of {params.name}")
        self.params = params
        self.size = m
        self.lg = lg
        p = params.modulus
        self.gen = pow(params.root_of_unity, 1 << (params.two_adicity - lg), p)
        self.gen_inv = pow(self.gen, -1, p) if m > 1 else 1
        self.size_inv = pow(m, -1, p)
        # coset shift = the field's multiplicative generator
        self.coset_shift = params.generator
        self.coset_shift_inv = pow(self.coset_shift, -1, p)
        # Z(coset) = g^m - 1, constant across the coset
        self.z_coset = (pow(self.coset_shift, m, p) - 1) % p
        self.z_coset_inv = pow(self.z_coset, -1, p)
        self._tables: dict = {}   # (base, n) -> powers on the device

    # ------------------------------------------------------------------
    # tables (built on the device, cached there)
    # ------------------------------------------------------------------

    def _powers(self, base: int, n: int):
        hit = self._tables.get((base, n))
        if hit is None:
            hit = _build_powers_device(self.params, base, n, self.device)
            self._tables[(base, n)] = hit
        return hit

    def _const(self, x: int):
        return torch.from_numpy(
            fpmod.fp_from_int(self.params, x)).to(self.device)

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------

    def fft(self, coeffs):
        """coeffs [..., m, nd] (Montgomery) -> evaluations at w^j."""
        return _fft_core(self.params, coeffs,
                         self._powers(self.gen, self.size // 2))

    def ifft(self, evals):
        out = _fft_core(self.params, evals,
                        self._powers(self.gen_inv, self.size // 2))
        return fpmod.mont_mul(self.params, out, self._const(self.size_inv))

    def distribute_powers(self, x, base: int):
        """x_i *= base^i; base is a host int."""
        return fpmod.mont_mul(self.params, x, self._powers(base, self.size))

    def coset_fft(self, coeffs):
        return self.fft(self.distribute_powers(coeffs, self.coset_shift))

    def coset_ifft(self, evals):
        return self.distribute_powers(self.ifft(evals),
                                      self.coset_shift_inv)

    def divide_by_vanishing_poly_on_coset(self, evals):
        """evals on the coset / Z(x): one constant multiply."""
        return fpmod.mont_mul(self.params, evals,
                              self._const(self.z_coset_inv))

    def mul_in_evaluation_domain(self, a, b):
        return fpmod.mont_mul(self.params, a, b)

    # ------------------------------------------------------------------
    # Lagrange / vanishing evaluation at an arbitrary point
    # ------------------------------------------------------------------

    def evaluate_vanishing_polynomial(self, tau: int) -> int:
        return (pow(tau, self.size, self.params.modulus) - 1) \
            % self.params.modulus

    def evaluate_all_lagrange_coefficients(self, tau: int):
        """l_i(tau) for every i < m as Montgomery digits [m, nd] on the
        domain's device: l_i(tau) = Z(tau) w^i / (m (tau - w^i)), the m
        denominators through ONE shared inversion (``batch_inverse``).
        Where tau lies in the domain, l_i is 1 at its index and 0
        elsewhere."""
        P = self.params
        p = P.modulus
        m = self.size
        omega_pows = self._powers(self.gen, m)
        tau_d = self._const(tau)
        z = self.evaluate_vanishing_polynomial(tau)
        if z == 0:
            hit = limbs.eq(omega_pows, tau_d)
            return torch.where(hit[:, None], P.tensor("one_mont", self.device),
                               torch.zeros_like(omega_pows))
        denom = fpmod.sub_mod(P, tau_d.expand(omega_pows.shape), omega_pows)
        denom_inv = ec_kernels.batch_inverse(P, denom)
        num = fpmod.mont_mul(P, omega_pows,
                             self._const(z * pow(m, -1, p) % p))
        return fpmod.mont_mul(P, num, denom_inv)


def _build_powers_device(params: FpParams, base: int, n: int, device):
    """[1, base, ..., base^(n-1)] as Montgomery digits [n, nd] on ``device``,
    by log2(n) doubling multiplies: the table so far times base^(2^k).
    Always on the device: a 2^19-entry twiddle table of 753-bit python ints
    is a million host multiplies and conversions, against 19 launches
    (``chip_smoke.py``'s ``fft`` line times both)."""
    if n == 0:
        return torch.zeros((0, params.n_digits), dtype=limbs.DTYPE,
                           device=device)
    pw = params.tensor("one_mont", device)[None]
    step = base % params.modulus
    while pw.shape[0] < n:
        hi = fpmod.mont_mul(params, pw, torch.from_numpy(
            fpmod.fp_from_int(params, step)).to(device))
        pw = torch.cat([pw, hi], dim=0)
        step = step * step % params.modulus
    return pw[:n]


# the small prime of ``MixedRadixDomain``: MNT6-753's Fr, the field that
# needs the mixed radix, has 5^2 | p - 1
MIXED_RADIX = 5


class MixedRadixDomain:
    """Domain of size m = 2^k * q^s (q = ``MIXED_RADIX``, q^s | p - 1): the
    smallest such m at least ``size``.  The JAX package's extension of the
    radix-2 domain, so that MNT6-753's Fr (two-adicity 15, 5^2 | p - 1)
    carries circuits beyond 2^15 constraints.  Its generator is
    g^((p-1)/m) for the field's multiplicative generator g."""

    def __init__(self, params: FpParams, size: int, device=None):
        self.device = resolve_device(device)
        p = params.modulus
        q = MIXED_RADIX
        q_adicity, t = 0, p - 1
        while t % q == 0:
            t //= q
            q_adicity += 1
        best = None
        for s in range(q_adicity + 1):
            qs = q ** s
            rest = -(-size // qs)
            k = max(0, (rest - 1).bit_length())
            if k > params.two_adicity:
                continue
            m = (1 << k) * qs
            if m >= size and (best is None or m < best[0]):
                best = (m, k, s)
        if best is None:
            raise ValueError(
                f"no 2^k*{q}^s domain of size >= {size} in {params.name}")
        m, k, s = best
        self.params = params
        self.size = m
        self.factors = [2] * k + [q] * s   # decimation order
        self.gen = pow(params.generator, (p - 1) // m, p)
        self.gen_inv = pow(self.gen, -1, p) if m > 1 else 1
        self.size_inv = pow(m, -1, p)
        self.coset_shift = params.generator
        self.coset_shift_inv = pow(self.coset_shift, -1, p)
        self.z_coset = (pow(self.coset_shift, m, p) - 1) % p
        self.z_coset_inv = pow(self.z_coset, -1, p)
        self._tables: dict = {}

    def fft(self, coeffs):
        return _fft_mixed(self.params, coeffs,
                          self._powers(self.gen, self.size), self.factors)

    def ifft(self, evals):
        out = _fft_mixed(self.params, evals,
                         self._powers(self.gen_inv, self.size), self.factors)
        return fpmod.mont_mul(self.params, out, self._const(self.size_inv))

    # the tables, cosets, vanishing and Lagrange machinery is
    # radix-independent
    _powers = Domain._powers
    _const = Domain._const
    distribute_powers = Domain.distribute_powers
    coset_fft = Domain.coset_fft
    coset_ifft = Domain.coset_ifft
    divide_by_vanishing_poly_on_coset = \
        Domain.divide_by_vanishing_poly_on_coset
    mul_in_evaluation_domain = Domain.mul_in_evaluation_domain
    evaluate_vanishing_polynomial = Domain.evaluate_vanishing_polynomial
    evaluate_all_lagrange_coefficients = \
        Domain.evaluate_all_lagrange_coefficients


def best_domain(params: FpParams, size: int, device=None):
    """The radix-2 domain where the size fits the field's two-adicity, else
    the mixed-radix one."""
    lg = max(0, (size - 1).bit_length())
    if lg <= params.two_adicity:
        return Domain(params, size, device=device)
    return MixedRadixDomain(params, size, device=device)


def _fft_mixed(params: FpParams, x, powers, factors):
    """Mixed-radix DIT FFT.  x: [..., m, nd]; powers: [m, nd], gen^j;
    factors: the decimation radices (product m).  Decimation into
    parent-major groups, then one combine a factor in reverse order: a
    radix-2 butterfly, or for radix r X[t + h u] = sum_i w^(i t stride)
    w_r^(u i) sub_i[t] (one multiply by the twiddles, then an r-point DFT
    with r (r - 1) constant multiplies)."""
    m = x.shape[-2]
    if m == 1:
        return x
    batch = x.shape[:-2]
    nd = x.shape[-1]

    y = x.reshape(*batch, 1, m, nd)
    for r in factors:
        g, n = y.shape[-3], y.shape[-2]
        y = y.reshape(*batch, g, n // r, r, nd).movedim(-2, -3) \
            .reshape(*batch, g * r, n // r, nd)

    for r in reversed(factors):
        g, h = y.shape[-3], y.shape[-2]
        y = y.reshape(*batch, g // r, r, h, nd)
        n = r * h
        stride = m // n
        if r == 2:
            E = y[..., 0, :, :]
            O = y[..., 1, :, :]
            t = fpmod.mont_mul(params, O, powers[0:m // 2:stride])
            y = torch.cat([fpmod.add_mod(params, E, t),
                           fpmod.sub_mod(params, E, t)], dim=-2)
        else:
            it = (np.arange(r)[:, None] * np.arange(h)[None, :] * stride) % m
            tw = powers[torch.from_numpy(it).to(powers.device)]  # [r, h, nd]
            T = fpmod.mont_mul(params, y, tw)
            wr = [powers[(u * (m // r)) % m] for u in range(r)]
            outs = []
            for u in range(r):
                acc = T[..., 0, :, :]
                for i in range(1, r):
                    c = (u * i) % r
                    term = T[..., i, :, :] if c == 0 else \
                        fpmod.mont_mul(params, T[..., i, :, :], wr[c])
                    acc = fpmod.add_mod(params, acc, term)
                outs.append(acc)
            y = torch.cat(outs, dim=-2)
        y = y.reshape(*batch, g // r, n, nd)
    return y.reshape(*batch, m, nd)


def _fft_core(params: FpParams, x, twiddles):
    """Radix-2 DIT FFT.  x: [..., m, nd]; twiddles: [m/2, nd] powers of w."""
    m = x.shape[-2]
    if m == 1:
        return x
    lg = m.bit_length() - 1
    batch = x.shape[:-2]
    nd = x.shape[-1]

    # decimation: after d steps the shape is [..., 2^d, m/2^d, nd]; the group
    # axis indexes subsequences by the bit-reversed low bits of the index
    y = x.reshape(*batch, 1, m, nd)
    for _ in range(lg):
        g, h = y.shape[-3], y.shape[-2]
        # parent-major order [g0e, g0o, g1e, g1o, ...], so that the combine
        # stages pair adjacent groups
        y = torch.stack([y[..., 0::2, :], y[..., 1::2, :]], dim=-3) \
            .reshape(*batch, 2 * g, h // 2, nd)

    # combine: at half-length h the twiddle of position j is w^(j*m/(2h))
    for _ in range(lg):
        g, h = y.shape[-3], y.shape[-2]
        y = y.reshape(*batch, g // 2, 2, h, nd)
        E = y[..., 0, :, :]
        O = y[..., 1, :, :]
        w = twiddles[0:m // 2:m // (2 * h)]  # [h, nd]
        t = fpmod.mont_mul(params, O, w)
        y = torch.cat([fpmod.add_mod(params, E, t),
                       fpmod.sub_mod(params, E, t)], dim=-2)
    return y.reshape(*batch, m, nd)
