"""Radix-2 evaluation domains over prime scalar fields.

Counterpart of ``gingerlib_tpu/ops/fft.py``: a reshape-based radix-2 FFT with
``log2(m)`` decimation steps (strided slicing, no bit-reversal scatter)
followed by ``log2(m)`` combine stages, each ONE batched Montgomery multiply
of m/2 elements plus one add and one subtract.  Twiddle tables are built on
the host (python ints) once per domain and kept on the device.  Coset
transforms go through ``distribute_powers``; division by the vanishing
polynomial on a coset is one constant multiply, since Z(g*w^j) = g^m - 1.

Elements: Montgomery digit tensors [..., m, n_digits]; the element axis is
axis -2.  The scan and four-step cores of the JAX package answer to its
compiler and are not ported; nor is the mixed-radix domain yet.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..fields import fp as fpmod
from ..fields.fp import FpParams


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
    # tables (host-built, cached on the device)
    # ------------------------------------------------------------------

    def _powers(self, base: int, n: int):
        hit = self._tables.get((base, n))
        if hit is None:
            hit = torch.from_numpy(
                _build_powers(self.params, base, n)).to(self.device)
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


def _build_powers(params: FpParams, base: int, n: int):
    """[1, base, ..., base^(n-1)] as Montgomery digits [n, nd] (host python
    ints; set-up cost of a domain, off the hot path)."""
    p = params.modulus
    out = []
    w = 1
    for _ in range(n):
        out.append(w)
        w = w * base % p
    return fpmod.fp_from_ints(params, out).reshape(n, params.n_digits)


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
