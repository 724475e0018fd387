"""Port vs JAX package: the mixed-radix domain (``MixedRadixDomain``,
``_fft_mixed``, ``best_domain`` of gingerlib_tpu_torch.ops.fft) on
``device="cpu"``, over MNT6-753's Fr (two-adicity 15, 5^2 | p - 1; the
port's MNT4-753 Fq), at the sizes of the JAX package's own tests, against
the JAX domain and a naive DFT in python ints.  Tolerance 0.
"""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.ops.fft import MixedRadixDomain as JMixed
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops import fft as tfft

torch.set_num_threads(1)
JF, TF = JP.MNT6753_FR, TP.MNT6753_FR
SIZES = [5, 10, 20, 40]


def rand_ints(m, seed):
    rng = random.Random(seed)
    return [rng.randrange(TF.modulus) for _ in range(m)]


def naive_dft(xs, w):
    p, m = TF.modulus, len(xs)
    return [sum(x * pow(w, i * j, p) for j, x in enumerate(xs)) % p
            for i in range(m)]


@pytest.mark.parametrize("size", SIZES)
def test_domain_matches_jax(size):
    """The same size, factors and generator as the JAX domain."""
    j, t = JMixed(JF, size), tfft.MixedRadixDomain(TF, size, device="cpu")
    assert (t.size, t.factors, t.gen, t.gen_inv, t.z_coset) \
        == (j.size, j.factors, j.gen, j.gen_inv, j.z_coset)


@pytest.mark.parametrize("size", SIZES)
def test_fft_matches_naive_dft(size):
    dom = tfft.MixedRadixDomain(TF, size, device="cpu")
    xs = rand_ints(dom.size, size)
    got = dom.fft(torch.from_numpy(tfp.fp_from_ints(TF, xs)))
    assert tfp.fp_to_ints(TF, got) == naive_dft(xs, dom.gen)


def test_fft_matches_jax():
    """Size 10 (factors 2, 5: one combine of each radix): fft equals the
    JAX package's digit for digit (one compiled graph; the other sizes, and
    ifft through the round trips, hold to python ints)."""
    jdom = JMixed(JF, 10)
    tdom = tfft.MixedRadixDomain(TF, 10, device="cpu")
    x = tfp.fp_from_ints(TF, rand_ints(10, 99))
    want = jax.jit(jdom.fft)(jnp.asarray(x.astype(np.uint32)))
    assert np.array_equal(np.asarray(want).astype(np.int64),
                          tdom.fft(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("kind", ["fft", "coset_fft"])
def test_roundtrips(kind):
    dom = tfft.MixedRadixDomain(TF, 20, device="cpu")
    xs = rand_ints(dom.size, 98)
    x = torch.from_numpy(tfp.fp_from_ints(TF, xs))
    inverse = {"fft": dom.ifft, "coset_fft": dom.coset_ifft}[kind]
    assert tfp.fp_to_ints(TF, inverse(getattr(dom, kind)(x))) == xs


def test_power_of_two_size_matches_radix2():
    """On a power-of-two size with the radix-2 domain's generator pinned,
    the two cores agree."""
    fr = TP.BLS12_377_FR
    d2 = tfft.Domain(fr, 16, device="cpu")
    dm = tfft.MixedRadixDomain(fr, 16, device="cpu")
    dm.gen = d2.gen
    x = torch.from_numpy(tfp.fp_from_ints(
        fr, [random.Random(5).randrange(fr.modulus) for _ in range(16)]))
    assert torch.equal(d2.fft(x), dm.fft(x))


def test_lagrange_coefficients_are_radix_independent():
    """sum_i l_i(tau) f(w^i) = f(tau) on the mixed domain."""
    dom = tfft.MixedRadixDomain(TF, 10, device="cpu")
    p, m = TF.modulus, dom.size
    xs = rand_ints(m, 13)
    tau = random.Random(17).randrange(p)
    evals = tfp.fp_to_ints(TF, dom.fft(torch.from_numpy(
        tfp.fp_from_ints(TF, xs))))
    lag = tfp.fp_to_ints(TF, dom.evaluate_all_lagrange_coefficients(tau))
    assert sum(l * e for l, e in zip(lag, evals)) % p \
        == sum(x * pow(tau, j, p) for j, x in enumerate(xs)) % p


def test_best_domain_selection():
    d = tfft.best_domain(TF, 1 << 10, device="cpu")
    assert isinstance(d, tfft.Domain) and d.size == 1 << 10
    d = tfft.best_domain(TF, (1 << 15) + 1, device="cpu")
    assert isinstance(d, tfft.MixedRadixDomain)
    assert d.size == (1 << 13) * 5          # 40,960: the smallest 2^k 5^s
    d = tfft.best_domain(TF, 1 << 17, device="cpu")
    assert (d.size, d.factors) == (163840, [2] * 15 + [5])


@pytest.mark.parametrize("size", [20, 40, 80])
def test_coset_functions_match_jax(size):
    """What GM17's witness map runs on the mixed domain -- ifft,
    coset_fft, the division by the vanishing polynomial on the coset and
    coset_ifft -- equal the JAX class's digit for digit (one compiled graph
    a size), and coset_ifft(coset_fft(x)) == x."""
    jdom = JMixed(JF, size)
    tdom = tfft.MixedRadixDomain(TF, size, device="cpu")
    x = tfp.fp_from_ints(TF, rand_ints(tdom.size, size + 7))
    want = jax.jit(lambda v: (
        jdom.ifft(v), jdom.coset_fft(v),
        jdom.divide_by_vanishing_poly_on_coset(v), jdom.coset_ifft(v)))(
            jnp.asarray(x.astype(np.uint32)))
    t = torch.from_numpy(x)
    got = (tdom.ifft(t), tdom.coset_fft(t),
           tdom.divide_by_vanishing_poly_on_coset(t), tdom.coset_ifft(t))
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(w).astype(np.int64), g.numpy())
    assert torch.equal(tdom.coset_ifft(got[1]), t)
