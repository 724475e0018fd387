"""Port: exponentiation, Legendre symbol, square root and batch inversion
of the prime-field layer (gingerlib_tpu_torch.fields.fp) on
``device="cpu"``, where ``pow_const`` runs its kernel's plain version.

``pow_const`` is held against python's ``pow`` and, with a short exponent,
against the JAX package's ``fp.pow_const``; ``pow_dyn``, ``legendre``,
``sqrt_mod`` (root and mask, squares, non-squares and zero) and
``batch_inverse`` against python ints, at batches of at most 8.  The kernel
wrapper's refusals close the file: it takes CUDA tensors only, and a failed
build raises instead of computing anything.  Integer arithmetic: tolerance
0.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.fields import fp as jfp
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops import cuda_lib, limbs as tlimbs
from test_torch_cases import rand_below

torch.set_num_threads(1)
SHORT = 0xC0FFEE11          # a 32-bit exponent
FIELDS = ["MNT4753_FQ", "MNT4753_FR", "BLS12_377_FR"]


def inputs(TF, seed):
    """Eight Montgomery-form inputs: five random, 0, 1, p - 1 (python ints
    in standard form and their digit tensor)."""
    vals = rand_below(TF.modulus, 5, seed) + [0, 1, TF.modulus - 1]
    return vals, torch.from_numpy(tfp.fp_from_ints(TF, vals))


def squares_and_not(TF, seed):
    """Four squares, three non-squares (by Euler's criterion) and zero."""
    p = TF.modulus
    sq = [x * x % p for x in rand_below(p, 4, seed)]
    non = [v for v in rand_below(p, 40, seed + 1)
           if pow(v, (p - 1) // 2, p) == p - 1][:3]
    vals = sq + non + [0]
    return vals, torch.from_numpy(tfp.fp_from_ints(TF, vals))


@pytest.mark.parametrize("name", ["MNT4753_FR", "BLS12_377_FR"])
def test_pow_const_short_exponent_matches_jax_and_python(name):
    JF, TF = getattr(JP, name), getattr(TP, name)
    vals, x = inputs(TF, 1)
    bits = tlimbs.bits_msb_first(SHORT, 32)
    got = tfp.pow_const(TF, x, bits)
    assert tfp.fp_to_ints(TF, got) == [pow(v, SHORT, TF.modulus)
                                       for v in vals]
    want = jax.jit(lambda a: jfp.pow_const(JF, a, bits.astype(np.uint32)))(
        jnp.asarray(x.numpy().astype(np.uint32)))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


@pytest.mark.parametrize("exponent", ["inv", "legendre", "sqrt"])
def test_pow_const_field_exponents_match_python(exponent):
    """The exponent tables of FpParams: p - 2, (p - 1) / 2, (t - 1) / 2."""
    TF = TP.MNT4753_FQ
    p = TF.modulus
    e = {"inv": p - 2, "legendre": (p - 1) // 2,
         "sqrt": (TF.t - 1) // 2}[exponent]
    bits = getattr(TF, f"{exponent}_exp_bits")
    assert int("".join(str(int(b)) for b in bits), 2) == e
    vals, x = inputs(TF, 2)
    assert tfp.fp_to_ints(TF, tfp.pow_const(TF, x[:3], bits)) == \
        [pow(v, e, p) for v in vals[:3]]


def test_pow_dyn_matches_python():
    TF = TP.MNT4753_FQ
    vals, x = inputs(TF, 3)
    exps = rand_below(1 << 32, len(vals), 4)
    ed = torch.from_numpy(tlimbs.to_digits_batch(exps, 2))
    assert tfp.fp_to_ints(TF, tfp.pow_dyn(TF, x, ed)) == \
        [pow(v, e, TF.modulus) for v, e in zip(vals, exps)]


@pytest.mark.parametrize("name", FIELDS)
def test_legendre_matches_euler(name):
    TF = getattr(TP, name)
    vals, x = squares_and_not(TF, 5)
    want = [1] * 4 + [-1] * 3 + [0]
    assert tfp.legendre(TF, x).tolist() == want
    assert tfp.legendre(TF, x).dtype == torch.int32


@pytest.mark.parametrize("name", FIELDS)
def test_sqrt_mod_root_and_mask(name):
    """Squares get a root with x^2 = a and the mask set, zero gets zero,
    non-squares get the mask cleared."""
    TF = getattr(TP, name)
    p = TF.modulus
    vals, x = squares_and_not(TF, 7)
    root, ok = tfp.sqrt_mod(TF, x)
    assert ok.tolist() == [True] * 4 + [False] * 3 + [True]
    assert ok.tolist() == (tfp.legendre(TF, x) >= 0).tolist()
    roots = tfp.fp_to_ints(TF, root)
    for v, r, has in zip(vals, roots, ok.tolist()):
        if has:
            assert r * r % p == v
    assert roots[-1] == 0


@pytest.mark.parametrize("axis", [0, 1])
def test_batch_inverse_matches_python(axis):
    TF = TP.MNT4753_FQ
    p = TF.modulus
    vals, x = inputs(TF, 9)
    got = tfp.batch_inverse(TF, x.reshape(2, 4, -1), axis=axis)
    assert got.shape == (2, 4, TF.n_digits)
    assert tfp.fp_to_ints(TF, got.reshape(-1, TF.n_digits)) == \
        [pow(v, -1, p) if v else 0 for v in vals]


def test_pow_const_cuda_refuses_cpu_tensors():
    TF = TP.MNT4753_FQ
    _, x = inputs(TF, 11)
    with pytest.raises(ValueError, match="CUDA"):
        tfp.pow_const_cuda(TF, x, TF.legendre_exp_bits)


@pytest.mark.parametrize("wrapper", ["pow_const", "poseidon_permute"])
def test_failed_build_raises(monkeypatch, tmp_path, wrapper):
    """With no compiler the wrappers raise where they would launch: nothing
    is computed by the plain version instead."""
    from gingerlib_tpu_torch.ops import poseidon_kernels as PK
    from gingerlib_tpu_torch.primitives.poseidon import PoseidonParams

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    # let a CPU tensor past the device check, so that the wrapper reaches
    # the build; the build directory is a scratch one
    monkeypatch.setattr(tfp, "_check_operand", lambda *a: None)
    monkeypatch.setattr(tfp, "_kernel_fns", {})
    monkeypatch.setattr(tfp, "_raw_stream", lambda x: 0)
    monkeypatch.setattr(cuda_lib, "_functions", {})
    monkeypatch.setattr(cuda_lib, "BUILD", str(tmp_path))
    monkeypatch.setattr(cuda_lib, "_nvcc", no_nvcc)
    TF = TP.MNT4753_FR
    with pytest.raises(RuntimeError, match="nvcc"):
        if wrapper == "pow_const":
            tfp.pow_const_cuda(TF, torch.zeros((2, 48), dtype=torch.int64),
                               TF.legendre_exp_bits)
        else:
            P = PoseidonParams.mnt4753("cpu")
            PK.permute_cuda(P, torch.zeros((2, 3, 48), dtype=torch.int64))
