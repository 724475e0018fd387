"""Port vs JAX package: prime-field layer (gingerlib_tpu_torch.fields.fp).

The same inputs, made with numpy from a seed, go through the JAX function
(plain XLA path on the CPU) and through the port on ``device="cpu"`` (the
plain PyTorch versions of the kernels).  Integer arithmetic: tolerance 0,
every digit must agree.
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
from gingerlib_tpu_torch.ops import limbs as tlimbs

torch.set_num_threads(1)

FIELDS = ["MNT4753_FQ", "MNT4753_FR", "MNT6298_FQ"]   # 48, 48 and 19 digits
N = 19          # batch, as in tests/test_fp.py (16 random + 3 edge values)


def fields(name):
    return getattr(JP, name), getattr(TP, name)


def rand_below(bound: int, n: int, seed: int) -> list:
    """n integers below ``bound`` from numpy's generator."""
    rng = np.random.default_rng(seed)
    nbytes = (bound.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "little") % bound
            for _ in range(n)]


def canonical(P, seed):
    q = P.modulus
    return rand_below(q, N - 3, seed) + [0, 1, q - 1]


def both(P, vals):
    """Plain digit arrays of ``vals`` for JAX (uint32) and the port."""
    d = tlimbs.to_digits_batch(vals, P.n_digits)
    return jnp.asarray(d.astype(np.uint32)), torch.from_numpy(d)


def jitted(fn, *args):
    """The JAX side runs jitted: one compile per graph instead of one per
    primitive, and the persistent cache of tests/conftest.py keeps it."""
    return jax.jit(fn)(*args)


def same(jax_out, torch_out):
    got = torch_out.numpy()
    want = np.asarray(jax_out).astype(np.int64)
    return got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
@pytest.mark.parametrize("name", FIELDS)
def test_binary_op_matches_jax(name, op):
    JF, TF = fields(name)
    ja, ta = both(TF, canonical(TF, 1))
    jb, tb = both(TF, list(reversed(canonical(TF, 2))))
    assert same(jitted(lambda a, b: getattr(jfp, op)(JF, a, b), ja, jb),
                getattr(tfp, op)(TF, ta, tb))


@pytest.mark.parametrize("op", ["neg_mod", "double_mod", "to_mont",
                                "from_mont"])
@pytest.mark.parametrize("name", FIELDS)
def test_unary_op_matches_jax(name, op):
    JF, TF = fields(name)
    ja, ta = both(TF, canonical(TF, 3))
    assert same(jitted(lambda a: getattr(jfp, op)(JF, a), ja),
                getattr(tfp, op)(TF, ta))


@pytest.mark.parametrize("name", FIELDS)
def test_wide_operand_matches_jax(name):
    """One operand anywhere below R (not below p): REDC must still land on
    the canonical residue, in mont_mul and in from_mont."""
    JF, TF = fields(name)
    R = 1 << (16 * TF.n_digits)
    ja, ta = both(TF, rand_below(R, N - 2, 4) + [R - 1, TF.modulus])
    jb, tb = both(TF, canonical(TF, 5))
    assert same(jitted(lambda a, b: jfp.mont_mul(JF, a, b), ja, jb),
                tfp.mont_mul(TF, ta, tb))
    assert same(jitted(lambda a: jfp.from_mont(JF, a), ja),
                tfp.from_mont(TF, ta))


@pytest.mark.parametrize("name", FIELDS)
def test_lazy_reduce_matches_jax(name):
    JF, TF = fields(name)
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 1 << 31, size=(N, TF.n_digits), dtype=np.int64)
    raw[:, -1] = 0            # keeps the integer value below R
    assert same(jitted(lambda x: jfp.lazy_reduce(JF, x),
                       jnp.asarray(raw.astype(np.uint32))),
                tfp.lazy_reduce(TF, torch.from_numpy(raw)))


@pytest.mark.parametrize("name", FIELDS)
def test_broadcast_constant_operand(name):
    """A single row against a batch, as to_mont and the FFT scale use it."""
    JF, TF = fields(name)
    ja, ta = both(TF, canonical(TF, 7))
    assert same(jitted(lambda a: jfp.mont_mul(
        JF, a, jnp.broadcast_to(a[4], a.shape)), ja),
        tfp.mont_mul(TF, ta, ta[4]))


def test_inv_mod_matches_jax():
    """Shape and field of tests/test_fp.py::test_inverse_zero_maps_to_zero,
    whose XLA while-loop the fast tier already compiles."""
    JF, TF = JP.BLS12_377_FR, TP.BLS12_377_FR
    for v in (0, 5):
        ja, ta = both(TF, [v * TF.r % TF.modulus])
        assert same(jitted(lambda a: jfp.inv_mod(JF, a), ja),
                    tfp.inv_mod(TF, ta))


@pytest.mark.parametrize("name", FIELDS)
def test_inv_mod_and_tree_against_python(name):
    _, TF = fields(name)
    q = TF.modulus
    xs = rand_below(q, 4, 8) + [0, 1, q - 1]
    want = [pow(x, -1, q) if x else 0 for x in xs]
    a = torch.from_numpy(tfp.fp_from_ints(TF, xs))
    assert tfp.fp_to_ints(TF, tfp.inv_mod(TF, a)) == want
    assert tfp.fp_to_ints(TF, tfp.batch_inverse_tree(TF, a)) == want


def test_batch_inverse_tree_matches_jax():
    JF, TF = JP.BLS12_377_FR, TP.BLS12_377_FR
    xs = rand_below(TF.modulus, 5, 9)       # 5: padded to 8 inside
    xs[2] = 0
    d = tfp.fp_from_ints(TF, xs)
    want = jitted(lambda a: jfp.batch_inverse_tree(JF, a),
                  jnp.asarray(d.astype(np.uint32)))
    assert same(want, tfp.batch_inverse_tree(TF, torch.from_numpy(d)))


@pytest.mark.parametrize("name", FIELDS + ["BLS12_377_FQ", "SW6_FQ"])
def test_mont_mul_plain_against_python(name):
    TF = getattr(TP, name)
    q, R = TF.modulus, 1 << (16 * TF.n_digits)
    xs = rand_below(R, N - 3, 10) + [0, R - 1, q]
    ys = canonical(TF, 11)
    r_inv = pow(R, -1, q)
    got = tfp.mont_mul_plain(TF, *(torch.from_numpy(
        tlimbs.to_digits_batch(v, TF.n_digits)) for v in (xs, ys)))
    assert tlimbs.from_digits_batch(got) == [
        x * y * r_inv % q for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", FIELDS + ["BLS12_377_FQ"])
def test_inv_bea_plain_against_python(name):
    TF = getattr(TP, name)
    q = TF.modulus
    xs = rand_below(q, 3, 12) + [0, 1, 2, q - 1]
    got = tfp.inv_bea_plain(TF, torch.from_numpy(
        tlimbs.to_digits_batch(xs, TF.n_digits)))
    assert tlimbs.from_digits_batch(got) == [
        pow(x, -1, q) if x else 0 for x in xs]


@pytest.mark.parametrize("name", FIELDS + ["BLS12_377_FQ"])
@pytest.mark.parametrize("x", ["zero", "one", "two", "p-1", "seeded"])
def test_inv_bea_plain_of_one_element_against_python(name, x):
    """One element (the root of every shared inversion) takes the one-lane
    form, which computes only the case its lane takes a step."""
    TF = getattr(TP, name)
    q = TF.modulus
    v = {"zero": 0, "one": 1, "two": 2, "p-1": q - 1,
         "seeded": rand_below(q, 1, 13)[0]}[x]
    got = tfp.inv_bea_plain(TF, torch.from_numpy(
        tlimbs.to_digits_batch([v], TF.n_digits)).reshape(1, 1, -1))
    assert got.shape == (1, 1, TF.n_digits)
    assert tlimbs.from_digits_batch(got) == [pow(v, -1, q) if v else 0]


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("x", ["p", "2p", "all-ones"])
def test_inv_bea_plain_ends_alike_off_its_contract(name, x):
    """An input at or above p breaks the inverse's contract; the one-lane
    form still ends, within the same bound and at the same exit as the
    batched form, with the same digits."""
    TF = getattr(TP, name)
    q = TF.modulus
    v = {"p": q, "2p": 2 * q,
         "all-ones": (1 << (tlimbs.DIGIT_BITS * TF.n_digits)) - 1}[x]
    a = torch.from_numpy(tlimbs.to_digits_batch([v, v], TF.n_digits))
    one = tfp.inv_bea_plain(TF, a[:1])
    assert torch.equal(one, tfp.inv_bea_plain(TF, a)[:1])


@pytest.mark.parametrize("name", FIELDS + ["SW6_FQ"])
def test_add_sub_neg_plain_against_python(name):
    TF = getattr(TP, name)
    q = TF.modulus
    xs, ys = canonical(TF, 13), list(reversed(canonical(TF, 14)))
    a, b = (torch.from_numpy(tlimbs.to_digits_batch(v, TF.n_digits))
            for v in (xs, ys))
    assert tlimbs.from_digits_batch(tfp.add_mod_plain(TF, a, b)) == [
        (x + y) % q for x, y in zip(xs, ys)]
    assert tlimbs.from_digits_batch(tfp.sub_mod_plain(TF, a, b)) == [
        (x - y) % q for x, y in zip(xs, ys)]
    assert tlimbs.from_digits_batch(tfp.neg_mod_plain(TF, a)) == [
        -x % q for x in xs]


def test_field_constants_match_jax():
    for name in FIELDS + ["BLS12_377_FQ", "BLS12_377_FR"]:
        JF, TF = fields(name)
        for attr in ("modulus", "n_digits", "r", "r2", "r_inv", "nprime",
                     "two_adicity", "root_of_unity", "generator"):
            assert getattr(JF, attr) == getattr(TF, attr), (name, attr)
        for attr in ("modulus_digits", "nprime_digits", "one_mont",
                     "r2_digits", "r3_digits"):
            assert np.array_equal(np.asarray(getattr(JF, attr), np.int64),
                                  getattr(TF, attr)), (name, attr)


UNBUILT_FQ = tfp.FpParams("mersenne_127", (1 << 127) - 1, generator=3)
assert UNBUILT_FQ.n_digits not in tfp.KERNEL_DIGITS


@pytest.mark.parametrize("wrapper", ["mont_mul_cuda", "inv_bea_cuda"])
@pytest.mark.parametrize("fault,error", [
    ("cpu_tensor", ValueError), ("int32_digits", TypeError),
    ("wrong_width", ValueError), ("unbuilt_digit_count", NotImplementedError)])
def test_kernel_wrappers_refuse(wrapper, fault, error):
    """The CUDA wrappers never compute on the CPU and take only the layout
    the kernels were built for; everything else raises (an 8-digit field,
    2^127 - 1, is built at no width)."""
    TF = UNBUILT_FQ if fault == "unbuilt_digit_count" else TP.MNT4753_FQ
    a = torch.from_numpy(tfp.fp_from_ints(TF, [3, 4]))
    if fault == "int32_digits":
        a = a.to(torch.int32)
    if fault == "wrong_width":
        a = a[:, :24]
    args = (TF, a, a) if wrapper == "mont_mul_cuda" else (TF, a)
    with pytest.raises(error):
        getattr(tfp, wrapper)(*args)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["BLS12_377_FR", "MNT4753_FQ"])
def test_mont_mul_plain_matches_pallas_interpret(name):
    """The TPU kernel the CUDA kernel replaces, run in interpret mode."""
    from gingerlib_tpu.ops import pallas_mont
    JF, TF = fields(name)
    ja, ta = both(TF, canonical(TF, 41))
    jb, tb = both(TF, list(reversed(canonical(TF, 42))))
    assert same(pallas_mont.mont_mul_pallas_t(JF, ja, jb, interpret=True),
                tfp.mont_mul_plain(TF, ta, tb))


@pytest.mark.slow
def test_inv_bea_plain_matches_pallas_interpret():
    from gingerlib_tpu.ops import pallas_mont
    JF, TF = JP.BLS12_377_FR, TP.BLS12_377_FR
    ja, ta = both(TF, rand_below(TF.modulus, 4, 31) + [0, 1, TF.modulus - 1,
                                                        2])
    assert same(pallas_mont.inv_bea_pallas(JF, ja, interpret=True),
                tfp.inv_bea_plain(TF, ta))


def _gather_rows(x, out_shape):
    """What the kernels read: row ``i % rows`` at ``stride`` digits from the
    start of the tensor that ``_rows`` hands them, for every flat row i."""
    t, rows, stride = tfp._rows(x, out_shape)
    nd = out_shape[-1]
    n = int(np.prod(out_shape[:-1]))
    flat = t.as_strided((t.untyped_storage().size() // 8,), (1,), 0)
    base = t.storage_offset()
    idx = (torch.arange(n) % rows) * stride + base
    return flat[idx[:, None] + torch.arange(nd)].reshape(out_shape), t


@pytest.mark.parametrize("case", [
    "full", "one_row", "trailing_table", "component", "last_component",
    "every_other_row", "inner_broadcast", "expanded", "even_rows_of_pairs"])
def test_kernel_row_addressing(case):
    """The wrapper's description of an operand (rows, stride) addresses
    exactly the broadcast operand, and copies only where it must."""
    nd = 48
    base = torch.arange(6 * 4 * 3 * nd, dtype=torch.int64).reshape(
        6, 4, 3, nd)
    x, out_shape, copies = {
        "full": (base, base.shape, False),
        "one_row": (base[2, 1, 0], base.shape, False),
        "trailing_table": (base[0], base.shape, False),
        "component": (base[..., 0:1, :], (6, 4, 1, nd), False),
        "last_component": (base[..., 2:3, :], (6, 4, 1, nd), False),
        "every_other_row": (base[0, 0::2, 0], (2, nd), False),
        "inner_broadcast": (base[:, :, 0:1], base.shape, True),
        "expanded": (base[0, 0, 0].expand(4, 3, nd), base.shape, True),
        "even_rows_of_pairs": (base[0::2, :, 0:2], (3, 4, 2, nd), True),
    }[case]
    got, handed = _gather_rows(x, tuple(out_shape))
    assert torch.equal(got, x.expand(out_shape))
    assert (handed.data_ptr() != x.data_ptr()) == copies
