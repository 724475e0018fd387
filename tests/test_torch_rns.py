"""Port vs JAX package: the RNS layer (gingerlib_tpu_torch.ops.rns) and the
RNS Montgomery multiply K7 (gingerlib_tpu_torch.ops.rns_kernels) on
``device="cpu"``, where the multiply runs its plain PyTorch version.

* the context (moduli, sigma factors, weights, extension matrices and the
  channelwise constants) equals the JAX package's;
* the python-int golden model equals the JAX golden model;
* the vectorized functions (``to_rns``, ``mont_mul_rns``, ``to_rns_digits``,
  ``from_rns_digits``) equal their JAX counterparts residue for residue and
  digit for digit;
* K7's plain version equals ``pallas_rns.mont_mul_rns_pallas`` in interpret
  mode on the same packed tiles (0, 1 and p - 1 among them), and six chained
  squarings equal python's ``pow``;

on MNT4-753 Fq (59 channels a base) and a 64-bit prime.  Inputs come from a
seeded numpy generator.  Integer arithmetic: tolerance 0.  The CUDA kernel
runs only on a GPU: chip_smoke.py and tests/test_torch_gpu_kernels.py hold
it against the plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gingerlib_tpu.ops import pallas_rns as jpr
from gingerlib_tpu.ops import rns as jrns
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops import limbs as tlimbs
from gingerlib_tpu_torch.ops import rns as trns
from gingerlib_tpu_torch.ops import rns_kernels as RK
from gingerlib_tpu_torch.utils.convert import rns_from_numpy, rns_to_numpy
from test_torch_cases import from_fragments

torch.set_num_threads(1)
PRIMES = {"p64": 0xFFFFFFFFFFFFFFC5, "mnt4_753": TP.MNT4753_FQ.modulus}


def values(p, n, seed):
    """n seeded values below p, then 0, 1 and p - 1."""
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(104), "little") % p
            for _ in range(n)] + [0, 1, p - 1]


@pytest.fixture(scope="module", params=sorted(PRIMES))
def field(request):
    p = PRIMES[request.param]
    return p, jrns.make_context(p), trns.make_context(p)


def test_context_equals_jax(field):
    _, jc, tc = field
    for name in ("p", "k", "mA", "mB", "MA", "MB", "sigA", "sigB", "wA", "wB",
                 "negpinv_A", "p_B", "MAinv_B", "r_mod_p"):
        assert getattr(tc, name) == getattr(jc, name), name
    for name in ("extAB", "extBA", "MA_modB", "MB_modA"):
        assert np.array_equal(getattr(tc, name), getattr(jc, name)), name
    assert tc.k <= trns.MAX_K and trns.W_BITS == jrns.W_BITS \
        and trns.ALPHA_OFF == jrns.ALPHA_OFF


def test_golden_model_equals_jax(field):
    p, jc, tc = field
    xs, ys = values(p, 4, 1), values(p, 4, 2)
    for x, y in zip(xs, ys):
        assert trns.to_rns_int(tc, x) == jrns.to_rns_int(jc, x)
        ra, rb = trns.to_rns_int(tc, x)
        assert trns.from_rns_int(tc, ra) == jrns.from_rns_int(jc, ra) == x
        for src, res in (("A", ra), ("B", rb)):
            for exact in (True, False):
                assert trns.base_extend_int(tc, res, src, exact) == \
                    jrns.base_extend_int(jc, res, src, exact)
        got = trns.mont_mul_rns_int(tc, trns.to_rns_int(tc, x),
                                    trns.to_rns_int(tc, y))
        assert got == jrns.mont_mul_rns_int(jc, jrns.to_rns_int(jc, x),
                                            jrns.to_rns_int(jc, y))
        value = trns.from_rns_int(tc, got[0])
        assert value < 3 * p and value % p == x * y * pow(tc.MA, -1, p) % p


def test_vectorized_functions_equal_jax(field):
    p, jc, tc = field
    xs, ys = values(p, 6, 3), values(p, 6, 4)
    tx, ty = trns.to_rns(tc, xs, "cpu"), trns.to_rns(tc, ys, "cpu")
    jx, jy = jrns.to_rns(jc, xs), jrns.to_rns(jc, ys)
    for got, want in zip(tx + ty, jx + jy):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    prod = trns.mont_mul_rns(tc, tx, ty)
    jprod = jrns.mont_mul_rns(jc, jx, jy)
    for got, want in zip(prod, jprod):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert trns.from_rns(tc, prod[0]) == jrns.from_rns(jc, jprod[0])
    nd = -(-p.bit_length() // 16)
    digits = tlimbs.to_digits_batch(xs, nd)
    for got, want in zip(trns.to_rns_digits(tc, torch.from_numpy(digits)),
                         jrns.to_rns_digits(jc, jnp.asarray(
                             digits.astype(np.uint32)))):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    pd = tlimbs.to_digits(p, nd)
    got = trns.from_rns_digits(tc, prod[0], pd, nd)
    want = jrns.from_rns_digits(jc, jprod[0], pd.astype(np.uint32), nd)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert tlimbs.from_digits_batch(got) == \
        [x * y * pow(tc.MA, -1, p) % p for x, y in zip(xs, ys)]


def test_k7_plain_equals_pallas_interpret(field):
    """The packed multiply residue for residue against the TPU kernel run
    in interpret mode; the JAX tile crosses by ``rns_from_numpy``."""
    p, jc, tc = field
    xs, ys = values(p, 5, 5), values(p, 5, 6)
    jx = jpr.pack_rns(jc, *jrns.to_rns(jc, xs))
    jy = jpr.pack_rns(jc, *jrns.to_rns(jc, ys))
    x, y = rns_from_numpy(jx, "cpu"), rns_from_numpy(jy, "cpu")
    assert torch.equal(x, RK.pack_rns(tc, *trns.to_rns(tc, xs, "cpu")))
    got = RK.mont_mul_rns(p, x, y)
    assert got.dtype == torch.int32 and got.shape == (len(xs), RK.LANES)
    want = jpr.mont_mul_rns_pallas(p, jx, jy, interpret=True)
    assert np.array_equal(rns_to_numpy(got), np.asarray(want))
    # one row against all rows, as the tree and the scale constants use it
    assert torch.equal(RK.mont_mul_rns(p, x, y[3:4]),
                       RK.mont_mul_rns_plain(p, x, y[3:4].expand_as(y)))


def test_k7_chained_squarings_equal_pow(field):
    """Six squarings through the packed multiply, from x M_A (one multiply
    by M_A^2): every value stays below 3p and equals x^(2^i) M_A mod p."""
    p, _, tc = field
    xs = values(p, 3, 7)
    x = RK.pack_rns(tc, *trns.to_rns(tc, xs, "cpu"))
    r2 = RK.pack_rns(tc, *trns.to_rns(tc, [tc.MA * tc.MA % p], "cpu"))
    cur = RK.mont_mul_rns(p, x, r2)
    want = list(xs)
    for _ in range(6):
        cur = RK.mont_mul_rns(p, cur, cur)
        want = [w * w % p for w in want]
        got = trns.from_rns(tc, RK.unpack_rns(tc, cur)[0])
        assert all(g < 3 * p for g in got)
        assert [g % p for g in got] == [w * tc.MA % p for w in want]


def test_kernel_consts_hold_the_context():
    """The constant block of csrc/rns_core.cuh: rows (m = 1 outside the
    channels), the folded products and negated corrections, and the two
    extension matrices, exact integers, read back out of the tensor cores'
    fragment order."""
    p = TP.MNT4753_FQ.modulus
    ctx = trns.make_context(p)
    k, B = ctx.k, RK.B_ROW
    block = RK.kernel_consts(p)
    assert RK.N_ROWS == 11
    rows = block[:RK.N_ROWS * RK.LANES].reshape(RK.N_ROWS, RK.LANES).astype(
        np.int64)
    m = rows[0]
    assert list(m[:k]) == list(ctx.mA) and list(m[B:B + k]) == list(ctx.mB)
    assert (m[k:B] == 1).all() and (m[B + k:] == 1).all()
    assert all(int(mu) == (1 << 32) // int(v) for mu, v in
               zip(rows[1, :k], m[:k]))
    mA, mB = np.asarray(ctx.mA), np.asarray(ctx.mB)
    named = dict(zip(("sig", "w", "qsig", "pB", "mainv", "tsig", "ncorrAB",
                      "ncorrBA"), rows[2:10]))
    want = {
        "qsig": (np.asarray(ctx.negpinv_A) * np.asarray(ctx.sigA) % mA,
                 None),
        "pB": (None, np.asarray(ctx.p_B)),
        "mainv": (None, np.asarray(ctx.MAinv_B)),
        "tsig": (None, np.asarray(ctx.MAinv_B) * np.asarray(ctx.sigB) % mB),
        "ncorrAB": (None, (mB - ctx.MA_modB.astype(np.int64)) % mB),
        "ncorrBA": ((mA - ctx.MB_modA.astype(np.int64)) % mA, None),
        "sig": (np.asarray(ctx.sigA), np.asarray(ctx.sigB)),
        "w": (np.asarray(ctx.wA), np.asarray(ctx.wB)),
    }
    for name, (wa, wb) in want.items():
        row = named[name]
        assert np.array_equal(row[:k], wa if wa is not None else 0 * mA), name
        assert np.array_equal(row[B:B + k], wb if wb is not None else 0 * mB)
        assert not row[k:B].any() and not row[B + k:].any(), name
    assert list(rows[10, :k]) == [(1 << 32) % v for v in ctx.mA]
    ext = block[RK.N_ROWS * RK.LANES:].reshape(2, -1)
    assert ext.shape[1] == RK.KMAX * RK.B_ROW // 2
    for frag, want_mat in zip(ext, (ctx.extAB, ctx.extBA)):
        mat = from_fragments(frag, RK.KMAX, RK.B_ROW)
        assert np.array_equal(mat[:k, :k], want_mat)
        assert not mat[k:].any() and not mat[:, k:].any()


def test_k7_wrapper_refuses_cpu_tensors():
    """No fallback: the launching half raises on residues that are not on
    a GPU instead of taking the plain version."""
    p = TP.BLS12_377_FQ.modulus
    x = torch.zeros((4, RK.LANES), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        RK.mont_mul_rns_cuda(p, x, x)
    with pytest.raises(ValueError, match="int32"):
        RK.mont_mul_rns_cuda(p, x.to(torch.int64), x)
    before = dict(tfp.launch_counts)
    RK.mont_mul_rns(p, x, x)
    assert tfp.launch_counts == before
