"""Port vs JAX package: the twisted-Edwards curves
(``gingerlib_tpu_torch/curves/twisted_edwards.py``; Jubjub, Edwards-BLS12,
Edwards-SW6) and the TE group gadget, on ``device="cpu"``.  Integer
arithmetic: tolerance 0, every digit must agree.

Fast tier: Jubjub's add, double, neg, eq, to_affine and on_curve on 4
seeded projective points against ONE JAX jit (``torch_jax_te.jax_te_ops``;
its compile is most of this file's time); the generator on the curve,
``mul_const`` with small k and ``points.mul_ints`` lanes on all three
curves
against the python-int oracle (the TE gadget's ``_host_add`` and
``_host_double``); the Montgomery parameters; the TE group gadget's
constraint system against the JAX gadget's, entry for entry.  ``slow``:
Edwards-BLS12 and Edwards-SW6 against the JAX package (a compile each), and
[r] G = 0 on the CPU (250-375 double-and-add steps).
"""

import numpy as np
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.gadgets.std import boolean as jbool
from gingerlib_tpu.gadgets.std import te_groups as jte
from gingerlib_tpu.relations import r1cs as jr1cs
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.curves import points
from gingerlib_tpu_torch.gadgets.std import boolean as tbool
from gingerlib_tpu_torch.gadgets.std import te_groups as tte
from gingerlib_tpu_torch.ops import limbs
from gingerlib_tpu_torch.relations import r1cs as tr1cs
from gingerlib_tpu_torch.utils import convert

from torch_jax_te import affine_of, host_mul, jax_points, jax_te_ops

CURVES = ["jubjub", "edwards_bls12", "edwards_sw6"]


def port(name):
    return getattr(TCI, name)("cpu")


def seeded_points(name, seed=5):
    """4 seeded points [k_i] G (the identity and G among them) in
    projective form with seeded Z, as JAX-layout numpy triples (P, Q)."""
    te = port(name)
    gg = tte.TEGroupGadget.for_curve(te)
    rng = np.random.default_rng(seed)
    r, p = te.scalar_field.modulus, te.fp.modulus
    ks = [0, 1] + [int.from_bytes(rng.bytes(40), "little") % r
                   for _ in range(6)]
    xys = [host_mul(gg, te.generator_host, k) for k in ks]
    zs = [int.from_bytes(rng.bytes(48), "little") % (p - 1) + 1
          for _ in ks]
    P = jax_points(te.fp, xys[:4], zs[:4])
    # Q: other points, and P's own second lane (a doubling through add)
    Q = jax_points(te.fp, [xys[4], xys[1], xys[6], xys[7]], zs[4:])
    return P, Q


def check_ops_against_jax(name):
    jte_, ops = jax_te_ops(name)
    te = port(name)
    P, Q = seeded_points(name)
    want = {k: np.asarray(v) for k, v in ops(P, Q).items()
            if not isinstance(v, tuple)}
    want.update({k: tuple(np.asarray(c) for c in v)
                 for k, v in ops(P, Q).items() if isinstance(v, tuple)})
    tP, tQ = convert.points_from_numpy(P, "cpu"), \
        convert.points_from_numpy(Q, "cpu")
    x, y = te.to_affine(tP)
    got = {"add": te.add(tP, tQ), "double": te.double(tP),
           "neg": te.neg(tP), "eq": te.eq(tP, tQ), "x": x, "y": y,
           "on_curve": te.on_curve(x, y)}
    for key, w in want.items():
        g = got[key]
        if isinstance(w, tuple):
            for gc, wc in zip(g, w):
                np.testing.assert_array_equal(gc.numpy(), wc.astype(np.int64))
        elif w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    assert want["on_curve"].all()
    # the second lanes of P and Q are one point: eq must say so
    assert list(want["eq"]) == [False, True, False, False]


def test_jubjub_ops_match_jax():
    check_ops_against_jax("jubjub")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["edwards_bls12", "edwards_sw6"])
def test_edwards_ops_match_jax(name):
    check_ops_against_jax(name)


@pytest.mark.parametrize("name", CURVES)
def test_generator_on_curve_and_montgomery_params(name):
    te = port(name)
    assert bool(te.on_curve(*te.generator_affine))
    p = te.fp.modulus
    inv_ad = pow((te.a_host - te.d_host) % p, -1, p)
    assert te.mont_a == 2 * (te.a_host + te.d_host) * inv_ad % p
    assert te.mont_b == 4 * inv_ad % p


@pytest.mark.parametrize("name", CURVES)
def test_small_multiples_match_host(name):
    """mul_const(G, k) for small k, and the same k's as lanes of one
    ``points.mul_ints`` loop and as the bits and digits of ``mul_bits`` and
    ``mul_scalar_digits``, against the python-int oracle; the identity
    laws on the results."""
    te = port(name)
    gg = tte.TEGroupGadget.for_curve(te)
    G = te.generator(())
    ks = [0, 1, 2, 7, 12]
    lanes = points.mul_ints(te, G, ks)
    want = [host_mul(gg, te.generator_host, k) for k in ks]
    assert affine_of(te.fp, lanes) == want
    bits = torch.from_numpy(np.stack([limbs.bits_msb_first(k, 4)
                                      for k in ks]))
    assert affine_of(te.fp, te.mul_bits(G, bits)) == want
    digits = torch.from_numpy(limbs.to_digits_batch(
        ks, te.scalar_field.n_digits))
    assert affine_of(te.fp, te.mul_scalar_digits(G, digits)) == want
    k7 = te.mul_const(G, 7)
    assert affine_of(te.fp, tuple(c[None] for c in k7)) == [want[3]]
    assert bool(te.is_zero(tuple(c[0] for c in lanes)))
    assert bool(te.eq(te.add(k7, te.zero(())), k7))
    assert bool(te.is_zero(te.add(k7, te.neg(k7))))
    assert bool(te.eq(te.double(k7), te.add(k7, k7)))


@pytest.mark.slow
@pytest.mark.parametrize("name", CURVES)
def test_subgroup_order(name):
    te = port(name)
    assert bool(te.is_zero(te.mul_const(te.generator(()),
                                        te.scalar_field.modulus)))


def test_te_group_gadget_matches_jax():
    """Allocation, the group law, identity and inverse, variable- and
    fixed-base multiplication: the same constraint system in both
    packages, satisfied, against the host multiple."""
    te = port("jubjub")
    k = 0b101101

    def build(B, gg, cs):
        gxy = te.generator_host
        inp = gg.alloc_input(cs, gxy, "Gin")
        P = gg.alloc_checked(cs, gxy, "G")
        P2 = gg.double(cs, P, "G2")
        gg.enforce_equal(cs, gg.add(cs, P2, P, "G3a"),
                         gg.add(cs, P, P2, "G3b"), "assoc")
        gg.enforce_equal(cs, gg.add(cs, P, gg.zero(cs), "Gid"), P, "id")
        gg.enforce_equal(cs, gg.add(cs, P, gg.neg(cs, P), "Ginv"),
                         gg.zero(cs), "inv")
        bits = [B.alloc(cs, bool((k >> i) & 1), f"k{i}") for i in range(6)]
        want = gg.constant(cs, R)
        gg.enforce_equal(cs, gg.mul_bits(cs, P, bits, "mul"), want, "eq")
        gg.enforce_equal(cs, gg.mul_bits_fixed_base(cs, gxy, bits, "fb"),
                         want, "eq2")
        gg.enforce_equal(cs, inp, P, "in")
        return cs

    R = host_mul(tte.TEGroupGadget.for_curve(te), te.generator_host, k)
    systems = []
    for pkg, B, R1, field in ((jte, jbool.Boolean, jr1cs, JP.JUBJUB_FQ),
                              (tte, tbool.Boolean, tr1cs, te.fp)):
        gg = pkg.TEGroupGadget(te.a_host, te.d_host, te.fp.modulus)
        systems.append(build(B, gg, R1.ConstraintSystem(field)))
    jcs, tcs = systems
    assert (tcs.num_constraints, tcs.num_inputs, tcs.num_aux) == \
        (jcs.num_constraints, jcs.num_inputs, jcs.num_aux)
    assert tcs.names == jcs.names
    assert (tcs.at, tcs.bt, tcs.ct) == (jcs.at, jcs.bt, jcs.ct)
    assert tcs.assignment() == jcs.assignment()
    assert tcs.which_is_unsatisfied() is None
    # a wrong multiple is refused
    gg = tte.TEGroupGadget.for_curve(te)
    cs = tr1cs.ConstraintSystem(te.fp)
    bits = [tbool.Boolean.alloc(cs, bool((k >> i) & 1), f"k{i}")
            for i in range(6)]
    gg.enforce_equal(cs, gg.mul_bits_fixed_base(cs, te.generator_host, bits),
                     gg.constant(cs, gg._host_double(R)), "eq")
    assert cs.which_is_unsatisfied() is not None
