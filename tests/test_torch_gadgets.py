"""Port vs JAX package: the gadgets (``gingerlib_tpu_torch/gadgets``) against
``gingerlib_tpu/gadgets`` on the same inputs, over MNT4-753 Fq and MNT6-753
Fq.  Host code in python ints: every case builds one circuit through both
packages and holds them equal entry for entry -- the constraint count, the
names, the three matrices and the whole ``assignment()`` -- then checks
that the port's system is satisfied and that a lie is refused.  Tolerance
0.

Mirrors ``tests/test_gadgets.py`` (booleans, Fp wires, lookups, the tower
gadgets, short-Weierstrass add / double / mul_bits) and
``tests/test_pairing_gadget.py`` (one bilinearity case, MNT4-753).  About
40 s in one process, most of it the pairing case.
"""

import random
from types import SimpleNamespace as NS

import pytest

from gingerlib_tpu import params as JP
from gingerlib_tpu.gadgets.std import boolean as jbool, ext_fields as jef
from gingerlib_tpu.gadgets.std import fp as jfp, groups as jgroups
from gingerlib_tpu.gadgets.std import pairing as jpairing
from gingerlib_tpu.relations import r1cs as jr1cs
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.fields import host_ext as HE
from gingerlib_tpu_torch.gadgets.std import boolean as tbool, \
    ext_fields as tef
from gingerlib_tpu_torch.gadgets.std import fp as tfp, groups as tgroups
from gingerlib_tpu_torch.gadgets.std import pairing as tpairing
from gingerlib_tpu_torch.params._gen import curves_gen as CG, \
    towers_gen as TG
from gingerlib_tpu_torch.curves.pairing_host import host_mnt4753_pairing
from gingerlib_tpu_torch.proofs.groth16_host import host_curves
from gingerlib_tpu_torch.relations import r1cs as tr1cs

JAX = NS(R=jr1cs, Boolean=jbool.Boolean, FpG=jfp.FpG, EF=jef, G=jgroups,
         P=jpairing, PP=JP)
PORT = NS(R=tr1cs, Boolean=tbool.Boolean, FpG=tfp.FpG, EF=tef, G=tgroups,
          P=tpairing, PP=TP)
FIELDS = ["MNT4753_FQ", "MNT6753_FQ"]


def both(build, field):
    """build(pkg, cs) in each package on a fresh system over ``field``:
    the two systems, held equal entry for entry, and the port's output."""
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        cs = pkg.R.ConstraintSystem(getattr(pkg.PP, field))
        out[name] = (cs, build(pkg, cs))
    (jcs, _), (tcs, got) = out["jax"], out["port"]
    assert (tcs.num_constraints, tcs.num_inputs, tcs.num_aux) == \
        (jcs.num_constraints, jcs.num_inputs, jcs.num_aux)
    assert tcs.names == jcs.names
    assert (tcs.at, tcs.bt, tcs.ct) == (jcs.at, jcs.bt, jcs.ct)
    assert tcs.assignment() == jcs.assignment()
    assert tcs.which_is_unsatisfied() is None
    return tcs, got


def lie(cs, var):
    """Add one to a witness value: the system must refuse it."""
    p = cs.field.modulus
    k = var - cs.num_inputs
    cs.aux_values[k] = (cs.aux_values[k] + 1) % p
    assert cs.which_is_unsatisfied() is not None


# ---------------- booleans ----------------

@pytest.mark.parametrize("field", FIELDS)
def test_boolean_ops(field):
    def build(pkg, cs):
        B = pkg.Boolean
        x = B.alloc_input(cs, 1, "x")
        vals, outs = [], []
        for av in (0, 1):
            for bv in (0, 1):
                a, b = B.alloc(cs, av, "a"), B.alloc(cs, bv, "b")
                outs += [a.xor(cs, b), a.and_(cs, b), a.or_(cs, b),
                         a.not_(), a.xor(cs, B.const(True)),
                         B.const(False).and_(cs, b)]
                vals += [av ^ bv, av & bv, av | bv, 1 - av, 1 - av, 0]
        k = B.kary_and(cs, [x, B.alloc(cs, 1), B.alloc(cs, 1)])
        k.enforce_equal(cs, x)
        B.enforce_nand(cs, [x, B.alloc(cs, 0)])
        B.enforce_in_field(cs, [B.alloc(cs, v) for v in (1, 0, 0)], 5)
        assert [o.get_value() for o in outs] == vals
        return outs[1]                  # 0 AND 0, an allocated AND output

    cs, a_and_b = both(build, field)
    lie(cs, a_and_b.var)


# ---------------- Fp wires ----------------

@pytest.mark.parametrize("field", FIELDS)
def test_fp_mul_inverse_select_is_eq(field):
    def build(pkg, cs):
        F = pkg.FpG
        p = cs.field.modulus
        a, b = F.alloc(cs, 1234567), F.alloc(cs, 7654321)
        prod = a.mul(b)
        assert prod.value == 1234567 * 7654321 % p
        assert a.inverse().value == pow(1234567, -1, p)
        sel = F.cond_select(pkg.Boolean.alloc(cs, 1), a, b)
        assert sel.value == a.value
        c = a.add(b).sub(F.constant(cs, 5)).neg().mul_by_constant(3)
        c.add_constant(7).double().square().mul_equals(
            a, F.alloc(cs, c.add_constant(7).double().square().value
                       * a.value % p))
        assert [a.is_eq(F.alloc(cs, 1234567)).get_value(),
                a.is_eq(b).get_value(), a.is_zero().get_value(),
                F.constant(cs, 0).is_zero().get_value()] == [1, 0, 0, 1]
        return prod

    cs, prod = both(build, field)
    lie(cs, next(iter(prod.lc.terms)))


@pytest.mark.parametrize("field", FIELDS)
def test_fp_to_bits_round_trip(field):
    def build(pkg, cs):
        v = random.Random(field).randrange(cs.field.modulus)
        a = pkg.FpG.alloc(cs, v)
        bits = a.to_bits_strict()
        assert len(bits) == cs.field.modulus.bit_length()
        pkg.FpG.from_bits(cs, bits).enforce_equal(a)
        short = pkg.FpG.alloc(cs, v >> 3).to_bits_with_length_restriction(3)
        assert len(short) == len(bits) - 3
        return bits

    cs, bits = both(build, field)
    lie(cs, bits[-1].var)


@pytest.mark.parametrize("field", FIELDS)
def test_lookups(field):
    def build(pkg, cs):
        B, F = pkg.Boolean, pkg.FpG
        p = cs.field.modulus
        table = [11, 22, 33, 44]
        outs = []
        for idx in range(4):
            b0, b1 = B.alloc(cs, idx & 1), B.alloc(cs, idx >> 1)
            out = F.two_bit_lookup(cs, (b0, b1), table)
            b2 = B.alloc(cs, idx % 3 == 0)
            out2 = F.three_bit_cond_neg_lookup(cs, (b0, b1, b2),
                                               b0.and_(cs, b1), table)
            assert out.value == table[idx]
            assert out2.value == (-table[idx] if idx % 3 == 0
                                  else table[idx]) % p
            outs.append(out2)
        return outs

    cs, outs = both(build, field)
    lie(cs, next(iter(outs[2].lc.terms)))


# ---------------- extension fields ----------------

TOWERS = {
    "MNT4753_FQ": ("build_mnt4_tower_gadgets", TG.MNT4753_FQ2,
                   HE.build_mnt4_host_towers),
    "MNT6753_FQ": ("build_mnt6_tower_gadgets", TG.MNT6753_FQ3,
                   HE.build_mnt6_host_towers),
}


@pytest.mark.parametrize("field", FIELDS)
def test_tower_gadgets(field):
    """Fq2 and Fq4 (MNT4-753) or Fq3 and Fq6 (MNT6-753): products,
    squares, inverses, Frobenius maps, constant products and conjugates,
    each value against the port's host tower (``fields/host_ext.py``), and
    the gadgets' own host multiply and inverse against it too."""
    builder, sub_params, host_towers = TOWERS[field]
    nr = sub_params["nonresidue"]
    p = getattr(TP, field).modulus
    H = host_towers(p, nr)[1:]

    def build(pkg, cs):
        rng = random.Random(field)
        gadgets = getattr(pkg.EF, builder)(getattr(pkg.PP, field), nr)[1:]
        outs = []
        for G, T in zip(gadgets, H):
            av = [rng.randrange(p) for _ in range(G.K)]
            bv = [rng.randrange(p) for _ in range(G.K)]
            a, b = G.alloc(cs, av), G.alloc(cs, bv)
            prod = G.mul(cs, a, b)
            assert G.value(prod) == HE.host_ext_mul(T, av, bv)
            assert G.value(G.sqr(cs, a)) == HE.host_ext_mul(T, av, av)
            inv = G.inv(cs, a)
            assert G.value(inv) == HE.host_ext_inv(T, av)
            G.enforce_equal(cs, G.mul(cs, a, inv), G.one(cs))
            assert G.value(G.frob(cs, a, 1)) == HE.host_ext_frob(T, av, 1)
            assert G.value(G.mul_by_const(cs, a, bv)) == \
                HE.host_ext_mul(T, av, bv)
            if G.degree == 2:
                G.conjugate(cs, a)
            assert pkg.G._host_ext_mul(G, av, bv) == \
                HE.host_ext_mul(T, av, bv)
            assert pkg.G._host_ext_inv(G, av) == HE.host_ext_inv(T, av)
            outs.append(prod)
        return outs

    cs, outs = both(build, field)
    lie(cs, next(iter(outs[-1][0].lc.terms)))


# ---------------- group gadgets ----------------

CURVES = {"MNT4753_FQ": ("mnt4753", CG.MNT4753),
          "MNT6753_FQ": ("mnt6753", CG.MNT6753)}


@pytest.mark.parametrize("field", FIELDS)
def test_sw_gadget_add_double_mul_bits(field):
    """G1 and G2 of the curve over ``field``: alloc_checked, double, add,
    neg and select, mul_bits (variable base) and mul_bits_const_base,
    every point against the port's python-int curve."""
    family, c = CURVES[field]
    g1h, g2h, _ = host_curves(family)
    builder, sub_params, _ = TOWERS[field]
    k = 0b1011011

    def build(pkg, cs):
        base, sub = getattr(pkg.EF, builder)(
            getattr(pkg.PP, field), sub_params["nonresidue"])[:2]
        outs = []
        for ops, curve, a, b in ((base, g1h, [c["a"]], [c["b"]]),
                                 (sub, g2h, c["g2_a"], c["g2_b"])):
            gadget = pkg.G.SWGroupGadget(ops, a, b)

            def value(pt):
                return ([w.value for w in pt.x], [w.value for w in pt.y])

            P = gadget.alloc_checked(cs, curve.gen, "G")
            D = gadget.double(cs, P)
            assert value(D) == curve.double(curve.gen)
            S = gadget.add(cs, D, P)
            assert value(S) == curve.mul(curve.gen, 3)
            N = gadget.neg(cs, S)
            assert value(gadget.cond_select(
                cs, pkg.Boolean.alloc(cs, 0), S, N)) == curve.neg(value(S))
            bits = [pkg.Boolean.alloc(cs, (k >> i) & 1) for i in range(7)]
            M = gadget.mul_bits(cs, S, P, bits)
            assert value(M) == curve.add(curve.gen, curve.mul(
                value(S), k))
            MC = gadget.mul_bits_const_base(cs, curve.mul(curve.gen, 5),
                                            bits, D)
            assert value(MC) == curve.add(value(D), curve.mul(
                curve.gen, 5 * k))
            outs.append(M)
        return outs

    cs, outs = both(build, field)
    lie(cs, next(iter(outs[1].y[0].lc.terms)))


# ---------------- the pairing gadget ----------------

def test_pairing_gadget_bilinearity():
    """e([5]G, [7]H) e(-[35]G, H) = 1 over MNT4-753, one Miller loop over
    both pairs and one final exponentiation; e([5]G, [7]H) != 1 (python
    ints)."""
    g1h, g2h, _ = host_curves("mnt4753")
    P1, Q1 = g1h.mul(g1h.gen, 5), g2h.mul(g2h.gen, 7)
    assert host_mnt4753_pairing().pairing(P1, Q1) != [1, 0, 0, 0]

    def build(pkg, cs):
        pg, base, _, fqk = pkg.P.mnt4753_pairing_gadget()
        c = CG.MNT4753
        g1 = pkg.G.SWGroupGadget(base, [c["a"]], [c["b"]])
        gt = pg.pairing_product(cs, [
            g1.alloc_checked(cs, P1, "aG"),
            g1.alloc_checked(cs, g1h.neg(g1h.mul(g1h.gen, 35)), "-abG")], [
            pg.g2.alloc_checked(cs, Q1, "bH"),
            pg.g2.alloc_checked(cs, g2h.gen, "H")], "e")
        fqk.enforce_equal(cs, gt, fqk.one(cs), "bilinearity")
        assert fqk.value(gt) == [1, 0, 0, 0]
        return gt

    cs, gt = both(build, "MNT4753_FQ")
    lie(cs, cs.num_inputs)       # aG.x, in the first constraints
