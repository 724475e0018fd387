"""Port vs JAX package: SW6 (CP6-782, 49 digits) and MNT6-298 (19 digits), the
two curves whose fields have an odd digit count -- the Fq3/Fq6 towers
(gingerlib_tpu_torch.fields.towers), G1 and G2 (curves.instances, with
``find_wnaf``), the MNT6-shaped pairings (curves.pairing_mnt) and their
python-int oracles (curves.pairing_host), and Groth16 and GM17 over
MNT6-298 -- on ``device="cpu"``, against the JAX package's constants and
oracles, the port's python-int towers and curves, the closed-form proof
oracles and the pinned SW6 GT vector.  Integer arithmetic: tolerance 0.

Fast tier (~30 s in one process): the field constants, Frobenius tables,
curve constants, generators and loop digits against the JAX package's;
Fq3/Fq6 products, squares and Frobenius maps, inverses, and G1/G2 addition,
doubling, batched affine addition and scalar multiples against python ints
on small seeded batches; the MNT6-298 pairing against both packages'
oracles with e(3P, 5Q) = e(P, Q)^15; SW6's oracle against the pinned GT
and the JAX package's oracle, and a 12-digit SW6 Miller loop with a 16-bit
hard part against the oracle built with the same digits; the closed-form
Groth16 and GM17 oracles against the host provers (both packages' host
GM17) on the one-constraint circuit.  ``slow``: the towers and curve
operations against the JAX package's eager functions (compiles), the full
SW6 pairing on the CPU (~25 s) and Groth16 and GM17 setup, prove and
verify over MNT6-298 on the CPU (~60-70 s each).
"""

import random

import numpy as np
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.curves import instances as JCI
from gingerlib_tpu.curves import pairing_host as JPH
from gingerlib_tpu.proofs import gm17_host as jgm17_host
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.curves import pairing_host as TPH
from gingerlib_tpu_torch.curves.pairing_mnt import MNTPairing
from gingerlib_tpu_torch.fields import host_ext as HE
from gingerlib_tpu_torch.fields import towers as TT
from gingerlib_tpu_torch.params._gen import curves_gen as CG
from gingerlib_tpu_torch.params._gen import towers_gen as TG
from gingerlib_tpu_torch.proofs import gm17 as tgm17
from gingerlib_tpu_torch.proofs import gm17_host as TGH
from gingerlib_tpu_torch.proofs import groth16 as tgroth16
from gingerlib_tpu_torch.proofs import groth16_host as thost
from gingerlib_tpu_torch.relations import r1cs as tr1cs
from test_torch_cases import (SW6_GT_G1G2, affine_pairs,
                              one_constraint_circuit, proj_pairs, rand_below)

torch.set_num_threads(1)
CPU = "cpu"
FAMILIES = {
    # name: (Fq, Fr, Fq3 and Fq6 tables, curve constants, JAX Fq)
    "mnt6298": (TP.MNT6298_FQ, TP.MNT6298_FR, TG.MNT6298_FQ3,
                TG.MNT6298_FQ6, CG.MNT6298, JP.MNT6298_FQ),
    "sw6": (TP.SW6_FQ, TP.SW6_FR, TG.SW6_FQ3, TG.SW6_FQ6, CG.SW6,
            JP.SW6_FQ),
}
TOXIC = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)
BLIND = dict(r=31337, s=71717)
GM17_TOXIC = dict(alpha=123, beta=456, t=13579)
GM17_RAND = dict(d1=11, d2=22, r=333)


def jax_digits(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def as_jax(t):
    return t.numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# constants, tables and loop digits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_fields_towers_and_tables_match_jax(family):
    """Both fields' constants (odd digit counts: 19 and 49), the Frobenius
    tables of Fq3 and Fq6 against the reference's and the JAX package's,
    and the towers' nonresidues."""
    fq, fr, t3, t6, _, jfq = FAMILIES[family]
    assert fq.n_digits % 2 == 1 and fq.n_digits in (19, 49)
    for attr in ("modulus", "n_digits", "r", "r2", "r_inv", "nprime"):
        assert getattr(fq, attr) == getattr(jfq, attr), attr
    for attr in ("one_mont", "r2_digits", "r3_digits"):
        assert np.array_equal(getattr(fq, attr),
                              np.asarray(getattr(jfq, attr), np.int64))
    p, nr = fq.modulus, t3["nonresidue"]
    c1, c2 = HE.frob_table_fp3(p, nr)
    assert c1 == [v % p for v in t3["frobenius_coeff_fp3_c1"]]
    assert c2 == [v % p for v in t3["frobenius_coeff_fp3_c2"]]
    assert HE.frob_table_fp6_2over3(p, nr) == [
        v % p for v in t6["frobenius_coeff_fp6_c1"]]
    _, t3_mine, t6_mine = getattr(TCI, f"{family}_towers")()
    _, t3_jax, _ = getattr(JCI, f"{family}_towers")()
    assert np.array_equal(t3_mine.tensor("nonresidue", CPU).numpy(),
                          np.asarray(t3_jax.nr, np.int64))
    for mine, jax_c in ((t3_mine._c1, t3_jax.frob_c1),):
        assert [list(c) for c in mine] == [
            TT.ext_to_ints(t3_mine.sf, torch.from_numpy(
                np.asarray(c, np.int64))) for c in jax_c]
    for m in (t3_mine, t6_mine):
        for k in (1, 2, 3):
            x = torch.from_numpy(m.const(rand_below(p, m.K, seed=k)))
            assert TT.ext_to_ints(m, m.frob(x, k)) == HE.host_ext_frob(
                _host_tower(family, m.K), TT.ext_to_ints(m, x), k)


def _host_tower(family, K):
    fq, _, t3, _, _, _ = FAMILIES[family]
    _, h3, h6 = HE.build_mnt6_host_towers(fq.modulus, t3["nonresidue"])
    return h3 if K == 3 else h6


@pytest.mark.parametrize("family", list(FAMILIES))
def test_curves_and_loop_digits_match_jax(family):
    """G1 and G2 constants and generators digit for digit, the scalar
    fields, ``find_wnaf`` on the loop count (782 and 149 bits) and the
    pairing's other arguments, against the JAX package's."""
    for group in ("g1", "g2"):
        jg = getattr(JCI, f"{family}_{group}")()
        tg = getattr(TCI, f"{family}_{group}")(CPU)
        for a, b in zip((jg.a, jg.b) + tuple(jg.generator_affine),
                        (tg.a, tg.b) + tuple(tg.generator_affine)):
            assert torch.equal(b, jax_digits(a))
        assert tg.scalar_field.modulus == jg.scalar_field.modulus
        assert bool(tg.on_curve(*tg.generator_affine))
    c = FAMILIES[family][4]
    assert TCI.find_wnaf(c["ate_loop_count"]) == \
        JCI.find_wnaf(c["ate_loop_count"])
    rng = random.Random(5)
    for n in [1, 2, 3, 7] + [rng.randrange(1, 1 << 200) for _ in range(20)]:
        assert TCI.find_wnaf(n) == JCI.find_wnaf(n), n
        digits = TCI.find_wnaf(n) + [1]
        assert sum(d << i for i, d in enumerate(digits)) == n
    E = TCI._mnt_pairing(family, torch.device(CPU))
    H = getattr(JPH, f"host_{family}_pairing")()
    assert (E.w1, E.w0_abs, E.w0_is_neg, E.ate_is_neg) == \
        (H.w1, H.w0_abs, H.w0_is_neg, H.ate_is_neg)
    digits = list(reversed(E.wnaf)) + [1]       # the loop runs MSB first
    assert sum(d << i for i, d in enumerate(digits)) == c["ate_loop_count"]


# ---------------------------------------------------------------------------
# the towers and the curves against python ints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_fq3_fq6_against_python_ints(family):
    """Products, squares, Frobenius maps and inverses of four elements
    (zero and one among them) in Fq3 and Fq6."""
    fq = FAMILIES[family][0]
    _, t3, t6 = getattr(TCI, f"{family}_towers")()
    for F in (t3, t6):
        H = _host_tower(family, F.K)
        vals = [[0] * F.K, [1] + [0] * (F.K - 1)] + [
            rand_below(fq.modulus, F.K, seed=s) for s in (1, 2)]
        x = torch.from_numpy(np.stack([F.const(v) for v in vals]))
        y = x.flip(0)
        for got, a, b in zip(F.mul(x, y), vals, vals[::-1]):
            assert TT.ext_to_ints(F, got) == HE.host_ext_mul(H, a, b)
        for got, a in zip(F.sqr(x), vals):
            assert TT.ext_to_ints(F, got) == HE.host_ext_mul(H, a, a)
        for got, a in zip(F.frob(x, 1), vals):
            assert TT.ext_to_ints(F, got) == HE.host_ext_frob(H, a, 1)
        for got, a in zip(F.inv(x[2:]), vals[2:]):
            assert TT.ext_to_ints(F, got) == HE.host_ext_inv(H, a)


@pytest.fixture(scope="module", params=["mnt6298_g1", "mnt6298_g2",
                                        "sw6_g1", "sw6_g2"])
def curve_case(request):
    """The port's curve, the python-int one, and 9 distinct multiples of
    the generator (projective and affine)."""
    family, group = request.param.split("_")
    tg = getattr(TCI, request.param)(CPU)
    ks = np.asarray([[3 + 7 * i] for i in range(9)], dtype=np.int64)
    proj = tg.mul_scalar_digits(tg.generator((9,)), torch.from_numpy(ks))
    host = thost.host_curves(family)[0 if group == "g1" else 1]
    return dict(tg=tg, host=host, proj=proj, aff=tg.to_affine(proj),
                ks=[int(k) for k in ks[:, 0]], name=request.param)


def _affine_ints(tg, x, y, inf=None):
    out = []
    for i in range(x.shape[0]):
        u, v = TT.ext_to_ints(tg.F, x[i]), TT.ext_to_ints(tg.F, y[i])
        dead = bool(inf[i]) if inf is not None else not any(u + v)
        out.append(None if dead else (u, v))
    return out


def test_group_laws_against_python_ints(curve_case):
    """The unified addition over every special lane (equal, opposite,
    infinity on either side; the fabricated y = 0 lane 5 is no curve point
    and is left out), the doubling, the batched affine addition and the
    scalar multiples."""
    tg, host = curve_case["tg"], curve_case["host"]
    P_, Q_ = proj_pairs(tg, curve_case["proj"])
    ps = _affine_ints(tg, *tg.to_affine(P_))
    qs = _affine_ints(tg, *tg.to_affine(Q_))
    sums = _affine_ints(tg, *tg.to_affine(tg.add(P_, Q_)))
    dbls = _affine_ints(tg, *tg.to_affine(tg.double(P_)))
    for i in range(len(ps)):
        if i == 5:
            continue
        assert sums[i] == host.add(ps[i], qs[i]), i
        assert dbls[i] == host.double(ps[i]), i
    a_pt, b_pt = affine_pairs(tg, curve_case["aff"])
    (x, y), inf = tg.batch_affine_add(a_pt, b_pt)
    got = _affine_ints(tg, x, y, inf)
    a_in = _affine_ints(tg, *a_pt[0], a_pt[1])
    b_in = _affine_ints(tg, *b_pt[0], b_pt[1])
    for lane in range(len(got)):
        if lane == 5:
            continue
        assert got[lane] == host.add(a_in[lane], b_in[lane]), lane
    ax, ay = curve_case["aff"]
    for i, k in enumerate(curve_case["ks"]):
        assert (TT.ext_to_ints(tg.F, ax[i]), TT.ext_to_ints(tg.F, ay[i])) \
            == host.mul(host.gen, k)


# ---------------------------------------------------------------------------
# the pairings
# ---------------------------------------------------------------------------

def _generators(family):
    c = FAMILIES[family][4]
    return ([c["g1_x"]], [c["g1_y"]]), (list(c["g2_x"]), list(c["g2_y"]))


def test_mnt6298_pairing_against_both_oracles():
    """e(G1, G2) on the CPU path against the port's and the JAX package's
    python-int oracles; e(3P, 5Q) = e(P, Q)^15; GT^r = 1."""
    E = TCI.mnt6298_pairing(CPU)
    mine, theirs = TPH.host_mnt6298_pairing(), JPH.host_mnt6298_pairing()
    pa, qb = _generators("mnt6298")
    gt = E.pairing(E.g1.affine_from_ints(*pa), E.g2.affine_from_ints(*qb))
    want = mine.pairing(pa, qb)
    assert TT.ext_to_ints(E.fqk, gt) == want == theirs.pairing(pa, qb)
    g1, g2, fr = thost.host_curves("mnt6298")
    p3, q5 = g1.mul(g1.gen, 3), g2.mul(g2.gen, 5)
    e35 = E.pairing(E.g1.affine_from_ints(*p3), E.g2.affine_from_ints(*q5))
    assert TT.ext_to_ints(E.fqk, e35) == mine._fpow(want, 15)
    assert mine._fpow(want, fr.modulus) == mine._fone() != want


def test_sw6_oracle_matches_pinned_vector_and_jax():
    """The port's SW6 oracle on the generators reproduces the pinned GT
    (the reference's 782-bit loop) and the JAX package's oracle value."""
    pa, qb = _generators("sw6")
    mine = TPH.host_sw6_pairing()
    f = mine.miller_loop(pa, qb)
    assert f == JPH.host_sw6_pairing().miller_loop(pa, qb)
    assert mine.final_exponentiation(f) == SW6_GT_G1G2


SHORT_W0 = 0xB5A7


def test_sw6_short_loop_against_the_oracle():
    """The prepared Miller loop over the top 12 digits of SW6's loop count
    (doublings and +-1 additions, 49-digit Fq3 lines) and a final
    exponentiation with a 16-bit hard part, against the python-int oracle
    built with the same arguments, at G1's generator and its negation."""
    E = TCI.sw6_pairing(CPU)
    wnaf = TCI.find_wnaf(CG.SW6["ate_loop_count"])[-12:]
    assert 1 in wnaf or -1 in wnaf
    short = MNTPairing("sw6_short", E.g1, E.g2, E.fqk, wnaf, E.ate_is_neg,
                       E.w1, SHORT_W0, E.w0_is_neg, 3, True)
    H = TPH.host_sw6_pairing()
    host = TPH.HostMNTPairing(H.p, H.S, H.F, H.g2_a, wnaf, H.ate_is_neg,
                              H.w1, SHORT_W0, H.w0_is_neg, 3, True)
    pa, qb = _generators("sw6")
    q = E.g2.affine_from_ints(*qb)
    prep = short.prepare_g2(q)
    for neg in (False, True):
        px, py = E.g1.affine_from_ints(*pa)
        a = pa
        if neg:
            py = E.g1.F.neg(py)
            a = (pa[0], [(-pa[1][0]) % H.p])
        f = short.miller_loop_prepared((px, py), prep)
        assert TT.ext_to_ints(short.fqk, f) == host.miller_loop(a, qb)
        got = short.final_exponentiation(f)
        assert TT.ext_to_ints(short.fqk, got) == host.pairing(a, qb)


@pytest.mark.slow
def test_sw6_pairing_matches_pinned_vector():
    """The full SW6 pairing (782-bit loop) on the CPU path: the pinned GT
    on the generators."""
    E = TCI.sw6_pairing(CPU)
    pa, qb = _generators("sw6")
    gt = E.pairing(E.g1.affine_from_ints(*pa), E.g2.affine_from_ints(*qb))
    assert TT.ext_to_ints(E.fqk, gt) == SW6_GT_G1G2


# ---------------------------------------------------------------------------
# Groth16 and GM17 over MNT6-298
# ---------------------------------------------------------------------------

def _host_point(pt):
    """A JAX host point (a tuple of ints or of lists, or None) in the
    port's form ([x comps], [y comps])."""
    if pt is None:
        return None
    return tuple(list(c) if isinstance(c, (list, tuple)) else [c]
                 for c in pt)


def test_mnt6298_closed_forms_equal_the_host_provers():
    """On 7 * 11 = 77: ``expected_proof`` equals the port's host Groth16
    prover and verifies; ``expected_gm17_proof`` equals the port's host
    GM17 prover and the JAX package's ``host_gm17_mnt6298``; a wrong input
    is refused by both host verifiers."""
    from test_torch_groth16 import jax_copy
    fr = TP.MNT6298_FR
    cs = one_constraint_circuit(fr)
    want = thost.expected_proof("mnt6298", cs, **TOXIC, **BLIND)
    hg = thost.host_groth16_mnt6298()
    params = hg.setup(cs, **TOXIC)
    assert hg.prove(cs, params, **BLIND) == want
    assert hg.verify(params, want, [77]) and not hg.verify(params, want,
                                                           [78])
    gm = TGH.expected_gm17_proof("mnt6298", cs, **GM17_TOXIC, **GM17_RAND)
    hgm = TGH.host_gm17_mnt6298()
    gparams = hgm.setup(cs, **GM17_TOXIC)
    assert hgm.prove(cs, gparams, **GM17_RAND) == gm
    assert hgm.verify(gparams, gm, [77]) and not hgm.verify(gparams, gm,
                                                            [78])
    jh = jgm17_host.host_gm17_mnt6298()
    jcs = jax_copy(cs, JP.MNT6298_FR)
    jproof = jh.prove(jcs, jh.setup(jcs, **GM17_TOXIC, gamma=1),
                      **GM17_RAND)
    assert {k: _host_point(v) for k, v in jproof.items()} == gm


@pytest.fixture(scope="module")
def mnt6298_groth16():
    eng = TCI.mnt6298_engine(CPU)
    cs = one_constraint_circuit(eng.g1.scalar_field)
    params = tgroth16.generate_parameters(eng, cs, **TOXIC, device=CPU)
    proof = tgroth16.create_proof(eng, params, tr1cs.compile_r1cs(
        cs, device=CPU), cs.assignment(), **BLIND, device=CPU)
    return dict(eng=eng, cs=cs, params=params, proof=proof)


@pytest.mark.slow
def test_mnt6298_groth16_on_the_cpu(mnt6298_groth16):
    """Setup and prove on the CPU path: the closed-form proof; verify
    accepts 77 and refuses 78 and a C moved by G1's generator."""
    eng, cs = mnt6298_groth16["eng"], mnt6298_groth16["cs"]
    proof, vk = mnt6298_groth16["proof"], mnt6298_groth16["params"].vk
    assert tgroth16.proof_to_ints(eng, proof) == thost.expected_proof(
        "mnt6298", cs, **TOXIC, **BLIND)
    assert tgroth16.verify_proof(eng, vk, proof, [77])
    assert not tgroth16.verify_proof(eng, vk, proof, [78])
    g1 = eng.g1
    moved = tgroth16.Proof(a=proof.a, b=proof.b, c=g1.to_affine(
        g1.add_mixed(g1.from_affine(*proof.c), g1.generator_affine)))
    assert not tgroth16.verify_proof(eng, vk, moved, [77])


@pytest.mark.slow
def test_mnt6298_gm17_on_the_cpu():
    """GM17 setup, prove and verify on the CPU path: the closed-form
    proof, 77 accepted, 78 refused."""
    eng = TCI.mnt6298_engine(CPU)
    cs = one_constraint_circuit(eng.g1.scalar_field)
    params = tgm17.generate_parameters(eng, cs, **GM17_TOXIC, device=CPU)
    proof = tgm17.create_proof(eng, params, tgm17.compile_circuit(
        cs, device=CPU), cs.assignment(), **GM17_RAND, device=CPU)
    assert tgroth16.proof_to_ints(eng, proof) == TGH.expected_gm17_proof(
        "mnt6298", cs, **GM17_TOXIC, **GM17_RAND)
    assert tgm17.verify_proof(eng, params.vk, proof, [77])
    assert not tgm17.verify_proof(eng, params.vk, proof, [78])


# ---------------------------------------------------------------------------
# the JAX package's eager functions (compiles)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("family", list(FAMILIES))
def test_towers_and_curves_match_jax(family):
    """Fq3/Fq6 products and Frobenius maps and G1/G2 addition and doubling
    against the JAX package's eager functions, digit for digit."""
    fq = FAMILIES[family][0]
    mine = getattr(TCI, f"{family}_towers")()
    theirs = getattr(JCI, f"{family}_towers")()
    for m, j in zip(mine[1:], theirs[1:]):
        vals = [rand_below(fq.modulus, m.K, seed=s) for s in (3, 4)]
        x = torch.from_numpy(np.stack([m.const(v) for v in vals]))
        assert torch.equal(m.mul(x, x.flip(0)),
                           jax_digits(j.mul(as_jax(x), as_jax(x.flip(0)))))
        assert torch.equal(m.frob(x, 1), jax_digits(j.frob(as_jax(x), 1)))
    for group in ("g1", "g2"):
        tg = getattr(TCI, f"{family}_{group}")(CPU)
        jg = getattr(JCI, f"{family}_{group}")()
        ks = np.asarray([[3 + 7 * i] for i in range(9)], dtype=np.int64)
        proj = tg.mul_scalar_digits(tg.generator((9,)),
                                    torch.from_numpy(ks))
        P_, Q_ = proj_pairs(tg, proj)
        got = tg.add(P_, Q_) + tg.double(P_)
        want = jg.add(tuple(map(as_jax, P_)), tuple(map(as_jax, Q_))) + \
            jg.double(tuple(map(as_jax, P_)))
        for g, w in zip(got, want):
            assert torch.equal(g, jax_digits(w))
