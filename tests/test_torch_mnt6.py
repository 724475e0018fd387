"""Port vs JAX package: the MNT6-753 slice -- the Fq3/Fq6 towers
(gingerlib_tpu_torch.fields.towers), the curves G1 over Fq and G2 over Fq3
(curves.instances), the MNT6 pairing (curves.pairing_mnt) and its
python-int oracle (curves.pairing_host), and Groth16 over MNT6-753 -- on
``device="cpu"``, against the JAX package's eager functions, its host
oracles, the port's own python-int towers and the reference's pinned
anchor.  Integer arithmetic: tolerance 0, every digit must agree.

Fast tier (~80 s in one process, cold XLA cache): the Fq3/Fq6 methods on
four elements (zero and one among them) against the JAX package, the line
shape ``mul_by_2345``, the cyclotomic square, the inverses and the power
chains at 16-bit exponents against python ints, the curves' addition,
doubling and batched affine addition against python ints,
``prepare_g2`` at full length against the JAX package, a 12-digit Miller
loop and a 16-bit final exponentiation against the python-int oracle, the
full pairing against the anchor, and the radix-2 domain's limit at 2^15.
``slow``: the same inverses, curve operations and short loop against the
JAX package's (its compiles take ~3.5 min), and Groth16 setup, prove and
verify over MNT6-753 on the CPU (~5 min).
"""

import numpy as np
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.curves import instances as JCI
from gingerlib_tpu.curves import pairing_host as JPH
from gingerlib_tpu.curves.pairing_mnt import MNTPairing as JMNTPairing
from gingerlib_tpu.fields import towers as JT
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.circuits import benchmark_circuit
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.curves import pairing_host as TPH
from gingerlib_tpu_torch.curves.pairing_mnt import MNTPairing
from gingerlib_tpu_torch.fields import host_ext as HE
from gingerlib_tpu_torch.fields import towers as TT
from gingerlib_tpu_torch.ops import limbs
from gingerlib_tpu_torch.params._gen import curves_gen as CG
from gingerlib_tpu_torch.params._gen import towers_gen as TG
from gingerlib_tpu_torch.proofs import groth16 as tgroth16
from gingerlib_tpu_torch.proofs import groth16_host as thost
from gingerlib_tpu_torch.relations import r1cs as tr1cs
from test_torch_cases import (affine_pairs, host_alpha_beta, mnt6753_anchor,
                              one_constraint_circuit, proj_pairs, rand_below)
from test_torch_groth16 import RAND, TOXIC

torch.set_num_threads(1)
P = TP.MNT6753_FQ.modulus
NR3 = TG.MNT6753_FQ3["nonresidue"]


def jax_digits(a):
    """A JAX result as the port's int64 digits."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def as_jax(t):
    return t.numpy().astype(np.uint32)


@pytest.fixture(scope="module")
def towers():
    """The port's (Fq3, Fq6), the JAX package's, the host towers, and four
    Fq6 elements x (zero, one, two seeded) and y (the same, reversed)."""
    _, t3, t6 = TT.build_mnt6_towers(TP.MNT6753_FQ, NR3)
    _, j3, j6 = JT.build_mnt6_towers(JP.MNT6753_FQ, NR3)
    _, h3, h6 = HE.build_mnt6_host_towers(P, NR3)
    vals = [[0] * 6, [1, 0, 0, 0, 0, 0]] + [rand_below(P, 6, seed=s)
                                            for s in (1, 2)]
    x = torch.from_numpy(np.stack([t6.const(v) for v in vals]))
    return dict(t3=t3, t6=t6, j3=j3, j6=j6, h3=h3, h6=h6, x=x, y=x.flip(0))


def test_frobenius_tables_match_the_reference():
    c1, c2 = HE.frob_table_fp3(P, NR3)
    assert c1 == [v % P for v in TG.MNT6753_FQ3["frobenius_coeff_fp3_c1"]]
    assert c2 == [v % P for v in TG.MNT6753_FQ3["frobenius_coeff_fp3_c2"]]
    assert HE.frob_table_fp6_2over3(P, NR3) == [
        v % P for v in TG.MNT6753_FQ6["frobenius_coeff_fp6_c1"]]


TOWER_OPS = {
    "mul": lambda F, x, y: F.mul(x, y),
    "sqr": lambda F, x, y: F.sqr(x),
    "frob0": lambda F, x, y: F.frob(x, 0),
    "frob1": lambda F, x, y: F.frob(x, 1),
    "frob2": lambda F, x, y: F.frob(x, 2),
    "frob3": lambda F, x, y: F.frob(x, 3),
    "frob5": lambda F, x, y: F.frob(x, 5),
    "mul_by_gen": lambda F, x, y: F.mul_by_gen(x),
}
FQ3_OPS = dict(TOWER_OPS, **{
    # x * (b0 + b1 X) and x * (b1 X), b0 and b1 base-field components of y
    "mul_by_01": lambda F, x, y: F.mul_by_01(x, y[..., :1, :],
                                             y[..., 1:2, :]),
    "mul_by_1": lambda F, x, y: F.mul_by_1(x, y[..., 1:2, :]),
    "mul_by_sub": lambda F, x, y: F.mul_by_sub(x, y[..., 2:, :]),
})
FQ6_OPS = dict(TOWER_OPS, **{
    "conjugate": lambda F, x, y: F.conjugate(x),
    # the MNT6 line x * (a X^2 + c1 Y): a from y's last component, c1 y's
    # first half
    "mul_by_2345": lambda F, x, y: F.mul_by_2345(x, y[..., 5, :],
                                                 y[..., :3, :]),
    "mul_by_sub": lambda F, x, y: F.mul_by_sub(x, y[..., 3:, :]),
})


@pytest.mark.parametrize("op", list(FQ3_OPS))
def test_fq3_matches_jax(towers, op):
    x, y = towers["x"][..., :3, :], towers["y"][..., 3:, :]
    got = FQ3_OPS[op](towers["t3"], x, y)
    assert torch.equal(got, jax_digits(FQ3_OPS[op](towers["j3"], as_jax(x),
                                                   as_jax(y))))


@pytest.mark.parametrize("op", list(FQ6_OPS))
def test_fq6_matches_jax(towers, op):
    got = FQ6_OPS[op](towers["t6"], towers["x"], towers["y"])
    want = FQ6_OPS[op](towers["j6"], as_jax(towers["x"]),
                       as_jax(towers["y"]))
    assert torch.equal(got, jax_digits(want))


@pytest.mark.parametrize("degree", [3, 6])
def test_inverse_against_python_ints(towers, degree):
    F, H = towers[f"t{degree}"], towers[f"h{degree}"]
    x = towers["x"][1:, :degree, :]
    assert [TT.ext_to_ints(F, g) for g in F.inv(x)] == [
        HE.host_ext_inv(H, TT.ext_to_ints(F, a)) for a in x]
    assert torch.equal(F.inv(towers["x"][:1, :degree, :]),
                       towers["x"][:1, :degree, :])        # 0 -> 0


@pytest.mark.slow
@pytest.mark.parametrize("degree", [3, 6])
def test_inverse_matches_jax(towers, degree):
    F, J = towers[f"t{degree}"], towers[f"j{degree}"]
    x = towers["x"][1:, :degree, :]
    assert torch.equal(F.inv(x), jax_digits(J.inv(as_jax(x))))


@pytest.mark.parametrize("degree", [3, 6])
def test_against_python_ints(towers, degree):
    """mul and every Frobenius power against the host tower arithmetic,
    Fq3's also against the closed forms ``cubic_mul`` / ``cubic_inv``, and
    frob(x, 1) against x^p."""
    F, H = towers[f"t{degree}"], towers[f"h{degree}"]
    x, y = towers["x"][..., :degree, :], towers["y"][..., :degree, :]
    xs = [TT.ext_to_ints(F, e) for e in x]
    ys = [TT.ext_to_ints(F, e) for e in y]
    for got, a, b in zip(F.mul(x, y), xs, ys):
        assert TT.ext_to_ints(F, got) == HE.host_ext_mul(H, a, b)
        if degree == 3:
            assert TT.ext_to_ints(F, got) == list(HE.cubic_mul(P, NR3, a, b))
    if degree == 3:
        assert HE.host_ext_inv(H, xs[2]) == list(HE.cubic_inv(P, NR3, xs[2]))
    for i in range(degree):
        for got, a in zip(F.frob(x, i), xs):
            assert TT.ext_to_ints(F, got) == HE.host_ext_frob(H, a, i)
    assert HE.host_ext_frob(H, xs[2], 1) == host_pow(H, xs[2], P)


@pytest.fixture(scope="module")
def unitary(towers):
    """frob(x, 3) / x for four non-zero x: unitary elements of Fq6."""
    t6 = towers["t6"]
    x = torch.cat([towers["x"][1:], torch.from_numpy(
        t6.const(rand_below(P, 6, seed=3)))[None]])
    return t6.mul(t6.frob(x, 3), t6.inv(x))


def test_cyclotomic_square_on_unitary_elements(towers, unitary):
    t6 = towers["t6"]
    got = t6.cyclotomic_square(unitary)
    assert torch.equal(got, t6.sqr(unitary))
    want = towers["j6"].cyclotomic_square(as_jax(unitary))
    assert torch.equal(got, jax_digits(want))


def host_pow(F, a, e):
    r = [1] + [0] * (F.K - 1)
    for bit in bin(e)[2:]:
        r = HE.host_ext_mul(F, r, r)
        if bit == "1":
            r = HE.host_ext_mul(F, r, a)
    return r


@pytest.mark.parametrize("e", [0, 1, 0xB5A7])
def test_power_chains(towers, unitary, e):
    """``ext_pow_const`` over Fq6 and Fq3, ``ext_cyclotomic_pow_const`` on
    unitary Fq6 elements, against python ints."""
    t6, h6 = towers["t6"], towers["h6"]
    got = TT.ext_pow_const(t6, towers["x"], limbs.bits_msb_first(e, 16))
    assert [TT.ext_to_ints(t6, g) for g in got] == [
        host_pow(h6, TT.ext_to_ints(t6, a), e) for a in towers["x"]]
    t3, x3 = towers["t3"], towers["x"][..., :3, :]
    got3 = TT.ext_pow_const(t3, x3, limbs.bits_msb_first(e, 16))
    assert [TT.ext_to_ints(t3, g) for g in got3] == [
        list(HE.cubic_pow(P, NR3, tuple(TT.ext_to_ints(t3, a)), e))
        for a in x3]
    cyc = TT.ext_cyclotomic_pow_const(t6, unitary, e)
    assert [TT.ext_to_ints(t6, g) for g in cyc] == [
        host_pow(h6, TT.ext_to_ints(t6, u), e) for u in unitary]


def test_batch_inverse_tree_over_fq3(towers):
    """Montgomery's trick over Fq3 (G2's ``to_affine`` and batched affine
    addition): zeros pass through."""
    t3, h3 = towers["t3"], towers["h3"]
    x = torch.cat([towers["x"][..., :3, :], towers["y"][..., 3:, :]])
    got = TT.ext_batch_inverse_tree(t3, x)
    for g, a in zip(got, x):
        v = TT.ext_to_ints(t3, a)
        want = HE.host_ext_inv(h3, v) if any(v) else [0, 0, 0]
        assert TT.ext_to_ints(t3, g) == want


# ---------------------------------------------------------------------------
# the curves
# ---------------------------------------------------------------------------

def test_generators_and_constants_match_jax():
    for group in ("g1", "g2"):
        jg = getattr(JCI, f"mnt6753_{group}")()
        tg = getattr(TCI, f"mnt6753_{group}")("cpu")
        for a, b in zip((jg.a, jg.b) + tuple(jg.generator_affine),
                        (tg.a, tg.b) + tuple(tg.generator_affine)):
            assert torch.equal(b, jax_digits(a))
        assert tg.scalar_field.modulus == jg.scalar_field.modulus
        assert bool(tg.on_curve(*tg.generator_affine))
    assert TCI.mnt6753_g2("cpu").F.K == 3


@pytest.fixture(scope="module", params=["g1", "g2"])
def curve_case(request):
    """The port's and the JAX package's curve, and 9 distinct multiples of
    the generator (projective, as the loop leaves them, and affine)."""
    group = request.param
    tg = getattr(TCI, f"mnt6753_{group}")("cpu")
    jg = getattr(JCI, f"mnt6753_{group}")()
    ks = np.asarray([[3 + 7 * i] for i in range(9)], dtype=np.int64)
    proj = tg.mul_scalar_digits(tg.generator((9,)), torch.from_numpy(ks))
    return dict(tg=tg, jg=jg, proj=proj, aff=tg.to_affine(proj),
                ks=[int(k) for k in ks[:, 0]], group=group)


def test_add_and_double_against_python_ints(curve_case):
    """The unified addition over every special lane (equal, opposite,
    infinity on either or both sides, a fabricated y = 0 doubling and
    equal points in two projective forms) and the doubling, in affine
    python ints; the fabricated lane is not a curve point and is left
    out."""
    tg = curve_case["tg"]
    host = thost.host_curves("mnt6753")[0 if curve_case["group"] == "g1"
                                        else 1]
    P_, Q_ = proj_pairs(tg, curve_case["proj"])

    def ints(pts):
        """Affine python ints, None for infinity ((0, 0) after
        ``to_affine``; no curve point has x = y = 0, since b != 0)."""
        x, y = tg.to_affine(pts)
        xy = [(TT.ext_to_ints(tg.F, u), TT.ext_to_ints(tg.F, v))
              for u, v in zip(x, y)]
        return [None if not any(u + v) else (u, v) for u, v in xy]

    ps, qs = ints(P_), ints(Q_)
    for i, (got, dbl) in enumerate(zip(ints(tg.add(P_, Q_)),
                                       ints(tg.double(P_)))):
        if i == 5:
            continue
        assert got == host.add(ps[i], qs[i]), i
        assert dbl == host.double(ps[i]), i


@pytest.mark.slow
def test_add_and_double_match_jax(curve_case):
    tg, jg = curve_case["tg"], curve_case["jg"]
    P_, Q_ = proj_pairs(tg, curve_case["proj"])
    got = tg.add(P_, Q_) + tg.double(P_)
    want = jg.add(tuple(map(as_jax, P_)), tuple(map(as_jax, Q_))) + \
        jg.double(tuple(map(as_jax, P_)))
    for g, w in zip(got, want):
        assert torch.equal(g, jax_digits(w))


def test_batch_affine_add_against_python_ints(curve_case):
    tg = curve_case["tg"]
    host = thost.host_curves("mnt6753")[0 if curve_case["group"] == "g1"
                                        else 1]
    a_pt, b_pt = affine_pairs(tg, curve_case["aff"])
    (x, y), inf = tg.batch_affine_add(a_pt, b_pt)

    def pt(xy, i, lane):
        return None if bool(i[lane]) else (TT.ext_to_ints(tg.F, xy[0][lane]),
                                           TT.ext_to_ints(tg.F, xy[1][lane]))

    for lane in range(x.shape[0]):
        if lane == 5:          # the fabricated y = 0 doubling
            continue
        want = host.add(pt(a_pt[0], a_pt[1], lane), pt(b_pt[0], b_pt[1],
                                                       lane))
        assert pt((x, y), inf, lane) == want, lane


@pytest.mark.slow
def test_batch_affine_add_matches_jax(curve_case):
    tg, jg = curve_case["tg"], curve_case["jg"]
    a_pt, b_pt = affine_pairs(tg, curve_case["aff"])
    (x, y), inf = tg.batch_affine_add(a_pt, b_pt)

    def j(pt):
        (x_, y_), i_ = pt
        return ((as_jax(x_), as_jax(y_)), i_.numpy())

    (jx, jy), jinf = jg.batch_affine_add(j(a_pt), j(b_pt))
    assert torch.equal(x, jax_digits(jx)) and torch.equal(y, jax_digits(jy))
    assert inf.tolist() == np.asarray(jinf).tolist()


def test_scalar_multiples_against_python_ints(curve_case):
    tg = curve_case["tg"]
    host = thost.host_curves("mnt6753")[0 if curve_case["group"] == "g1"
                                        else 1]
    ax, ay = curve_case["aff"]
    for i, k in enumerate(curve_case["ks"]):
        assert (TT.ext_to_ints(tg.F, ax[i]), TT.ext_to_ints(tg.F, ay[i])) \
            == host.mul(host.gen, k)


# ---------------------------------------------------------------------------
# the pairing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairing():
    return TCI.mnt6753_pairing("cpu")


@pytest.fixture(scope="module")
def anchor(pairing):
    pa, qb, gt = mnt6753_anchor()
    return dict(p=pairing.g1.affine_from_ints(*pa),
                q=pairing.g2.affine_from_ints(*qb), pa=pa, qb=qb, gt=gt)


def test_prepare_g2_matches_jax(pairing, anchor):
    """Every line coefficient of the host ladder over Fq3, digit for digit,
    against the JAX package's ``MNTPairing.prepare_g2`` at full length."""
    got = pairing.prepare_g2(anchor["q"])
    want = JCI.mnt6753_pairing().prepare_g2(tuple(map(as_jax, anchor["q"])))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], jax_digits(want[k])), k
    assert got["dbl_gx"].shape == (len(pairing.wnaf), 3,
                                   TP.MNT6753_FQ.n_digits)


def test_host_oracle_matches_anchor_and_jax(anchor):
    mine, theirs = TPH.host_mnt6753_pairing(), JPH.host_mnt6753_pairing()
    f = mine.miller_loop(anchor["pa"], anchor["qb"])
    assert f == theirs.miller_loop(anchor["pa"], anchor["qb"])
    assert mine.final_exponentiation(f) == anchor["gt"]
    g = rand_below(P, 6, seed=9)
    assert mine.final_exponentiation(g) == theirs.final_exponentiation(g)


SHORT_WNAF = list(CG.MNT6753["wnaf"][-12:])     # LSB first: the top digits
SHORT_W0 = 0xB5A7


def short_pairings(pairing):
    """The device pairing, the python-int oracle and the JAX package's
    pairing over the top 12 WNAF digits and a 16-bit hard part."""
    short = MNTPairing("mnt6753_short", pairing.g1, pairing.g2, pairing.fqk,
                       SHORT_WNAF, pairing.ate_is_neg, pairing.w1, SHORT_W0,
                       pairing.w0_is_neg, 3, True)
    H = TPH.host_mnt6753_pairing()
    host = TPH.HostMNTPairing(H.p, H.S, H.F, H.g2_a, SHORT_WNAF,
                              H.ate_is_neg, H.w1, SHORT_W0, H.w0_is_neg, 3,
                              True)
    J = JCI.mnt6753_pairing()
    jax = JMNTPairing("mnt6753_short", J.g1, J.g2, J.fqk, SHORT_WNAF,
                      J.ate_is_neg, J.w1, SHORT_W0, J.w0_is_neg, 3, True)
    return short, host, jax


@pytest.mark.parametrize("point", ["P", "-P"])
def test_short_loops_match_host_oracle(pairing, anchor, point):
    """The prepared Miller loop (``mul_by_2345`` a step) over the top 12
    WNAF digits (doubling steps, +1 and -1 additions) and the final
    exponentiation (the q^3 - 1 easy part, its q + 1, a 16-bit hard part)
    against the python-int oracle built with the same arguments, at the
    anchor's G1 point and at its negation."""
    assert 1 in SHORT_WNAF and -1 in SHORT_WNAF
    short, host, _ = short_pairings(pairing)
    (px, py), pa = anchor["p"], anchor["pa"]
    if point == "-P":
        py = short.g1.F.neg(py)
        pa = (pa[0], [(-pa[1][0]) % P])
    f = short.miller_loop_prepared((px, py), short.prepare_g2(anchor["q"]))
    assert TT.ext_to_ints(short.fqk, f) == host.miller_loop(pa, anchor["qb"])
    got = short.final_exponentiation(f)
    assert TT.ext_to_ints(short.fqk, got) == host.pairing(pa, anchor["qb"])


@pytest.mark.slow
def test_short_loop_matches_jax(pairing, anchor):
    """The same 12-digit loop against the JAX package's
    ``miller_loop_prepared`` (a scan over ``mul_by_2345``), digit for
    digit."""
    short, _, jax = short_pairings(pairing)
    prep = short.prepare_g2(anchor["q"])
    f = short.miller_loop_prepared(anchor["p"], prep)
    jf = jax.miller_loop_prepared(
        tuple(map(as_jax, anchor["p"])),
        {k: as_jax(v) for k, v in prep.items()})
    assert torch.equal(f, jax_digits(jf))


def test_prepared_pairing_matches_anchor(pairing, anchor):
    got = pairing.pairing_prepared(anchor["p"],
                                   pairing.prepare_g2(anchor["q"]))
    assert TT.ext_to_ints(pairing.fqk, got) == anchor["gt"]


# ---------------------------------------------------------------------------
# Groth16 over MNT6-753
# ---------------------------------------------------------------------------

def test_radix2_domain_stops_at_the_two_adicity():
    """32,763 constraints and 5 inputs take the 2^15 domain; one constraint
    more needs 2^16 > 2^15 = the two-adicity of MNT6-753's Fr, and the
    circuit is refused, as the JAX package's ``Domain`` refuses it; GM17's
    ``best_domain`` takes the mixed radix there instead."""
    from gingerlib_tpu.ops.fft import Domain as JDomain
    from gingerlib_tpu_torch.ops.fft import Domain, best_domain
    fr = TP.MNT6753_FR
    assert fr.two_adicity == 15
    cs, _ = benchmark_circuit(fr, 4, (1 << 15) - 5)
    assert tr1cs.domain_size_for(cs) == 1 << 15
    cs, _ = benchmark_circuit(fr, 4, (1 << 15) - 4, with_values=False)
    with pytest.raises(ValueError, match="two-adicity"):
        tr1cs.domain_size_for(cs)
    with pytest.raises(ValueError):
        Domain(fr, (1 << 15) + 1, device="cpu")
    with pytest.raises(ValueError):
        JDomain(JP.MNT6753_FR, (1 << 15) + 1)
    assert best_domain(fr, (1 << 15) + 1, device="cpu").size == 40960


@pytest.mark.slow
def test_groth16_over_mnt6753_matches_host_oracle(pairing):
    """Setup, prove and verify on the CPU over MNT6-753 (G2 over Fq3,
    the MNT6 pairing in setup's GT and in verify): the proof equals the
    closed-form oracle, the GT element the python-int pairing, and a wrong
    input is refused."""
    cs = one_constraint_circuit(TP.MNT6753_FR)
    compiled = tr1cs.compile_r1cs(cs, device="cpu")
    params = tgroth16.generate_parameters(pairing, cs, **TOXIC, device="cpu")
    assert TT.ext_to_ints(pairing.fqk, params.vk.alpha_g1_beta_g2) == \
        host_alpha_beta(TOXIC["alpha"], TOXIC["beta"], "mnt6753")
    proof = tgroth16.create_proof(pairing, params, compiled, cs.assignment(),
                                  **RAND, device="cpu")
    assert tgroth16.proof_to_ints(pairing, proof) == thost.expected_proof(
        "mnt6753", cs, **TOXIC, **RAND)
    assert tgroth16.verify_proof(pairing, params.vk, proof, [77])
    assert not tgroth16.verify_proof(pairing, params.vk, proof, [78])


@pytest.fixture(scope="module")
def host_case():
    """The JAX package's host Groth16 over MNT6-753 on the 1-constraint
    circuit: parameters (with the vk's GT element) and a proof."""
    from gingerlib_tpu.proofs import groth16_host as jhost
    from test_torch_groth16 import jax_copy
    cs = one_constraint_circuit(TP.MNT6753_FR)
    H = jhost.host_groth16_mnt6753()
    jcs = jax_copy(cs, JP.MNT6753_FR)
    hp = H.setup(jcs, **TOXIC)
    return dict(cs=cs, hp=hp, proof=H.prove(jcs, hp, RAND["r"], RAND["s"]))


def test_params_carried_from_the_jax_host_form(pairing, host_case):
    """``params_from_numpy`` over MNT6-753: G2 points over Fq3 and the
    vk's GT element in Fq6 come across; the JAX host prover's proof is the
    port's closed-form oracle's."""
    from gingerlib_tpu_torch.utils.convert import params_from_numpy
    hp = host_case["hp"]
    params = params_from_numpy(pairing, hp, device="cpu")
    gt = params.vk.alpha_g1_beta_g2
    assert gt.shape == (6, TP.MNT6753_FQ.n_digits)
    assert TT.ext_to_ints(pairing.fqk, gt) == hp.vk["alpha_g1_beta_g2"] == \
        host_alpha_beta(TOXIC["alpha"], TOXIC["beta"], "mnt6753")
    xs, ys, inf = params.b_g2_query
    assert xs.shape[1:] == (3, TP.MNT6753_FQ.n_digits)
    assert [None if i else tgroth16.affine_to_ints(pairing.g2, (x, y))
            for x, y, i in zip(xs, ys, inf)] == hp.b_g2_query
    assert tgroth16.affine_to_ints(pairing.g2, params.vk.delta_g2) == \
        hp.vk["delta_g2"]
    assert host_case["proof"] == thost.expected_proof(
        "mnt6753", host_case["cs"], **TOXIC, **RAND)


@pytest.mark.slow
def test_verify_proof_of_the_host_prover(pairing, host_case):
    """The port verifies the JAX package's host proof over MNT6-753 with
    the verifying key carried across, and refuses another input."""
    from gingerlib_tpu_torch.utils.convert import params_from_numpy
    vk = params_from_numpy(pairing, host_case["hp"], device="cpu").vk
    pr = host_case["proof"]
    proof = tgroth16.Proof(a=pairing.g1.affine_from_ints(*pr["a"]),
                           b=pairing.g2.affine_from_ints(*pr["b"]),
                           c=pairing.g1.affine_from_ints(*pr["c"]))
    assert tgroth16.verify_proof(pairing, vk, proof, [77])
    assert not tgroth16.verify_proof(pairing, vk, proof, [78])
