"""Port vs JAX package: the BLS12 slice -- the Fq6 = Fq2[V]/(V^3 - xi) and
Fq12 = Fq6[W]/(W^2 - V) towers (gingerlib_tpu_torch.fields.towers), the
BLS12 pairing (curves.pairing_bls12) and its python-int oracle
(curves.pairing_host.HostBls12Pairing), and Groth16 over BLS12-381 -- on
``device="cpu"``, on BLS12-377 (D-twist, x > 0, xi = (0, 1)) and
BLS12-381 (M-twist, x < 0, xi = (1, 1)) alike, against the JAX package's
eager functions, its host oracles and the port's own python-int towers.
Integer arithmetic: tolerance 0, every digit must agree.

Fast tier (both curves; ~100 s in one process with
``test_torch_bls12_gadgets.py``): the Frobenius tables against the
reference's; the Fq12 product, the curve's own line shape (``mul_by_034``
of the D-twist, ``mul_by_014`` of the M-twist) and the Granger-Scott
square on four elements (zero and one among them) against the JAX
package; every method, the inverses, every
Frobenius power and the power by x against python ints; the port's host
pairing against the JAX package's; the CPU pairing against the host
oracle.  ``slow``: the other Fq6 and Fq12 methods against the JAX package
(each JAX method's first eager call costs ~5-35 s of XLA compiles here);
a one-constraint Groth16 over BLS12-381 (setup and prove ~45 s, ~10 s a
verify): setup's GT, the proof against the closed form, verify accepting
77 and refusing 78 and an altered C; and the Miller loop and the power
by x against the JAX package's (its device pairing compiles a scan a
power).  ``chip_smoke.py`` runs BLS12-381 Groth16 at 2^16 on the card.
"""

import functools

import numpy as np
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.curves import pairing_host as JPH
from gingerlib_tpu.fields import towers as JT
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.circuits import mul_circuit
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.curves import pairing_host as TPH
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.fields import host_ext as HE
from gingerlib_tpu_torch.fields import towers as TT
from gingerlib_tpu_torch.params._gen import curves_gen as CG
from gingerlib_tpu_torch.params._gen import towers_gen as TG
from gingerlib_tpu_torch.proofs import groth16 as tgroth16
from gingerlib_tpu_torch.proofs import groth16_host as thost
from gingerlib_tpu_torch.relations import r1cs as tr1cs
from test_torch_cases import host_alpha_beta, rand_below

torch.set_num_threads(1)
FAMILIES = ["bls12_377", "bls12_381"]


def jax_digits(a):
    """A JAX result as the port's int64 digits."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def as_jax(t):
    return t.numpy().astype(np.uint32)


def tower_constants(family):
    """(Fq parameters of the port, of the JAX package, nr2, xi)."""
    up = family.upper()
    return (getattr(TP, f"{up}_FQ"), getattr(JP, f"{up}_FQ"),
            getattr(TG, f"{up}_FQ2")["nonresidue"],
            getattr(TG, f"{up}_FQ6")["nonresidue"])


@functools.lru_cache()
def towers_of(family):
    """The port's (Fq2, Fq6, Fq12), the JAX package's, the host towers,
    and four Fq12 elements x (zero, one, two seeded) and y (the same,
    reversed)."""
    tf, jf, nr2, xi = tower_constants(family)
    _, t2, t6, t12 = TT.build_bls12_towers(tf, nr2, xi)
    _, j2, j6, j12 = JT.build_bls12_towers(jf, nr2, xi)
    _, h2, h6, h12 = HE.build_bls12_host_towers(tf.modulus, nr2, xi)
    vals = [[0] * 12, [1] + [0] * 11] + [rand_below(tf.modulus, 12, seed=s)
                                          for s in (1, 2)]
    x = torch.from_numpy(np.stack([t12.const(v) for v in vals]))
    return dict(family=family, p=tf.modulus, t2=t2, t6=t6, t12=t12, j2=j2,
                j6=j6, j12=j12, h2=h2, h6=h6, h12=h12, x=x, y=x.flip(0))


@pytest.fixture(scope="module", params=FAMILIES)
def towers(request):
    return towers_of(request.param)


@pytest.mark.parametrize("family", FAMILIES)
def test_frobenius_tables_match_the_reference(family):
    tf, _, nr2, xi = tower_constants(family)
    p, up = tf.modulus, family.upper()
    c1, c2 = HE.frob_table_fp6_3over2(p, nr2, xi)
    ref6 = getattr(TG, f"{up}_FQ6")
    assert HE.flatten(c1) == [v % p for v in ref6["frobenius_coeff_fp6_c1"]]
    assert HE.flatten(c2) == [v % p for v in ref6["frobenius_coeff_fp6_c2"]]
    assert HE.flatten(HE.frob_table_fp12(p, nr2, xi)) == [
        v % p for v in getattr(TG, f"{up}_FQ12")["frobenius_coeff_fp12_c1"]]


FQ6_OPS = {
    "mul": lambda F, x, y: F.mul(x, y),
    "sqr": lambda F, x, y: F.sqr(x),
    "frob1": lambda F, x, y: F.frob(x, 1),
    "frob2": lambda F, x, y: F.frob(x, 2),
    "frob3": lambda F, x, y: F.frob(x, 3),
    "mul_by_gen": lambda F, x, y: F.mul_by_gen(x),
    # x * (b0 + b1 V) and x * (b1 V), b0 and b1 Fq2 components of y
    "mul_by_01": lambda F, x, y: F.mul_by_01(x, y[..., :2, :],
                                             y[..., 2:4, :]),
    "mul_by_1": lambda F, x, y: F.mul_by_1(x, y[..., 2:4, :]),
}
FQ12_OPS = {
    "mul": lambda F, x, y: F.mul(x, y),
    "sqr": lambda F, x, y: F.sqr(x),
    "frob1": lambda F, x, y: F.frob(x, 1),
    "frob2": lambda F, x, y: F.frob(x, 2),
    "frob3": lambda F, x, y: F.frob(x, 3),
    "frob6": lambda F, x, y: F.frob(x, 6),
    "conjugate": lambda F, x, y: F.conjugate(x),
    # the lines: three Fq2 components of y at positions (0, 1, 4) of the
    # M-twist and (0, 3, 4) of the D-twist
    "mul_by_014": lambda F, x, y: F.mul_by_014(
        x, y[..., :2, :], y[..., 2:4, :], y[..., 8:10, :]),
    "mul_by_034": lambda F, x, y: F.mul_by_034(
        x, y[..., :2, :], y[..., 6:8, :], y[..., 8:10, :]),
}


# the Fq12 methods compared with the JAX package in the fast tier: the
# product (it holds Fq6's products) and each curve's own line shape; the
# rest are slow (each JAX method's first eager call compiles for seconds),
# and their python-int checks below are fast
FAST_JAX = {("bls12_377", "mul"), ("bls12_381", "mul"),
            ("bls12_377", "mul_by_034"), ("bls12_381", "mul_by_014")}
FQ12_JAX_CASES = [
    pytest.param(f, op, marks=() if (f, op) in FAST_JAX else
                 pytest.mark.slow) for f in FAMILIES for op in FQ12_OPS]


@pytest.mark.slow
@pytest.mark.parametrize("op", list(FQ6_OPS))
def test_fq6_matches_jax(towers, op):
    x, y = towers["x"][..., :6, :], towers["y"][..., 6:, :]
    got = FQ6_OPS[op](towers["t6"], x, y)
    assert torch.equal(got, jax_digits(FQ6_OPS[op](towers["j6"], as_jax(x),
                                                   as_jax(y))))


@pytest.mark.parametrize("family,op", FQ12_JAX_CASES)
def test_fq12_matches_jax(family, op):
    towers = towers_of(family)
    got = FQ12_OPS[op](towers["t12"], towers["x"], towers["y"])
    want = FQ12_OPS[op](towers["j12"], as_jax(towers["x"]),
                        as_jax(towers["y"]))
    assert torch.equal(got, jax_digits(want))


@pytest.mark.parametrize("op", list(FQ6_OPS))
def test_fq6_against_python_ints(towers, op):
    """Every Fq6 method against the host tower arithmetic: the sparse
    products as dense products by the sparse element, mul_by_gen as a
    product by V."""
    F, H = towers["t6"], towers["h6"]
    x, y = towers["x"][..., :6, :], towers["y"][..., 6:, :]
    xs = [TT.ext_to_ints(F, e) for e in x]
    ys = [TT.ext_to_ints(F, e) for e in y]
    sparse = {"mul_by_gen": lambda b: [0, 0, 1, 0, 0, 0],
              "mul_by_01": lambda b: b[:4] + [0, 0],
              "mul_by_1": lambda b: [0, 0] + b[2:4] + [0, 0]}
    want = {
        "mul": lambda a, b: HE.host_ext_mul(H, a, b),
        "sqr": lambda a, b: HE.host_ext_mul(H, a, a),
        **{f"frob{i}": (lambda i: lambda a, b: HE.host_ext_frob(H, a, i))(i)
           for i in (1, 2, 3)},
        **{k: (lambda k: lambda a, b: HE.host_ext_mul(H, a, sparse[k](b)))(k)
           for k in sparse}}[op]
    got = FQ6_OPS[op](F, x, y)
    assert [TT.ext_to_ints(F, g) for g in got] == [
        want(a, b) for a, b in zip(xs, ys)]


def test_lines_are_sparse_products(towers):
    """Each line shape equals the dense product by the line's Fq12
    element, on both towers (the D- and the M-twist's positions)."""
    F, x, y = towers["t12"], towers["x"], towers["y"]
    c = [y[..., 2 * k:2 * k + 2, :] for k in range(3)]
    for shape, pos in (("mul_by_014", (0, 1, 4)), ("mul_by_034", (0, 3, 4))):
        dense = torch.zeros_like(y).unflatten(-2, (6, 2))
        for k, ck in zip(pos, c):
            dense[..., k, :, :] = ck
        assert torch.equal(getattr(F, shape)(x, *c),
                           F.mul(x, dense.flatten(-3, -2))), shape


@pytest.mark.parametrize("degree", [6, 12])
def test_inverse_against_python_ints(towers, degree):
    F, H = towers[f"t{degree}"], towers[f"h{degree}"]
    x = towers["x"][1:, :degree, :]
    assert [TT.ext_to_ints(F, g) for g in F.inv(x)] == [
        HE.host_ext_inv(H, TT.ext_to_ints(F, a)) for a in x]
    assert torch.equal(F.inv(towers["x"][:1, :degree, :]),
                       towers["x"][:1, :degree, :])        # 0 -> 0


def host_pow(F, a, e):
    r = [1] + [0] * (F.K - 1)
    for bit in bin(e)[2:]:
        r = HE.host_ext_mul(F, r, r)
        if bit == "1":
            r = HE.host_ext_mul(F, r, a)
    return r


@pytest.mark.parametrize("degree", [6, 12])
def test_against_python_ints(towers, degree):
    """mul and every Frobenius power against the host tower arithmetic,
    and frob(x, 1) against x^p on the host."""
    F, H = towers[f"t{degree}"], towers[f"h{degree}"]
    x, y = towers["x"][..., :degree, :], towers["y"][..., :degree, :]
    xs = [TT.ext_to_ints(F, e) for e in x]
    ys = [TT.ext_to_ints(F, e) for e in y]
    for got, a, b in zip(F.mul(x, y), xs, ys):
        assert TT.ext_to_ints(F, got) == HE.host_ext_mul(H, a, b)
    for i in range(degree):
        for got, a in zip(F.frob(x, i), xs):
            assert TT.ext_to_ints(F, got) == HE.host_ext_frob(H, a, i), i
    assert HE.host_ext_frob(H, xs[2], 1) == host_pow(H, xs[2], towers["p"])


@pytest.fixture(scope="module")
def cyclotomic(towers):
    """x^((p^6 - 1)(p^2 + 1)) for four non-zero x: elements of the
    cyclotomic subgroup, where the Granger-Scott square holds."""
    F = towers["t12"]
    x = torch.cat([towers["x"][1:], torch.from_numpy(F.const(rand_below(
        towers["p"], 12, seed=3)))[None]])
    r = F.mul(F.conjugate(x), F.inv(x))
    return F.mul(F.frob(r, 2), r)


def test_cyclotomic_square(towers, cyclotomic):
    """Granger-Scott against the plain square and the JAX package's."""
    F = towers["t12"]
    got = F.cyclotomic_square(cyclotomic)
    assert torch.equal(got, F.sqr(cyclotomic))
    assert torch.equal(got, jax_digits(towers["j12"].cyclotomic_square(
        as_jax(cyclotomic))))


def test_fq12_sqr_conjugate_against_python_ints(towers):
    F, H, p = towers["t12"], towers["h12"], towers["p"]
    x = towers["x"]
    for got, a in zip(F.sqr(x), x):
        a = TT.ext_to_ints(F, a)
        assert TT.ext_to_ints(F, got) == HE.host_ext_mul(H, a, a)
    for got, a in zip(F.conjugate(x), x):
        a = TT.ext_to_ints(F, a)
        assert TT.ext_to_ints(F, got) == a[:6] + [(-v) % p for v in a[6:]]


def test_power_by_x_against_python_ints(towers, cyclotomic):
    """``ext_cyclotomic_pow_const`` by the curve's |x| (NAF digits,
    Granger-Scott squares, the conjugate for the negative digits)."""
    F, H = towers["t12"], towers["h12"]
    x = getattr(CG, towers["family"].upper())["x"]
    got = TT.ext_cyclotomic_pow_const(F, cyclotomic[2:], x)
    assert [TT.ext_to_ints(F, g) for g in got] == [
        host_pow(H, TT.ext_to_ints(F, a), x) for a in cyclotomic[2:]]


@pytest.mark.slow
def test_power_by_x_matches_jax(towers, cyclotomic):
    F = towers["t12"]
    x = getattr(CG, towers["family"].upper())["x"]
    got = TT.ext_cyclotomic_pow_const(F, cyclotomic[2:], x)
    want = JT.ext_cyclotomic_pow_const(towers["j12"],
                                       as_jax(cyclotomic[2:]), x)
    assert torch.equal(got, jax_digits(want))


def generators(family):
    c = getattr(CG, family.upper())
    return ([c["g1_x"]], [c["g1_y"]]), (list(c["g2_x"]), list(c["g2_y"]))


@pytest.mark.parametrize("family", FAMILIES)
def test_host_pairing_matches_jax(family):
    """The port's python-int oracle (on ``fields/host_ext`` towers) against
    the JAX package's (on its gadget towers): the Miller value and the
    pairing of the generators and of (2P, 3Q)."""
    T = getattr(TPH, f"host_{family}_pairing")()
    J = getattr(JPH, f"host_{family}_pairing")()
    g1, g2, _ = thost.host_curves(family)
    for P, Q in ((g1.gen, g2.gen), (g1.mul(g1.gen, 2), g2.mul(g2.gen, 3))):
        assert T.miller_loop(P, Q) == J.miller_loop(P, Q)
        assert T.pairing(P, Q) == J.pairing(P, Q)


@pytest.mark.parametrize("family", FAMILIES)
def test_host_pairing_is_bilinear(family):
    """e(2P, 3Q) = e(P, Q)^6, GT^r = 1 and GT != 1, in python ints."""
    H = getattr(TPH, f"host_{family}_pairing")()
    g1, g2, fr = thost.host_curves(family)
    gt = H.pairing(g1.gen, g2.gen)
    assert gt != H._fone() and H._fpow(gt, fr.modulus) == H._fone()
    assert H.pairing(g1.mul(g1.gen, 2), g2.mul(g2.gen, 3)) == \
        H._fpow(gt, 6)


@pytest.fixture(scope="module", params=FAMILIES)
def cpu_pairing(request):
    family = request.param
    E = getattr(TCI, f"{family}_pairing")("cpu")
    P, Q = E.g1.generator_affine, E.g2.generator_affine
    f = E.miller_loop(P, Q)
    return dict(family=family, E=E, P=P, Q=Q, f=f,
                gt=E.final_exponentiation(f))


def test_cpu_pairing_matches_host_oracle(cpu_pairing):
    """The device pairing on the CPU (plain kernels) against the host
    oracle: the Miller value and GT of the generators."""
    E = cpu_pairing["E"]
    H = getattr(TPH, f"host_{cpu_pairing['family']}_pairing")()
    P, Q = generators(cpu_pairing["family"])
    assert tfp.fp_to_ints(E.fp, cpu_pairing["f"]) == H.miller_loop(P, Q)
    assert tfp.fp_to_ints(E.fp, cpu_pairing["gt"]) == H.pairing(P, Q)


@pytest.mark.slow
def test_miller_loop_matches_jax(cpu_pairing):
    """The port's Miller loop against the JAX package's ``Bls12Pairing``
    on the same generators (its jitted loop compiles for minutes)."""
    from gingerlib_tpu.curves import instances as JCI
    J = getattr(JCI, f"{cpu_pairing['family']}_pairing")()
    P, Q = cpu_pairing["P"], cpu_pairing["Q"]
    want = J.miller_loop(tuple(as_jax(c) for c in P),
                         tuple(as_jax(c) for c in Q))
    assert torch.equal(cpu_pairing["f"], jax_digits(want))


# ---------------------------------------------------------------------------
# Groth16 over BLS12-381 on the CPU
# ---------------------------------------------------------------------------

TOXIC = dict(alpha=1234, beta=5678, gamma=9101, delta=1121, t=31415)
BLIND = dict(r=171717, s=282828)


@pytest.fixture(scope="module")
def groth16_381():
    """Setup and prove of 7 * 11 = 77 over BLS12-381 on the CPU."""
    eng = TCI.bls12_381_engine("cpu")
    cs = mul_circuit(TP.BLS12_381_FR, 7, 11)
    params = tgroth16.generate_parameters(eng, cs, **TOXIC, device="cpu")
    proof = tgroth16.create_proof(eng, params, tr1cs.compile_r1cs(
        cs, device="cpu"), cs.assignment(), **BLIND, device="cpu")
    return dict(eng=eng, cs=cs, params=params, proof=proof)


@pytest.mark.slow
def test_groth16_bls12_381_setup_and_proof(groth16_381):
    """The vk's GT element is e(alpha G1, beta G2) by the host oracle; the
    proof is the closed-form one."""
    eng, params = groth16_381["eng"], groth16_381["params"]
    assert tfp.fp_to_ints(eng.fp, params.vk.alpha_g1_beta_g2) == \
        host_alpha_beta(TOXIC["alpha"], TOXIC["beta"], "bls12_381")
    assert tgroth16.proof_to_ints(eng, groth16_381["proof"]) == \
        thost.expected_proof("bls12_381", groth16_381["cs"], **TOXIC,
                             **BLIND)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["77", "78", "altered C"])
def test_groth16_bls12_381_verify(groth16_381, case):
    """verify_proof accepts the statement 77 and refuses 78 and a C moved
    by G1's generator."""
    eng, proof = groth16_381["eng"], groth16_381["proof"]
    g1 = eng.g1
    if case == "altered C":
        proof = tgroth16.Proof(a=proof.a, b=proof.b, c=g1.to_affine(
            g1.add_mixed(g1.from_affine(*proof.c), g1.generator_affine)))
    inputs = [78] if case == "78" else [77]
    assert tgroth16.verify_proof(eng, groth16_381["params"].vk, proof,
                                 inputs) is (case == "77")
