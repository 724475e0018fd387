"""Port vs JAX package: the MNT4-753 pairing slice -- the Fq4 tower
(gingerlib_tpu_torch.fields.towers), the pairing (curves.pairing_mnt), its
python-int oracle (curves.pairing_host) and Groth16 ``verify_proof`` -- on
``device="cpu"``, against the JAX package's eager functions, its host
oracles and the reference's pinned anchor.  Integer arithmetic: tolerance
0, every digit must agree.

Fast tier: the Fq4 methods on four elements (zero and one among them), the
power chains at 16-bit exponents, ``prepare_g2`` at full length, the host
oracles, the Miller loop and the final exponentiation over a short loop
(``test_torch_cases.SHORT_LOOP``), the full pairing against the anchor, and
the verifying key carried across from the JAX package's host and array
forms.  ``slow``: ``verify_proof`` (~25 s a call, most of it the 768-step
input accumulation).
"""

import numpy as np
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.curves import instances as JCI
from gingerlib_tpu.curves import pairing_host as JPH
from gingerlib_tpu.fields import towers as JT
from gingerlib_tpu.proofs import groth16_host as jhost
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.curves import pairing_host as TPH
from gingerlib_tpu_torch.fields import host_ext as HE
from gingerlib_tpu_torch.fields import towers as TT
from gingerlib_tpu_torch.ops import limbs
from gingerlib_tpu_torch.proofs import groth16 as tgroth16
from gingerlib_tpu_torch.utils.convert import params_from_numpy
from test_torch_cases import (SHORT_LOOP, mnt4753_anchor,
                              one_constraint_circuit, rand_below,
                              short_pairings)
from test_torch_groth16 import RAND, TOXIC, jax_copy

torch.set_num_threads(1)
P = TP.MNT4753_FQ.modulus


def jax_digits(a):
    """A JAX result as the port's int64 digits."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def fq4():
    """The port's Fq4 and the JAX package's, and four elements x (zero,
    one, two seeded) and y (the same, reversed), as tensors and arrays."""
    t4 = TT.build_mnt4_towers(TP.MNT4753_FQ, 13)[2]
    j4 = JT.build_mnt4_towers(JP.MNT4753_FQ, 13)[2]
    vals = [[0] * 4, [1, 0, 0, 0]] + [rand_below(P, 4, seed=s)
                                      for s in (1, 2)]
    x = torch.from_numpy(np.stack([t4.const(v) for v in vals]))
    y = x.flip(0)
    return dict(t4=t4, j4=j4, x=x, y=y, jx=x.numpy().astype(np.uint32),
                jy=y.numpy().astype(np.uint32))


@pytest.fixture(scope="module")
def unitary(fq4):
    """frob(x, 2) / x for four non-zero x (the JAX side then meets the
    shapes it has compiled for): unitary elements of Fq4."""
    t4 = fq4["t4"]
    x = torch.cat([fq4["x"][1:], torch.from_numpy(
        t4.const(rand_below(P, 4, seed=3)))[None]])
    return t4.mul(t4.frob(x, 2), t4.inv(x))


FQ4_OPS = {
    "mul": lambda F, x, y: F.mul(x, y),
    "sqr": lambda F, x, y: F.sqr(x),
    "inv": lambda F, x, y: F.inv(x),
    "conjugate": lambda F, x, y: F.conjugate(x),
    "frob0": lambda F, x, y: F.frob(x, 0),
    "frob1": lambda F, x, y: F.frob(x, 1),
    "frob2": lambda F, x, y: F.frob(x, 2),
    "frob3": lambda F, x, y: F.frob(x, 3),
    "mul_by_gen": lambda F, x, y: F.mul_by_gen(x),
    # the sparse line x * ([a, 0] + c1*Y): a from y's third component, c1
    # y's first half
    "mul_by_023": lambda F, x, y: F.mul_by_023(x, y[..., 2, :],
                                               y[..., :2, :]),
    "mul_by_sub": lambda F, x, y: F.mul_by_sub(x, y[..., 2:, :]),
}


@pytest.mark.parametrize("op", list(FQ4_OPS))
def test_fq4_matches_jax(fq4, op):
    got = FQ4_OPS[op](fq4["t4"], fq4["x"], fq4["y"])
    want = FQ4_OPS[op](fq4["j4"], fq4["jx"], fq4["jy"])
    assert torch.equal(got, jax_digits(want))


def test_fq4_against_python_ints(fq4):
    """mul, inv and frob against the host tower arithmetic."""
    t4 = fq4["t4"]
    _, _, h4 = HE.build_mnt4_host_towers(P, 13)
    xs = [TT.ext_to_ints(t4, e) for e in fq4["x"]]
    ys = [TT.ext_to_ints(t4, e) for e in fq4["y"]]
    for got, a, b in zip(t4.mul(fq4["x"], fq4["y"]), xs, ys):
        assert TT.ext_to_ints(t4, got) == HE.host_ext_mul(h4, a, b)
    for got, a in zip(t4.inv(fq4["x"][1:]), xs[1:]):
        assert TT.ext_to_ints(t4, got) == HE.host_ext_inv(h4, a)
    for i in range(4):
        for got, a in zip(t4.frob(fq4["x"], i), xs):
            assert TT.ext_to_ints(t4, got) == HE.host_ext_frob(h4, a, i)


def test_cyclotomic_square_on_unitary_elements(fq4, unitary):
    t4 = fq4["t4"]
    got = t4.cyclotomic_square(unitary)
    assert torch.equal(got, t4.sqr(unitary))
    want = fq4["j4"].cyclotomic_square(unitary.numpy().astype(np.uint32))
    assert torch.equal(got, jax_digits(want))


def host_pow(F, a, e):
    r = [1] + [0] * (F.K - 1)
    for bit in bin(e)[2:]:
        r = HE.host_ext_mul(F, r, r)
        if bit == "1":
            r = HE.host_ext_mul(F, r, a)
    return r


# JAX compiles a scan for each exponent, so one of them goes through it
JAX_EXPONENT = 0xB5A7


@pytest.mark.parametrize("e", [1, JAX_EXPONENT, 0xFFFF])
def test_cyclotomic_pow_const(fq4, unitary, e):
    t4 = fq4["t4"]
    got = TT.ext_cyclotomic_pow_const(t4, unitary, e)
    if e == JAX_EXPONENT:
        want = JT.ext_cyclotomic_pow_const(
            fq4["j4"], unitary.numpy().astype(np.uint32), e)
        assert torch.equal(got, jax_digits(want))
    _, _, h4 = HE.build_mnt4_host_towers(P, 13)
    assert [TT.ext_to_ints(t4, g) for g in got] == [
        host_pow(h4, TT.ext_to_ints(t4, u), e) for u in unitary]


@pytest.mark.parametrize("e", [0, 1, JAX_EXPONENT])
def test_pow_const(fq4, e):
    """Fq4 against JAX and python ints; Fq2 against ``quad_pow``."""
    t4 = fq4["t4"]
    bits = limbs.bits_msb_first(e, 16)
    got = TT.ext_pow_const(t4, fq4["x"], bits)
    if e == JAX_EXPONENT:
        want = JT.ext_pow_const(fq4["j4"], fq4["jx"], bits)
        assert torch.equal(got, jax_digits(want))
    _, _, h4 = HE.build_mnt4_host_towers(P, 13)
    assert [TT.ext_to_ints(t4, g) for g in got] == [
        host_pow(h4, TT.ext_to_ints(t4, a), e) for a in fq4["x"]]
    t2 = t4.sf
    x2 = fq4["x"][..., :2, :]
    got2 = TT.ext_pow_const(t2, x2, bits)
    assert [TT.ext_to_ints(t2, g) for g in got2] == [
        list(HE.quad_pow(P, 13, tuple(TT.ext_to_ints(t2, a)), e))
        for a in x2]


@pytest.mark.parametrize("e", [1, 2, 3, 0xB5A7, (1 << 377) - 12345])
def test_wnaf_digits_match_jax(e):
    digs = TT._wnaf_digits_msb(e)
    assert digs == JT._wnaf_digits_msb(e)
    assert sum(d << i for i, d in enumerate(reversed(digs))) == e


# ---------------------------------------------------------------------------
# the pairing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairing():
    return TCI.mnt4753_pairing("cpu")


@pytest.fixture(scope="module")
def anchor(pairing):
    """The anchor's points as device tensors, and its host form."""
    pa, qb, gt = mnt4753_anchor()
    return dict(p=pairing.g1.affine_from_ints(*pa),
                q=pairing.g2.affine_from_ints(*qb), pa=pa, qb=qb, gt=gt)


def test_prepare_g2_matches_jax(pairing, anchor):
    """Every line coefficient of the host ladder, digit for digit, against
    the JAX package's ``MNTPairing.prepare_g2`` at full length."""
    got = pairing.prepare_g2(anchor["q"])
    want = JCI.mnt4753_pairing().prepare_g2(
        tuple(c.numpy().astype(np.uint32) for c in anchor["q"]))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], jax_digits(want[k])), k
    steps = len(pairing.wnaf)
    assert got["dbl_gx"].shape == (steps, 2, TP.MNT4753_FQ.n_digits)
    assert steps == 376 and sum(1 for n in pairing.wnaf if n) == 123


def test_host_oracle_matches_anchor(anchor):
    E = TPH.host_mnt4753_pairing()
    assert E.pairing(anchor["pa"], anchor["qb"]) == anchor["gt"]


def test_host_oracle_matches_jax_host_oracle(anchor):
    """The Miller loop value (before the final exponentiation, where the
    two could differ by a factor that it kills) and the final
    exponentiation of a non-unitary element."""
    mine, theirs = TPH.host_mnt4753_pairing(), JPH.host_mnt4753_pairing()
    f = mine.miller_loop(anchor["pa"], anchor["qb"])
    assert f == theirs.miller_loop(anchor["pa"], anchor["qb"])
    g = rand_below(P, 4, seed=9)
    assert mine.final_exponentiation(g) == theirs.final_exponentiation(g)


@pytest.mark.parametrize("point", ["P", "-P"])
def test_short_loops_match_host_oracle(pairing, anchor, point):
    """The Miller loop and the final exponentiation over the top 12 WNAF
    digits (doubling steps, +1 and -1 additions, the ate sign) and a 16-bit
    hard part, against the oracle built with the same arguments, at the
    anchor's G1 point and at its negation."""
    short, host = short_pairings(pairing)
    (px, py), pa = anchor["p"], anchor["pa"]
    if point == "-P":
        py = short.g1.F.neg(py)
        pa = (pa[0], [(-pa[1][0]) % P])
    f = short.miller_loop_prepared((px, py), short.prepare_g2(anchor["q"]))
    assert TT.ext_to_ints(short.fqk, f) == host.miller_loop(pa, anchor["qb"])
    got = short.final_exponentiation(f)
    assert TT.ext_to_ints(short.fqk, got) == host.pairing(pa, anchor["qb"])


def test_short_product_of_pairings_cancels(pairing, anchor):
    """e(P, Q) * e(-P, Q) == 1 through the batched path: one loop over the
    batch of two, the product, one final exponentiation."""
    short, _ = short_pairings(pairing)
    g1 = short.g1
    px, py = anchor["p"]
    pts = (torch.stack([px, px]), torch.stack([py, g1.F.neg(py)]))
    prep = short.prepare_g2(anchor["q"])
    one = torch.from_numpy(short.gt_one())
    assert torch.equal(short.product_of_pairings_prepared(pts, [prep, prep]),
                       one)


def test_prepared_pairing_matches_anchor(pairing, anchor):
    got = pairing.pairing_prepared(anchor["p"],
                                   pairing.prepare_g2(anchor["q"]))
    assert TT.ext_to_ints(pairing.fqk, got) == anchor["gt"]


# ---------------------------------------------------------------------------
# the verifying key carried across, and verify_proof
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_case(pairing):
    """The JAX package's host Groth16 on the 1-constraint circuit: full
    parameters and a proof, both python ints."""
    cs = one_constraint_circuit(TP.MNT4753_FR)
    H = jhost.host_groth16_mnt4753()
    jcs = jax_copy(cs, JP.MNT4753_FR)
    hp = H.setup(jcs, **TOXIC)
    return dict(hp=hp, proof=H.prove(jcs, hp, RAND["r"], RAND["s"]),
                vk_only=H.setup_vk(jcs, **TOXIC))


def jax_array_vk(host_vk):
    """The JAX package's array-form ``VerifyingKey`` of a host-form vk: its
    points and GT element made by the JAX package's constructors, then
    written to bytes and read back by its serializer."""
    from gingerlib_tpu.proofs import groth16 as jgroth16
    from gingerlib_tpu.utils import serialize as JS
    jeng = JCI.mnt4753_pairing()
    abc = [jeng.g1.affine_from_ints(*pt) for pt in host_vk["gamma_abc"]]
    vk = jgroth16.VerifyingKey(
        alpha_g1_beta_g2=jeng.fqk.const(host_vk["alpha_g1_beta_g2"]),
        gamma_g2=jeng.g2.affine_from_ints(*host_vk["gamma_g2"]),
        delta_g2=jeng.g2.affine_from_ints(*host_vk["delta_g2"]),
        gamma_abc_g1=tuple(np.stack([np.asarray(pt[i]) for pt in abc])
                           for i in (0, 1)))
    return JS.vk_from_bytes(jeng, JS.vk_to_bytes(jeng, vk))[0]


def test_vk_carried_from_host_and_array_forms(pairing, host_case):
    """Both source forms bring alpha_g1_beta_g2 across: four ints from
    ``HostParams`` (full and verify-only), and the JAX package's array-form
    vk (jnp uint32 digits [4, 48]); all give the host oracle's GT."""
    from types import SimpleNamespace as NS
    hp = host_case["hp"]
    gt = hp.vk["alpha_g1_beta_g2"]
    want = torch.from_numpy(pairing.fqk.const(gt))
    host = params_from_numpy(pairing, hp, device="cpu")
    assert torch.equal(host.vk.alpha_g1_beta_g2, want)
    assert TT.ext_to_ints(pairing.fqk, host.vk.alpha_g1_beta_g2) == gt
    assert host_case["vk_only"].vk["alpha_g1_beta_g2"] == gt

    def arr(t):
        a = t.numpy()
        return a if a.dtype == np.bool_ else a.astype(np.uint32)

    fields = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
              "a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")
    jvk = jax_array_vk(hp.vk)
    assert np.asarray(jvk.alpha_g1_beta_g2).dtype == np.uint32
    src = NS(vk=jvk, num_inputs=host.num_inputs,
             domain_size=host.domain_size,
             **{f: tuple(map(arr, getattr(host, f))) for f in fields})
    carried = params_from_numpy(pairing, src, device="cpu")
    assert carried.vk.alpha_g1_beta_g2.dtype == torch.int64
    assert torch.equal(carried.vk.alpha_g1_beta_g2, want)
    for name in ("gamma_g2", "delta_g2", "gamma_abc_g1"):
        for c, h in zip(getattr(carried.vk, name), getattr(host.vk, name)):
            assert torch.equal(c, h), name


def host_proof(pairing, proof):
    return tgroth16.Proof(a=pairing.g1.affine_from_ints(*proof["a"]),
                          b=pairing.g2.affine_from_ints(*proof["b"]),
                          c=pairing.g1.affine_from_ints(*proof["c"]))


@pytest.mark.slow
@pytest.mark.parametrize("case", ["accepts", "wrong_input", "altered_c"])
def test_verify_proof_of_the_host_prover(pairing, host_case, case):
    """The port verifies the JAX package's host proof with the verifying
    key carried across, and refuses it with another public input or with
    C + G1's generator (still a curve point)."""
    vk = params_from_numpy(pairing, host_case["hp"], device="cpu").vk
    proof = host_proof(pairing, host_case["proof"])
    inputs = [77]
    if case == "wrong_input":
        inputs = [78]
    elif case == "altered_c":
        g1 = pairing.g1
        c = g1.to_affine(g1.add_mixed(g1.from_affine(*proof.c),
                                      g1.generator_affine))
        proof = tgroth16.Proof(a=proof.a, b=proof.b, c=c)
    assert tgroth16.verify_proof(pairing, vk, proof, inputs) \
        is (case == "accepts")


@pytest.mark.parametrize("fault", ["input_count", "no_gt"])
def test_verify_rejects_a_malformed_key(pairing, host_case, fault):
    """A key for another number of inputs, or one without its GT element
    (as an engine without a pairing leaves it), is refused before any
    pairing runs."""
    vk = params_from_numpy(pairing, host_case["hp"], device="cpu").vk
    proof = host_proof(pairing, host_case["proof"])
    inputs = [77]
    if fault == "input_count":
        inputs, match = [77, 1], "malformed"
    else:
        vk.alpha_g1_beta_g2, match = None, "no alpha_g1_beta_g2"
    with pytest.raises(ValueError, match=match):
        tgroth16.verify_proof(pairing, vk, proof, inputs)
