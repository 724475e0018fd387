"""Port vs JAX package: byte serialization (gingerlib_tpu_torch.utils.serialize
against gingerlib_tpu.utils.serialize).  The same points, cast from numpy,
go through both writers; the bytes must be equal, and the port's readers
must give the points back.  Also: the hand-derived MNT4-753 layout of the
JAX package's own test, point and GT compression, and parameters written by
the JAX package and read by the port.
"""

import random
import struct
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.curves import instances as JCI
from gingerlib_tpu.fields import fp as jfp
from gingerlib_tpu.proofs import groth16 as jgroth16
from gingerlib_tpu.utils import serialize as JS
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.fields import host_ext
from gingerlib_tpu_torch.params._gen import curves_gen as CG
from gingerlib_tpu_torch.params._gen import towers_gen as TG
from gingerlib_tpu_torch.proofs import groth16 as tgroth16
from gingerlib_tpu_torch.proofs import groth16_host as thost
from gingerlib_tpu_torch.utils import serialize as TS
from gingerlib_tpu_torch.utils.convert import params_from_numpy
from test_torch_cases import (GOLDEN_MNT6298_PROOF, mnt4753_anchor,
                              mnt6298_golden_points, mnt6753_anchor)

torch.set_num_threads(1)
CPU = "cpu"


@pytest.fixture(scope="module")
def engines():
    """(what the JAX serializer reads of an MNT4-753 engine: its groups and
    Fq4, without building the JAX pairing; the port's engine on the
    CPU)."""
    jeng = NS(g1=JCI.mnt4753_g1(), g2=JCI.mnt4753_g2(),
              fqk=JCI.mnt4753_towers()[2])
    return jeng, TCI.mnt4753_engine(CPU)


def rand_elems(params, n, seed):
    """n seeded elements as Montgomery digits (numpy int64), 0 and p - 1
    first."""
    rng = random.Random(seed)
    vals = [0, params.modulus - 1] + [rng.randrange(params.modulus)
                                      for _ in range(n - 2)]
    return tfp.fp_from_ints(params, vals[:n])


def as_jax(a):
    return np.asarray(a).astype(np.uint32)


def host_points(name, ks):
    """[k]G in python ints for small k (few doublings)."""
    family, group = name.split("_g")
    H = thost.host_curves(family)[int(group) - 1]
    return [H.mul(H.gen, k) for k in ks]


def point_arrays(curve, pts):
    """Host points -> Montgomery (xs, ys) numpy [n, K, nd] and flags."""
    K, nd = curve.F.K, curve.fp.n_digits
    xs, ys = [], []
    for pt in pts:
        x, y = pt if pt is not None else ([0] * K, [0] * K)
        xs += x
        ys += y
    shape = (len(pts), K, nd)
    return (tfp.fp_from_ints(curve.fp, xs).reshape(shape),
            tfp.fp_from_ints(curve.fp, ys).reshape(shape),
            np.array([pt is None for pt in pts]))


@pytest.mark.parametrize("field", ["MNT4753_FQ", "MNT6753_FQ",
                                   "BLS12_377_FQ", "BLS12_377_FR",
                                   "SW6_FQ", "MNT6298_FQ"])
def test_fp_bytes_match_jax(field):
    jp, tp = getattr(JP, field), getattr(TP, field)
    d = rand_elems(tp, 8, seed=len(field))
    for row in d:
        raw = TS.fp_to_bytes(tp, torch.from_numpy(row))
        assert raw == JS.fp_to_bytes(jp, as_jax(row))
        assert len(raw) == 8 * -(-tp.modulus_bits // 64)
        back, off = TS.fp_from_bytes(tp, raw, device=CPU)
        assert off == len(raw) and torch.equal(back, torch.from_numpy(row))
    with pytest.raises(ValueError, match="range"):
        TS.fp_from_bytes(tp, tp.modulus.to_bytes(len(raw), "little"),
                         device=CPU)


@pytest.mark.parametrize("name", ["bls12_377_g1", "mnt4753_g1",
                                  "mnt4753_g2", "mnt6753_g1", "mnt6753_g2",
                                  "sw6_g1", "sw6_g2", "mnt6298_g1",
                                  "mnt6298_g2"])
def test_affine_bytes_match_jax(name):
    jc, tc = getattr(JCI, name)(), getattr(TCI, name)(CPU)
    xs, ys, _ = point_arrays(tc, host_points(name, [1, 2, 5]))
    for x, y in zip(xs, ys):
        raw = TS.affine_to_bytes(tc, (torch.from_numpy(x),
                                      torch.from_numpy(y)))
        assert raw == JS.affine_to_bytes(jc, (as_jax(x), as_jax(y)))
        assert len(raw) == 2 * tc.F.K * 8 * -(-tc.fp.modulus_bits // 64) + 1
        (bx, by, inf), off = TS.affine_from_bytes(tc, raw, device=CPU)
        assert not inf and off == len(raw)
        assert torch.equal(bx, torch.from_numpy(x)) \
            and torch.equal(by, torch.from_numpy(y))
    # the reference's affine zero: x = 0, y = 1, infinity = 1
    raw = TS.affine_to_bytes(tc, None, infinity=True)
    assert raw == JS.affine_to_bytes(jc, (None, None), infinity=True)
    (x, y, inf), _ = TS.affine_from_bytes(tc, raw, device=CPU)
    assert inf and not x.any()
    assert tfp.fp_to_ints(tc.fp, y) == [1] + [0] * (tc.F.K - 1)


def test_ext_bytes_match_jax(engines):
    jeng, teng = engines
    gt = tfp.fp_from_ints(teng.fp, mnt4753_anchor()[2]).reshape(4, 48)
    raw = TS.ext_to_bytes(teng.fqk, torch.from_numpy(gt))
    assert raw == JS.ext_to_bytes(jeng.fqk, as_jax(gt))
    back, off = TS.ext_from_bytes(teng.fqk, raw, device=CPU)
    assert off == 4 * 96 and torch.equal(back, torch.from_numpy(gt))


def synthetic_params(engine, seed):
    """A parameters object of valid points (small multiples of the
    generators; queries with points at infinity), as numpy arrays: not a
    real CRS, only what the byte format holds."""
    rng = random.Random(seed)

    def pts(name, n, with_inf=True):
        ks = [rng.randrange(1, 1 << 12) for _ in range(n)]
        if with_inf:
            ks[1] = 0
        return host_points(name, ks)

    def query(name, n):
        curve = engine.g1 if name.endswith("g1") else engine.g2
        return point_arrays(curve, pts(name, n))

    def single(name):
        curve = engine.g1 if name.endswith("g1") else engine.g2
        x, y, _ = point_arrays(curve, pts(name, 1, False))
        return (x[0], y[0])

    abc = query("mnt4753_g1", 3)
    gt = tfp.fp_from_ints(engine.fp, mnt4753_anchor()[2]).reshape(4, 48)
    vk = NS(alpha_g1_beta_g2=gt, gamma_g2=single("mnt4753_g2"),
            delta_g2=single("mnt4753_g2"),
            gamma_abc_g1=(abc[0][[0, 2]], abc[1][[0, 2]]))
    return NS(vk=vk, alpha_g1=single("mnt4753_g1"),
              beta_g1=single("mnt4753_g1"), beta_g2=single("mnt4753_g2"),
              delta_g1=single("mnt4753_g1"), delta_g2=single("mnt4753_g2"),
              a_query=query("mnt4753_g1", 5),
              b_g1_query=query("mnt4753_g1", 5),
              b_g2_query=query("mnt4753_g2", 5),
              h_query=query("mnt4753_g1", 7),
              l_query=query("mnt4753_g1", 3), num_inputs=2, domain_size=8)


def as_jax_tree(v):
    if isinstance(v, tuple):
        return tuple(as_jax_tree(c) for c in v)
    return v if v.dtype == np.bool_ else as_jax(v)


def to_jax_params(src):
    """The numpy parameters as the JAX package's dataclasses."""
    vk = jgroth16.VerifyingKey(
        alpha_g1_beta_g2=as_jax(src.vk.alpha_g1_beta_g2),
        gamma_g2=as_jax_tree(src.vk.gamma_g2),
        delta_g2=as_jax_tree(src.vk.delta_g2),
        gamma_abc_g1=as_jax_tree(src.vk.gamma_abc_g1))
    fields = {k: as_jax_tree(getattr(src, k)) for k in (
        "alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2", "a_query",
        "b_g1_query", "b_g2_query", "h_query", "l_query")}
    return jgroth16.Parameters(vk=vk, num_inputs=src.num_inputs,
                               domain_size=src.domain_size, **fields)


def assert_params_equal(got, want):
    for name in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
                 "a_query", "b_g1_query", "b_g2_query", "h_query",
                 "l_query"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            assert g.dtype == w.dtype and torch.equal(g, w), name
    for g, w in zip((got.vk.alpha_g1_beta_g2, *got.vk.gamma_g2,
                     *got.vk.delta_g2, *got.vk.gamma_abc_g1),
                    (want.vk.alpha_g1_beta_g2, *want.vk.gamma_g2,
                     *want.vk.delta_g2, *want.vk.gamma_abc_g1)):
        assert torch.equal(g, w)
    assert (got.num_inputs, got.domain_size) \
        == (want.num_inputs, want.domain_size)


@pytest.fixture(scope="module")
def params_case(engines):
    jeng, teng = engines
    src = synthetic_params(teng, seed=3)
    port = params_from_numpy(teng, src, device=CPU)
    return src, port, JS.params_to_bytes(jeng, to_jax_params(src))


def test_proof_bytes_match_jax(engines, params_case):
    jeng, teng = engines
    _, port, _ = params_case
    proof = tgroth16.Proof(a=port.alpha_g1, b=port.beta_g2, c=port.delta_g1)
    raw = TS.proof_to_bytes(teng, proof)
    assert raw == JS.proof_to_bytes(jeng, jgroth16.Proof(
        *(tuple(as_jax(c.numpy()) for c in pt)
          for pt in (proof.a, proof.b, proof.c))))
    back, off = TS.proof_from_bytes(teng, raw, device=CPU)
    assert off == len(raw)
    for g, w in zip((*back.a, *back.b, *back.c),
                    (*proof.a, *proof.b, *proof.c)):
        assert torch.equal(g, w)


def test_vk_bytes_match_jax(engines, params_case):
    jeng, teng = engines
    src, port, _ = params_case
    raw = TS.vk_to_bytes(teng, port.vk)
    assert raw == JS.vk_to_bytes(jeng, to_jax_params(src).vk)
    vk, off = TS.vk_from_bytes(teng, raw, device=CPU)
    assert off == len(raw) and TS.vk_to_bytes(teng, vk) == raw
    assert torch.equal(vk.gamma_abc_g1[0], port.vk.gamma_abc_g1[0])


def test_params_bytes_match_jax(engines, params_case):
    """Port writer == JAX writer; the port's reader gives back what
    ``params_from_numpy`` makes of the same source (points at infinity as
    (0, 0) with their flag)."""
    _, teng = engines
    src, port, jax_bytes = params_case
    assert TS.params_to_bytes(teng, port) == jax_bytes
    back, off = TS.params_from_bytes(teng, jax_bytes, device=CPU)
    assert off == len(jax_bytes)
    assert_params_equal(back, port)
    assert bool(back.a_query[2][1]) and not back.a_query[0][1].any()


def test_vk_of_an_engine_without_pairing_is_refused():
    eng = TCI.bls12_377_engine(CPU)
    vk = tgroth16.VerifyingKey(None, None, None, None)
    with pytest.raises(ValueError, match="alpha_g1_beta_g2"):
        TS.vk_to_bytes(eng, vk)


@pytest.mark.parametrize("name", ["mnt4753_g1", "bls12_377_g1"])
def test_point_compression_matches_jax(name):
    """Compress both packages alike; decompress to the same point, with
    infinity and the subgroup check (BLS12-377 G1 has a cofactor)."""
    jc = getattr(JCI, name)()
    tc = getattr(TCI, name)(CPU)
    c = CG.MNT4753 if name.startswith("mnt") else CG.BLS12_377
    fq = tc.fp
    a, b, r = c["a"] % fq.modulus, c["b"] % fq.modulus, tc.scalar_field.modulus
    for pt in host_points(name, [1, 2, 3, 77]):
        host = (pt[0][0], pt[1][0])
        bits = TS.point_compress(fq, host)
        assert bits == JS.point_compress(jc.fp, host)
        assert TS.point_decompress(fq, a, b, r, bits) == host \
            == JS.point_decompress(jc.fp, a, b, r, bits)
    inf_bits = TS.point_compress(fq, None, infinity=True)
    assert inf_bits == JS.point_compress(jc.fp, None, infinity=True)
    assert TS.point_decompress(fq, a, b, r, inf_bits) is None
    # an x whose y^2 is not a square, and (BLS12-377) a curve point outside
    # the prime-order subgroup
    p = fq.modulus
    x = 1
    while TS._sqrt_mod((x ** 3 + a * x + b) % p, p) is not None:
        x += 1
    with pytest.raises(ValueError, match="not on curve"):
        TS.point_decompress(fq, a, b, r, TS.point_compress(fq, (x, 0)))
    if c["cofactor"] != 1:
        x = 1
        while TS._sqrt_mod((x ** 3 + a * x + b) % p, p) is None:
            x += 1
        bits = TS.point_compress(fq, (x, 0))
        with pytest.raises(ValueError, match="prime order"):
            TS.point_decompress(fq, a, b, r, bits)


def unitary(F, seed):
    """conj(x) / x for a seeded x of Fq4 (x^(p^2 - 1)), Fq6 (x^(p^3 - 1))
    or Fq12 (x^(p^6 - 1)): norm 1 over the subfield, the form of a GT
    element."""
    rng = random.Random(seed)
    k = F.sf.K
    x = [rng.randrange(F.p) for _ in range(2 * k)]
    conj = x[:k] + [(-v) % F.p for v in x[k:]]
    return host_ext.host_ext_mul(F, conj, host_ext.host_ext_inv(F, x))


def test_gt_compression_matches_jax():
    """The anchor's GT and seeded unitary elements: the port's bits equal
    the JAX package's, and decompression gives the element back, both
    parities of c0 among them; a c1 without a square root is refused."""
    from gingerlib_tpu.curves.pairing_host import host_mnt4753_pairing
    JF = host_mnt4753_pairing().F
    p = TP.MNT4753_FQ.modulus
    F = host_ext.build_mnt4_host_towers(
        p, TG.MNT4753_FQ2["nonresidue"])[2]
    parities = set()
    for g in [mnt4753_anchor()[2]] + [unitary(F, s) for s in range(3)]:
        bits = TS.gt_compress(F, g)
        assert bits == JS.gt_compress(JF, g)
        assert len(bits) == 2 * TP.MNT4753_FQ.modulus_bits + 1
        assert TS.gt_decompress(F, bits) == g
        parities.add(bits[-1])
    assert parities == {True, False}
    c1 = 1
    while True:
        try:
            TS.gt_decompress(F, TS._write_bits(c1, 753) * 2 + [False])
        except ValueError:
            break
        c1 += 1


def test_gt_compression_over_fq6_matches_jax():
    """MNT6-753's GT (Fq6 = Fq3[Y]/(Y^2 - X)): c1's three components and
    the parity of c0 by the highest non-zero Fq3 component, as the JAX
    package writes them; the anchor's GT and seeded unitary elements
    decompress to themselves."""
    from gingerlib_tpu.curves.pairing_host import host_mnt6753_pairing
    JF = host_mnt6753_pairing().F
    p = TP.MNT6753_FQ.modulus
    F = host_ext.build_mnt6_host_towers(
        p, TG.MNT6753_FQ3["nonresidue"])[2]
    parities = set()
    for g in [mnt6753_anchor()[2]] + [unitary(F, s) for s in range(4)]:
        bits = TS.gt_compress(F, g)
        assert bits == JS.gt_compress(JF, g)
        assert len(bits) == 3 * TP.MNT6753_FQ.modulus_bits + 1
        assert TS.gt_decompress(F, bits) == g
        parities.add(bits[-1])
    assert parities == {True, False}


def test_mnt6753_proof_and_vk_bytes_match_jax():
    """A proof and a verifying key over MNT6-753 (G2 over Fq3, the GT
    element in Fq6) as the JAX package writes them, and back."""
    jeng = NS(g1=JCI.mnt6753_g1(), g2=JCI.mnt6753_g2(),
              fqk=JCI.mnt6753_towers()[2])
    teng = TCI.mnt6753_engine(CPU)
    g1s = point_arrays(teng.g1, host_points("mnt6753_g1", [3, 5, 7, 9]))
    g2s = point_arrays(teng.g2, host_points("mnt6753_g2", [4, 6, 8]))
    t = lambda a: torch.from_numpy(a)                      # noqa: E731
    proof = tgroth16.Proof(a=(t(g1s[0][0]), t(g1s[1][0])),
                           b=(t(g2s[0][0]), t(g2s[1][0])),
                           c=(t(g1s[0][1]), t(g1s[1][1])))
    raw = TS.proof_to_bytes(teng, proof)
    assert raw == JS.proof_to_bytes(jeng, jgroth16.Proof(
        *(tuple(as_jax(c.numpy()) for c in pt)
          for pt in (proof.a, proof.b, proof.c))))
    assert len(raw) == (2 * 96 + 1) * 2 + 6 * 96 + 1
    back, off = TS.proof_from_bytes(teng, raw, device=CPU)
    assert off == len(raw) and all(torch.equal(g, w) for g, w in zip(
        (*back.a, *back.b, *back.c), (*proof.a, *proof.b, *proof.c)))
    gt = tfp.fp_from_ints(teng.fp, mnt6753_anchor()[2]).reshape(6, 48)
    vk = tgroth16.VerifyingKey(
        alpha_g1_beta_g2=t(gt), gamma_g2=(t(g2s[0][1]), t(g2s[1][1])),
        delta_g2=(t(g2s[0][2]), t(g2s[1][2])),
        gamma_abc_g1=(t(g1s[0][2:]), t(g1s[1][2:])))
    raw = TS.vk_to_bytes(teng, vk)
    assert raw == JS.vk_to_bytes(jeng, jgroth16.VerifyingKey(
        alpha_g1_beta_g2=as_jax(gt),
        gamma_g2=tuple(as_jax(c.numpy()) for c in vk.gamma_g2),
        delta_g2=tuple(as_jax(c.numpy()) for c in vk.delta_g2),
        gamma_abc_g1=tuple(as_jax(c.numpy()) for c in vk.gamma_abc_g1)))
    back, off = TS.vk_from_bytes(teng, raw, device=CPU)
    assert off == len(raw) and TS.vk_to_bytes(teng, back) == raw
    assert torch.equal(back.alpha_g1_beta_g2, vk.alpha_g1_beta_g2)


def test_mnt6298_golden_proof_bytes():
    """The hand-derived bytes of A = [2]G1, B = G2, C = G1 over MNT6-298
    (19 digits, 40-byte elements; the JAX package's golden vector), written
    from the points byte for byte, and read back to the same points."""
    teng = TCI.mnt6298_engine(CPU)
    a, b, c = mnt6298_golden_points()
    g1 = point_arrays(teng.g1, [a, c])
    g2 = point_arrays(teng.g2, [b])
    t = lambda x: torch.from_numpy(x)                      # noqa: E731
    proof = tgroth16.Proof(a=(t(g1[0][0]), t(g1[1][0])),
                           b=(t(g2[0][0]), t(g2[1][0])),
                           c=(t(g1[0][1]), t(g1[1][1])))
    raw = TS.proof_to_bytes(teng, proof)
    assert raw == bytes.fromhex(GOLDEN_MNT6298_PROOF)
    assert len(raw) == (2 * 40 + 1) * 2 + 6 * 40 + 1
    back, off = TS.proof_from_bytes(teng, raw, device=CPU)
    assert off == len(raw) and all(torch.equal(g, w) for g, w in zip(
        (*back.a, *back.b, *back.c), (*proof.a, *proof.b, *proof.c)))


@pytest.mark.parametrize("family", ["bls12_377", "bls12_381"])
def test_gt_compression_over_fq12_matches_jax(family):
    """BLS12's GT (Fq12 = Fq6[W]/(W^2 - V), Fq6 = Fq2[V]/(V^3 - xi)): c1's
    six components and the parity of c0 by its highest non-zero Fq2 part,
    as the JAX package writes them, for e(G1, G2) and seeded unitary
    elements, each also with c0 negated (unitary too, the other parity);
    each decompresses to itself."""
    from gingerlib_tpu.curves import pairing_host as JPH
    from gingerlib_tpu_torch.curves import pairing_host as TPH
    up = family.upper()
    fq = getattr(TP, f"{up}_FQ")
    JF = getattr(JPH, f"host_{family}_pairing")().F
    F = host_ext.build_bls12_host_towers(
        fq.modulus, getattr(TG, f"{up}_FQ2")["nonresidue"],
        getattr(TG, f"{up}_FQ6")["nonresidue"])[3]
    H = getattr(TPH, f"host_{family}_pairing")()
    g1, g2, _ = thost.host_curves(family)
    parities = set()
    for u in [H.pairing(g1.gen, g2.gen), unitary(F, 0)]:
        for g in (u, [(-v) % fq.modulus for v in u[:6]] + u[6:]):
            bits = TS.gt_compress(F, g)
            assert bits == JS.gt_compress(JF, g)
            assert len(bits) == 6 * fq.modulus_bits + 1
            assert TS.gt_decompress(F, bits) == g
            parities.add(bits[-1])
    assert parities == {True, False}


def test_bls12_377_vk_bytes_match_jax():
    """A verifying key over BLS12-377 (G2 over Fq2, the GT element in
    Fq12) as the JAX package writes it, and back."""
    from gingerlib_tpu_torch.curves import pairing_host as TPH
    jeng = NS(g1=JCI.bls12_377_g1(), g2=JCI.bls12_377_g2(),
              fqk=JCI.bls12_377_towers()[3])
    teng = TCI.bls12_377_engine(CPU)
    g1s = point_arrays(teng.g1, host_points("bls12_377_g1", [3, 5, 7]))
    g2s = point_arrays(teng.g2, host_points("bls12_377_g2", [4, 6]))
    t = lambda a: torch.from_numpy(a)                      # noqa: E731
    g1, g2, _ = thost.host_curves("bls12_377")
    gt = tfp.fp_from_ints(teng.fp, TPH.host_bls12_377_pairing().pairing(
        g1.gen, g2.gen)).reshape(12, teng.fp.n_digits)
    vk = tgroth16.VerifyingKey(
        alpha_g1_beta_g2=t(gt), gamma_g2=(t(g2s[0][0]), t(g2s[1][0])),
        delta_g2=(t(g2s[0][1]), t(g2s[1][1])),
        gamma_abc_g1=(t(g1s[0]), t(g1s[1])))
    raw = TS.vk_to_bytes(teng, vk)
    assert raw == JS.vk_to_bytes(jeng, jgroth16.VerifyingKey(
        alpha_g1_beta_g2=as_jax(gt),
        gamma_g2=tuple(as_jax(c.numpy()) for c in vk.gamma_g2),
        delta_g2=tuple(as_jax(c.numpy()) for c in vk.delta_g2),
        gamma_abc_g1=tuple(as_jax(c.numpy()) for c in vk.gamma_abc_g1)))
    back, off = TS.vk_from_bytes(teng, raw, device=CPU)
    assert off == len(raw) and TS.vk_to_bytes(teng, back) == raw
    assert torch.equal(back.alpha_g1_beta_g2, vk.alpha_g1_beta_g2)


def test_proof_and_vk_bytes_match_hand_derived_reference_layout(engines):
    """The hand-derived MNT4-753 layout (tests/test_serialize.py): Fp = 96
    little-endian standard-form bytes, affine = x || y || infinity byte,
    vk = alpha_g1_beta_g2 || gamma_g2 || delta_g2 || BE-u32 count ||
    points."""
    _, eng = engines
    c = CG.MNT4753
    p = eng.fp.modulus

    def le(v):
        return int(v).to_bytes(96, "little")

    g1b = le(c["g1_x"]) + le(c["g1_y"]) + b"\x00"
    g2b = (b"".join(le(v) for v in c["g2_x"]) +
           b"".join(le(v) for v in c["g2_y"]) + b"\x00")
    g1gen, g2gen = eng.g1.generator_affine, eng.g2.generator_affine
    proof = tgroth16.Proof(a=g1gen, b=g2gen, c=g1gen)
    assert TS.proof_to_bytes(eng, proof) == g1b + g2b + g1b
    gt_host = mnt4753_anchor()[2]
    vk = tgroth16.VerifyingKey(
        alpha_g1_beta_g2=torch.from_numpy(
            tfp.fp_from_ints(eng.fp, gt_host).reshape(4, 48)),
        gamma_g2=g2gen, delta_g2=g2gen,
        gamma_abc_g1=(torch.stack([g1gen[0], g1gen[0]]),
                      torch.stack([g1gen[1], g1gen[1]])))
    exp = (b"".join(le(v % p) for v in gt_host) + g2b + g2b +
           struct.pack(">I", 2) + g1b + g1b)
    assert TS.vk_to_bytes(eng, vk) == exp
    vk2, off = TS.vk_from_bytes(eng, exp, device=CPU)
    assert off == len(exp) and TS.vk_to_bytes(eng, vk2) == exp


def jax_host_params(hp, eng):
    """The JAX package's host-form parameters (python ints) as its array
    form, converted by the JAX package's own ``fp_from_ints``."""
    def pts(curve, lst):
        K = curve.F.K
        xs, ys = [], []
        for pt in lst:
            x, y = pt if pt is not None else ([0] * K, [0] * K)
            xs += x
            ys += y
        shape = (len(lst), K, curve.fp.n_digits)
        return (np.asarray(jfp.fp_from_ints(curve.fp, xs)).reshape(shape),
                np.asarray(jfp.fp_from_ints(curve.fp, ys)).reshape(shape),
                np.array([pt is None for pt in lst]))

    def single(curve, pt):
        x, y, _ = pts(curve, [pt])
        return (x[0], y[0])

    g1, g2 = eng.g1, eng.g2
    abc = pts(g1, hp.vk["gamma_abc"])
    vk = jgroth16.VerifyingKey(
        alpha_g1_beta_g2=np.asarray(jfp.fp_from_ints(
            eng.g1.fp, hp.vk["alpha_g1_beta_g2"])).reshape(4, -1),
        gamma_g2=single(g2, hp.vk["gamma_g2"]),
        delta_g2=single(g2, hp.vk["delta_g2"]),
        gamma_abc_g1=abc[:2])
    return jgroth16.Parameters(
        vk=vk, alpha_g1=single(g1, hp.alpha_g1),
        beta_g1=single(g1, hp.beta_g1), beta_g2=single(g2, hp.beta_g2),
        delta_g1=single(g1, hp.delta_g1), delta_g2=single(g2, hp.delta_g2),
        a_query=pts(g1, hp.a_query), b_g1_query=pts(g1, hp.b_g1_query),
        b_g2_query=pts(g2, hp.b_g2_query), h_query=pts(g1, hp.h_query),
        l_query=pts(g1, hp.l_query), num_inputs=hp.num_inputs,
        domain_size=hp.domain_size)


@pytest.mark.slow
def test_params_written_by_jax_prove_the_oracle_proof_at_2p6(engines):
    """The JAX package sets up the benchmark circuit at 2^6 constraints on
    the CPU (its host setup, ~1 min), writes the parameters with its
    ``params_to_bytes``; the port reads them, gets what
    ``params_from_numpy`` makes of the same source, and proves the
    oracle's proof (the 768-step loops on the CPU: minutes)."""
    from gingerlib_tpu.proofs import groth16_host as jhost
    from gingerlib_tpu_torch.circuits import benchmark_circuit
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
    from test_torch_groth16 import RAND, TOXIC, jax_copy
    jeng, teng = engines
    cs, _ = benchmark_circuit(TP.MNT4753_FR, 4, 1 << 6)
    hp = jhost.host_groth16_mnt4753().setup(jax_copy(cs, JP.MNT4753_FR),
                                            **TOXIC)
    raw = JS.params_to_bytes(jeng, jax_host_params(hp, jeng))
    params, off = TS.params_from_bytes(teng, raw, device=CPU)
    assert off == len(raw)
    assert_params_equal(params, params_from_numpy(teng, hp, device=CPU))
    proof = tgroth16.create_proof(teng, params, compile_r1cs(cs, device=CPU),
                                  cs.assignment(), **RAND, device=CPU)
    assert tgroth16.proof_to_ints(teng, proof) \
        == thost.expected_proof("mnt4753", cs, **TOXIC, **RAND)
