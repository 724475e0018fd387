"""Port vs JAX package: the Pedersen CRH, commitment and compressor and the
Bowe-Hopwood hash (``gingerlib_tpu_torch/primitives/{pedersen,commitment,
group_hash_host}.py``) and their gadgets, on ``device="cpu"``.  Tolerance
0.

Both packages hash with one set of generators: the windows' generators
and chains are made in python ints (the TE gadget's ``_host_add`` /
``_host_double``), laid out as the JAX objects' parameters, and carried
over to the port by ``utils/convert`` (``pedersen_crh_from_numpy`` ...).
The JAX classes run on Jubjub with their curve's add and double through
one jit (``torch_jax_te.JaxLanes``), at the window of the JAX package's
own test, 4 x 8 (``tests/test_pedersen_gadget.py:24``).

Fast tier: evaluate, commit and the compressor against the JAX objects,
digit for digit, and against the python-int sums; the port's seeded setup
against the host oracle; the Pedersen and Bowe-Hopwood gadgets' constraint
systems against the JAX gadgets'; and the JAX package's padding fault in
its device Bowe-Hopwood hash (``BoweHopwoodCRH.evaluate_bits`` pads the
input to the whole window, and each padded chunk adds 1 * base_i): the
port, like the host hash, sums the input's chunks only.  ``slow``: the JAX
package's own seeded setup (its ``mul_const`` compiles a scan a bit
length) against the port's.
"""

import random
from types import SimpleNamespace as NS

import numpy as np
import pytest

from gingerlib_tpu import params as JP
from gingerlib_tpu.curves import instances as JCI
from gingerlib_tpu.gadgets.crypto import bowe_hopwood as jbh
from gingerlib_tpu.gadgets.crypto import pedersen as jped
from gingerlib_tpu.gadgets.std import boolean as jbool
from gingerlib_tpu.gadgets.std import ext_fields as jef
from gingerlib_tpu.gadgets.std import groups as jgroups
from gingerlib_tpu.gadgets.std import te_groups as jte
from gingerlib_tpu.primitives import commitment as jcomm
from gingerlib_tpu.primitives import group_hash_host as jgh
from gingerlib_tpu.primitives import pedersen as jpedp
from gingerlib_tpu.relations import r1cs as jr1cs
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.curves import instances as TCI
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.gadgets.crypto import bowe_hopwood as tbh
from gingerlib_tpu_torch.gadgets.crypto import pedersen as tped
from gingerlib_tpu_torch.gadgets.std import boolean as tbool
from gingerlib_tpu_torch.gadgets.std import ext_fields as tef
from gingerlib_tpu_torch.gadgets.std import groups as tgroups
from gingerlib_tpu_torch.gadgets.std import te_groups as tte
from gingerlib_tpu_torch.params._gen import curves_gen as CG
from gingerlib_tpu_torch.primitives import commitment as tcomm
from gingerlib_tpu_torch.primitives import group_hash_host as tgh
from gingerlib_tpu_torch.primitives import pedersen as tpedp
from gingerlib_tpu_torch.relations import r1cs as tr1cs
from gingerlib_tpu_torch.utils import convert

from torch_jax_te import (JaxLanes, affine_of, host_chain, host_mul,
                          jax_points)

WS, NW = 4, 8          # tests/test_pedersen_gadget.py:24: 32 bits
MESSAGES = [b"abcd", b"", b"\xff\x00\xff"]


def port_te():
    return TCI.jubjub("cpu")


def bits_of(data: bytes):
    return [(b >> i) & 1 for b in data for i in range(8)]


def host_pedersen(gg, gens, bits, ws):
    """sum_w [m_w] g_w, m_w the integer of window w's bits (LSB first)."""
    acc = (0, 1)
    for w, g in enumerate(gens):
        m = sum(b << i for i, b in enumerate(bits[w * ws:(w + 1) * ws]))
        acc = gg._host_add(acc, host_mul(gg, g, m))
    return acc


@pytest.fixture(scope="module")
def shared():
    """The JAX objects with host-made generators, the port's carried over,
    the python-int gadget helper."""
    te = port_te()
    gg = tte.TEGroupGadget.for_curve(te)
    rng = random.Random(42)
    r = te.scalar_field.modulus
    gens = [host_mul(gg, te.generator_host, rng.randrange(1, r))
            for _ in range(NW + 1)]
    chains = [host_chain(gg, g, WS, 1) for g in gens[:NW]]
    nbits = te.scalar_field.modulus_bits
    curve = JaxLanes("jubjub")
    jcrh = jpedp.PedersenCRH(curve, jpedp.PedersenWindow(WS, NW))
    jcrh.params = jax_points(JP.JUBJUB_FQ, [p for c in chains for p in c])
    jcrh.generators_host = gens[:NW]
    jc = jcomm.PedersenCommitment(curve, jpedp.PedersenWindow(WS, NW))
    jc.crh = jcrh
    jc.rand_powers = jax_points(JP.JUBJUB_FQ,
                                host_chain(gg, gens[NW], nbits, 1))
    jc.rand_base_host = gens[NW]
    return NS(te=te, gg=gg, gens=gens, jcrh=jcrh, jc=jc,
              crh=convert.pedersen_crh_from_numpy(te, jcrh),
              comm=convert.pedersen_commitment_from_numpy(te, jc))


def assert_same_point(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("msg", MESSAGES)
def test_crh_and_compressor_match_jax(shared, msg):
    s = shared
    want = s.jcrh.evaluate(msg)
    got = s.crh.evaluate(msg)
    assert_same_point(got, want)
    xy = affine_of(s.te.fp, tuple(c[None] for c in got))[0]
    assert xy == host_pedersen(s.gg, s.gens[:NW], bits_of(msg), WS)
    comp = tcomm.PedersenCRHCompressor(s.te, s.crh.w)
    comp.crh = s.crh
    x = comp.evaluate(msg)
    assert tfp.fp_to_int(s.te.fp, x[0]) == xy[0]


def check_commit(s, msg, rnd):
    got = s.comm.commit(msg, rnd)
    assert_same_point(got, s.jc.commit(msg, rnd))
    want = s.gg._host_add(host_pedersen(s.gg, s.gens[:NW], bits_of(msg), WS),
                          host_mul(s.gg, s.gens[NW], rnd))
    assert affine_of(s.te.fp, tuple(c[None] for c in got)) == [want]


def test_commit_matches_jax(shared):
    check_commit(shared, b"m!", 123456789)
    with pytest.raises(ValueError):
        shared.comm.commit(b"m!", 1 << 252)
    with pytest.raises(ValueError):
        shared.crh.evaluate(b"12345")


@pytest.mark.slow
@pytest.mark.parametrize("msg,rnd", [(b"abcd", 0), (b"", (1 << 252) - 1)])
def test_commit_edges_match_jax(shared, msg, rnd):
    check_commit(shared, msg, rnd)


def test_setup_matches_host():
    """The port's seeded commitment setup: the windows' generators and the
    randomness generator drawn in the JAX package's order, their chains,
    against python ints."""
    te = port_te()
    gg = tte.TEGroupGadget.for_curve(te)
    comm = tcomm.PedersenCommitment(te, tpedp.PedersenWindow(WS, NW)).setup(
        random.Random(7))
    rng = random.Random(7)
    r = te.scalar_field.modulus
    gens = [host_mul(gg, te.generator_host, rng.randrange(1, r))
            for _ in range(NW + 1)]
    assert comm.crh.generators_host == gens[:NW]
    assert comm.rand_base_host == gens[NW]
    assert affine_of(te.fp, comm.crh.params) == \
        [p for g in gens[:NW] for p in host_chain(gg, g, WS, 1)]
    rand = affine_of(te.fp, comm.rand_powers)
    assert len(rand) == te.scalar_field.modulus_bits
    assert rand[:3] + rand[-1:] == [gens[NW], gg._host_double(gens[NW]),
                                    host_mul(gg, gens[NW], 4),
                                    host_mul(gg, gens[NW], 1 << 251)]


def systems_equal(jcs, tcs):
    assert (tcs.num_constraints, tcs.num_inputs, tcs.num_aux) == \
        (jcs.num_constraints, jcs.num_inputs, jcs.num_aux)
    assert tcs.names == jcs.names
    assert (tcs.at, tcs.bt, tcs.ct) == (jcs.at, jcs.bt, jcs.ct)
    assert tcs.assignment() == jcs.assignment()
    assert tcs.which_is_unsatisfied() is None


@pytest.mark.parametrize("kind", ["crh", "commitment", "compressor"])
def test_pedersen_gadgets_match_jax(shared, kind):
    s = shared
    msg, rnd = b"zy!", 987654321
    want_crh = host_pedersen(s.gg, s.gens[:NW], bits_of(msg), WS)
    out = {}
    for name, G, B, R, field in (
            ("jax", jped, jbool.Boolean, jr1cs, JP.JUBJUB_FQ),
            ("port", tped, tbool.Boolean, tr1cs, s.te.fp)):
        gg = (jte if name == "jax" else tte).TEGroupGadget(
            s.te.a_host, s.te.d_host, s.te.fp.modulus)
        cs = R.ConstraintSystem(field)
        bits = G.bytes_to_bit_gadgets(cs, msg)
        window = jpedp.PedersenWindow(WS, NW)
        if kind == "crh":
            pt = G.PedersenCRHGadget(gg, window, s.gens[:NW]) \
                .check_evaluation(cs, bits)
            value = pt.value()
        elif kind == "compressor":
            value = G.PedersenCRHCompressorGadget(gg, window, s.gens[:NW]) \
                .check_evaluation(cs, bits).value
        else:
            rbits = [B.alloc(cs, bool((rnd >> i) & 1), f"r{i}")
                     for i in range(s.te.scalar_field.modulus_bits)]
            value = G.PedersenCommitmentGadget(
                gg, window, s.gens[:NW], s.gens[NW]).check_commitment(
                    cs, bits, rbits).value()
        out[name] = (cs, value)
    systems_equal(out["jax"][0], out["port"][0])
    want = {"crh": want_crh, "compressor": want_crh[0],
            "commitment": s.gg._host_add(want_crh,
                                         host_mul(s.gg, s.gens[NW], rnd))}
    assert out["port"][1] == want[kind]


def mnt6_hosts():
    """The port's and the JAX package's host group hash over MNT6-753 G1,
    2 windows of 2 chunks, with one seeded setup."""
    th = tgh.mnt6753_g1_group_hash(2, 2).setup(random.Random(3))
    jh = jgh.mnt6753_g1_group_hash(2, 2)
    jh.generators = th.generators
    return th, jh


def test_bowe_hopwood_gadget_matches_jax():
    th, jh = mnt6_hosts()
    c = CG.MNT6753
    out = {}
    for name, G, GR, EF, B, R, PPm, host in (
            ("jax", jbh, jgroups, jef, jbool.Boolean, jr1cs, JP, jh),
            ("port", tbh, tgroups, tef, tbool.Boolean, tr1cs, TP, th)):
        group = GR.SWGroupGadget(EF.FpGOps(PPm.MNT6753_FQ), [c["a"]],
                                 [c["b"]])
        cs = R.ConstraintSystem(PPm.MNT6753_FQ)
        bits = [B.alloc(cs, bool(v), f"b{i}")
                for i, v in enumerate([1, 0, 1, 1, 1, 0, 0, 1])]
        pt = G.BoweHopwoodGadget(group, host).check_evaluation(cs, bits)
        out[name] = (cs, ([w.value for w in pt.x], [w.value for w in pt.y]))
    systems_equal(out["jax"][0], out["port"][0])
    assert out["port"][1] == th.evaluate_bits([1, 0, 1, 1, 1, 0, 0, 1])


def mnt6_port_hash(th):
    """The port's hash over MNT6-753 G1 with the host hash's generators,
    carried over from the JAX layout."""
    g = TCI.mnt6753_g1("cpu")
    pts = [p for row in th.generators for p in row]
    src = NS(w=tpedp.PedersenWindow(th.window_size, th.num_windows),
             params=jax_points(JP.MNT6753_FQ,
                               [(x[0], y[0]) for x, y in pts]))
    return g, convert.bowe_hopwood_from_numpy(g, src)


def test_bowe_hopwood_sums_only_the_inputs_chunks():
    """The JAX package's device Bowe-Hopwood hash pads its input to the
    whole window, each padded chunk adding 1 * base_i; the host hash, the
    gadget and the Rust reference sum the input's chunks only.  The port
    is on the reference's side: on MNT6-753 G1 it equals the host hash on
    a short input and on a full one; on Jubjub, where the JAX class runs
    (its fault is in the padding, not the curve), it differs from the JAX
    class on the short input and equals it, digit for digit, on the full
    one."""
    th, _ = mnt6_hosts()
    g, bh = mnt6_port_hash(th)
    for bits in ([1, 1, 0, 1], [1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1, 0]):
        x, y = g.to_affine(bh.evaluate_bits(bits))
        assert (tfp.fp_to_int(g.fp, x[0]), tfp.fp_to_int(g.fp, y[0])) == \
            tuple(v[0] for v in th.evaluate_bits(bits))
    # Jubjub: the JAX device class against the port on one set of bases
    te = port_te()
    gg = tte.TEGroupGadget.for_curve(te)
    rng = random.Random(9)
    bases = [host_mul(gg, te.generator_host,
                      rng.randrange(1, te.scalar_field.modulus))
             for _ in range(2)]
    rows = [p for b in bases for p in host_chain(gg, b, 2, 4)]
    jb = jpedp.BoweHopwoodCRH(JaxLanes("jubjub"), jpedp.PedersenWindow(2, 2))
    jb.params = jax_points(JP.JUBJUB_FQ, rows)
    tb = convert.bowe_hopwood_from_numpy(te, jb)

    def host_bh(bits):
        acc = (0, 1)
        for i in range(0, len(bits), 3):
            b0, b1, b2 = bits[i:i + 3]
            pt = host_mul(gg, rows[i // 3], 1 + b0 + 2 * b1)
            acc = gg._host_add(acc, ((-pt[0]) % gg.p, pt[1]) if b2 else pt)
        return acc

    short = [1, 1, 0, 1, 0, 1]
    full = short + [0, 0, 1, 1, 1, 1]
    got_short = tb.evaluate_bits(short)
    assert affine_of(te.fp, tuple(c[None] for c in got_short)) == \
        [host_bh(short)]
    jax_short = affine_of(te.fp, tuple(np.asarray(c)[None]
                                       for c in jb.evaluate_bits(short)))
    assert jax_short != [host_bh(short)]
    padded = host_bh(short + [0] * 6)   # what the JAX class computes
    assert jax_short == [padded]
    assert_same_point(tb.evaluate_bits(full), jb.evaluate_bits(full))
    assert affine_of(te.fp, tuple(c[None] for c in tb.evaluate_bits(full))) \
        == [host_bh(full)]


@pytest.mark.slow
def test_jax_setup_carries_over():
    """The JAX package's own seeded setup (Pedersen commitment on Jubjub)
    and the port's give the same generators; carried over, the JAX
    parameters commit as the JAX object does."""
    window = jpedp.PedersenWindow(WS, NW)
    jc = jcomm.PedersenCommitment(JCI.jubjub(), window).setup(
        random.Random(11))
    te = port_te()
    tc = tcomm.PedersenCommitment(te, tpedp.PedersenWindow(WS, NW)).setup(
        random.Random(11))
    assert [tuple(g) for g in jc.crh.generators_host] == \
        tc.crh.generators_host
    assert tuple(jc.rand_base_host) == tc.rand_base_host
    carried = convert.pedersen_commitment_from_numpy(te, jc)
    assert_same_point(carried.commit(b"ab", 77), jc.commit(b"ab", 77))
    assert affine_of(te.fp, carried.crh.params) == \
        affine_of(te.fp, tc.crh.params)
