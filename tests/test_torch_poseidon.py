"""Port: batched Poseidon (gingerlib_tpu_torch.primitives.poseidon and the
plain permutation of ops/poseidon_kernels) on ``device="cpu"``.

A full-round permutation on the plain CPU path costs some 65 binary-Euclid
inversions (about 100 s), so the quick run holds the port at a reduced round
count with the real constants (``test_torch_cases.reduced_poseidon``: a
full, a partial and the last round) for MNT4-753 and MNT6-753: the
permutation of special states, ``evaluate`` at L = 1, 2, 3 (a remainder
chunk at 1 and 3), a batch against a single sponge, and zero S-box lanes,
against the python-int oracle and against the digits the JAX package's
``PoseidonHash`` returned for the same inputs (``JAX_POSEIDON``; the JAX
Poseidon takes minutes here, so a ``slow`` test holds the JAX functions to
those recorded digits).  Under ``slow`` as well: the full-round
AFTER_ZERO_PERM anchors of both parameter sets and the phantom Merkle root,
on the port's plain path.  Integer arithmetic: tolerance 0.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.fields import fp as jfp
from gingerlib_tpu.primitives import poseidon as jpos
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops import limbs as tlimbs
from gingerlib_tpu_torch.ops import poseidon_kernels as PK
from gingerlib_tpu_torch.primitives.poseidon import (PoseidonHash,
                                                     PoseidonParams)
from gingerlib_tpu_torch.primitives.poseidon_host import PoseidonHost
from gingerlib_tpu_torch.utils import convert
from test_torch_cases import (JAX_POSEIDON, poseidon_rows, poseidon_states,
                              reduced_poseidon)

torch.set_num_threads(1)
NAMES = ["mnt4753", "mnt6753"]
FIELD = {"mnt4753": "MNT4753_FR", "mnt6753": "MNT6753_FR"}
# (parameter set, input length) of the evaluate cases
EVALUATE = [("mnt4753", 1), ("mnt4753", 2), ("mnt4753", 3), ("mnt6753", 2)]


def port_params(d, name, device="cpu"):
    return PoseidonParams(getattr(TP, FIELD[name]), d["t"], d["r_f"],
                          d["r_p"], d["rate"], d["c2"], d["round_cst"],
                          d["mds"], d["after_zero_perm"], device=device)


def jax_params(d, name):
    return jpos.PoseidonParams(getattr(JP, FIELD[name]), d["t"], d["r_f"],
                               d["r_p"], d["rate"], d["c2"], d["round_cst"],
                               d["mds"], d["after_zero_perm"])


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    name = request.param
    d = reduced_poseidon(name)
    P = port_params(d, name)
    return dict(name=name, d=d, P=P, h=PoseidonHash(P, device="cpu"),
                host=PoseidonHost(d, P.field.modulus))


def spelled(x):
    """Rows of Montgomery digits -> the integers they spell."""
    return tlimbs.from_digits_batch(x)


def test_permute_matches_oracle_and_jax(case):
    F = case["P"].field
    states = poseidon_states(case["name"])
    x = torch.from_numpy(tfp.fp_from_ints(F, sum(states, []))).reshape(
        len(states), 3, -1)
    got = case["h"].permute(x)
    ints = tfp.fp_to_ints(F, got.reshape(-1, F.n_digits))
    assert ints == sum((case["host"].permute(s) for s in states), [])
    assert spelled(got) == JAX_POSEIDON[case["name"], "permute"]


@pytest.fixture(scope="module")
def evaluated():
    """evaluate of the two seeded rows at each (parameter set, length)."""
    out = {}
    for name, length in EVALUATE:
        d = reduced_poseidon(name)
        h = PoseidonHash(port_params(d, name), device="cpu")
        rows = poseidon_rows(name, length)
        x = torch.from_numpy(np.stack([tfp.fp_from_ints(h.F, r)
                                       for r in rows]))
        out[name, length] = (h, d, rows, h.evaluate(x))
    return out


@pytest.mark.parametrize("name,length", EVALUATE)
def test_evaluate_matches_oracle_and_jax(evaluated, name, length):
    h, d, rows, got = evaluated[name, length]
    host = PoseidonHost(d, h.F.modulus)
    assert tfp.fp_to_ints(h.F, got) == [host.evaluate(r) for r in rows]
    assert spelled(got) == JAX_POSEIDON[name, f"evaluate_{length}"]


def test_batch_matches_single(evaluated):
    """One sponge alone gives the digits it got inside the batch."""
    h, _, rows, got = evaluated["mnt4753", 2]
    assert h.evaluate_ints([rows[1]]) == tfp.fp_to_ints(h.F, got[1:])


def test_zero_sbox_lanes(case):
    """A full round's S-box maps zeros to zero and inverts the rest with
    one shared inversion."""
    F = case["P"].field
    st = torch.from_numpy(tfp.fp_from_ints(F, [0, 5, 0, 7, 11, 0])).reshape(
        2, 3, -1)
    out = tfp.fp_to_ints(F, PK._sbox_full(F, st).reshape(-1, F.n_digits))
    p = F.modulus
    assert out == [0, pow(5, -1, p), 0, pow(7, -1, p), pow(11, -1, p), 0]


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_params_from_numpy_are_the_ports(name, reduced):
    """The JAX package's parameter arrays carried across equal the port's
    own parameters, tensor for tensor."""
    if reduced:
        d = reduced_poseidon(name)
        src, want = jax_params(d, name), port_params(d, name)
    else:
        src = getattr(jpos.PoseidonParams, name)()
        want = getattr(PoseidonParams, name)("cpu")
    got = convert.poseidon_params_from_numpy(src, device="cpu")
    assert (got.field, got.t, got.r_f, got.r_p, got.rate) == \
        (want.field, want.t, want.r_f, want.r_p, want.rate)
    for attr in ("c2", "rc", "mds", "after_zero_perm"):
        assert torch.equal(getattr(got, attr), getattr(want, attr)), attr
    nd = got.field.n_digits
    rc = np.concatenate([np.asarray(getattr(src, attr)).reshape(-1, 3, nd)
                         for attr in ("rc_full1", "rc_partial", "rc_full2",
                                      "rc_last")])
    assert np.array_equal(rc.astype(np.int64), got.rc.numpy())


def test_full_parameter_sets_are_the_reference_schedule():
    P4, P6 = PoseidonParams.mnt4753("cpu"), PoseidonParams.mnt6753("cpu")
    assert (P4.r_f, P4.r_p, P4.n_rounds, tuple(P4.rc.shape)) == \
        (4, 57, 65, (65, 3, 48))
    assert (P6.r_f, P6.r_p, P6.n_rounds, tuple(P6.rc.shape)) == \
        (2, 60, 64, (64, 3, 48))
    assert P4.field is TP.MNT4753_FR and P6.field is TP.MNT6753_FR


@pytest.mark.parametrize("fault", ["cpu_state", "wrong_width",
                                   "hash_on_another_device",
                                   "tree_on_another_device",
                                   "short_constants"])
def test_refusals(case, fault):
    """The kernel wrapper takes only CUDA states of [B, 3, nd]; a hash and
    its parameters must be on the requested device; a schedule needs its
    round constants."""
    P, d = case["P"], case["d"]
    x = torch.zeros((2, 3, P.field.n_digits), dtype=torch.int64)
    with pytest.raises(ValueError):
        if fault == "cpu_state":
            PK.permute_cuda(P, x)
        elif fault == "wrong_width":
            PK.permute_cuda(P, x[..., :24])
        elif fault == "hash_on_another_device":
            PoseidonHash(P, device="meta")
        elif fault == "tree_on_another_device":
            from gingerlib_tpu_torch.primitives.merkle import \
                FieldBasedMerkleTree
            FieldBasedMerkleTree(case["h"], 4, device="meta")
        else:
            port_params(dict(d, r_p=2), case["name"])


# ---------------------------------------------------------------------------
# slow: the JAX Poseidon on the same inputs; full-round anchors
# ---------------------------------------------------------------------------

def jax_outputs(name):
    """{key: spelled digits} of the JAX PoseidonHash on the cases above."""
    d = reduced_poseidon(name)
    jh = jpos.PoseidonHash(jax_params(d, name))
    JF = jh.F
    states = poseidon_states(name)
    x = jnp.asarray(np.stack([jfp.fp_from_ints(JF, s) for s in states]))
    out = {(name, "permute"): spelled(np.asarray(jax.jit(jh.permute)(x)))}
    for n, length in EVALUATE:
        if n != name:
            continue
        rows = jnp.asarray(np.stack([jfp.fp_from_ints(JF, r)
                                     for r in poseidon_rows(name, length)]))
        out[name, f"evaluate_{length}"] = spelled(
            np.asarray(jax.jit(jh.evaluate)(rows)))
    return out


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_jax_gives_the_recorded_digits(name):
    got = jax_outputs(name)
    assert got == {k: v for k, v in JAX_POSEIDON.items() if k[0] == name}


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_after_zero_perm_full_rounds(name):
    P = getattr(PoseidonParams, name)("cpu")
    zero = torch.zeros((1, 3, P.field.n_digits), dtype=torch.int64)
    assert torch.equal(PoseidonHash(P, device="cpu").permute(zero)[0],
                       P.after_zero_perm)


@pytest.mark.slow
def test_phantom_merkle_root():
    from gingerlib_tpu_torch.params._gen.merkle_gen import \
        MNT4753_PHANTOM_MERKLE_ROOT
    magic = (b"This represents an empty Merkle Root for a "
             b"MNT4753PoseidonHash based Merkle Tree.")
    x = int.from_bytes(magic + b"\x00" * ((753 + 15) // 8 - len(magic)),
                       "little")
    h = PoseidonHash(PoseidonParams.mnt4753("cpu"), device="cpu")
    assert h.evaluate_ints([[x]])[0] == MNT4753_PHANTOM_MERKLE_ROOT
