"""The block schedule of the Poseidon kernel K9 (``csrc/poseidon.cu``), in
plain PyTorch on the CPU:

    python -m pytest tests/test_torch_poseidon_blocks.py -q

``ops/poseidon_kernels.block_sponges`` is the kernel's rule for S, the
sponges a block (their S-box inputs share one inversion a round), and
``permute_block_model`` runs the permutation in the kernel's order: blocks
of S sponges padded with zero states, each round's S-box inputs of a block
through the block's own product tree (pairs, an odd last element passed
up, the root inverted, down again), zeros in as one and out as zero.  It
must equal ``permute_plain`` (one tree for the whole batch), the python-int
oracle, and the digits the JAX package's ``PoseidonHash.permute`` gives on
the shared test states (``test_torch_cases.JAX_POSEIDON``, which the slow
test of tests/test_torch_poseidon.py holds the JAX function to), at the
reduced round counts of ``test_torch_cases.reduced_poseidon`` (real
constants, R_F = R_P = 1), on batches whose zero S-box inputs fall at the
edges of the trees: the first and last leaf of a block and a whole block.
Integer arithmetic: tolerance 0.
"""

import pytest
import torch

from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.fields import fp
from gingerlib_tpu_torch.ops import limbs
from gingerlib_tpu_torch.ops import poseidon_kernels as PK
from gingerlib_tpu_torch.primitives.poseidon import PoseidonParams
from gingerlib_tpu_torch.primitives.poseidon_host import PoseidonHost
from test_torch_cases import (JAX_POSEIDON, poseidon_states, rand_below,
                              reduced_poseidon)

torch.set_num_threads(1)
FIELD = {"mnt4753": "MNT4753_FR", "mnt6753": "MNT6753_FR"}


@pytest.mark.parametrize("sms", [1, 114, 132])
def test_block_sponges_rule(sms):
    """S is a power of two up to 64; above 1 it leaves every SM a block
    (MIN_BLOCKS_PER_SM) and 2 S would not; S = 1 where S = 2 would not."""
    least = PK.MIN_BLOCKS_PER_SM * sms
    for n in list(range(1, 300)) + [1 << k for k in range(9, 18)] + [
            least * s + d for s in (1, 2, 4, 8, 16, 32, 64)
            for d in (-1, 0, 1)]:
        if n < 1:
            continue
        s = PK.block_sponges(n, sms)
        assert s in (1, 2, 4, 8, 16, 32, 64)
        blocks = lambda k: -(-n // k)  # noqa: E731
        if s > 1:
            assert blocks(s) >= least
        if s < 64:
            assert blocks(2 * s) < least
    if sms == 132:      # the Merkle tree's levels on an H100
        assert [PK.block_sponges(1 << k, 132) for k in range(16)] == \
            [1] * 9 + [2, 4, 8, 16, 32, 64, 64]


def states(name, S):
    """Sponge states as python ints, 2 S + 5 of them: block 0 with a zero
    S-box input at its first leaf (sponge 0, element 0) and at its last
    (sponge S - 1, element 2) after the first round's constants; block 1
    all zero after them; then the shared test states (the JAX digits'
    inputs) and one seeded state."""
    d = reduced_poseidon(name)
    p = PoseidonHost(d, getattr(TP, FIELD[name]).modulus).p
    neg = [(-c) % p for c in d["round_cst"][:3]]
    out = [rand_below(p, 3, seed=90 + i) for i in range(S)]
    out[0][0] = neg[0]
    out[S - 1][2] = neg[2]
    out += [list(neg) for _ in range(S)]
    return out + poseidon_states(name) + [rand_below(p, 3, seed=99)], d


@pytest.mark.parametrize("name,S", [("mnt4753", 1), ("mnt4753", 2),
                                    ("mnt4753", 4), ("mnt6753", 4)])
def test_block_model_matches_plain_oracle_and_jax(name, S):
    rows, d = states(name, S)
    F = getattr(TP, FIELD[name])
    P = PoseidonParams(F, d["t"], d["r_f"], d["r_p"], d["rate"], d["c2"],
                       d["round_cst"], d["mds"], d["after_zero_perm"],
                       device="cpu")
    x = torch.from_numpy(fp.fp_from_ints(F, sum(rows, []))).reshape(
        len(rows), 3, -1)
    got = PK.permute_block_model(P, x, S)
    assert torch.equal(got, PK.permute_plain(P, x))
    host = PoseidonHost(d, F.modulus)
    ints = fp.fp_to_ints(F, got.reshape(-1, F.n_digits))
    assert ints == sum((host.permute(s) for s in rows), [])
    shared = slice(2 * S, 2 * S + len(poseidon_states(name)))
    assert limbs.from_digits_batch(got[shared]) == JAX_POSEIDON[
        name, "permute"]
