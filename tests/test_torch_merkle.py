"""Port: the Poseidon field-based Merkle tree
(gingerlib_tpu_torch.primitives.merkle) on ``device="cpu"``.

Mirrors tests/test_merkle.py of the JAX package at the reduced round count
of ``test_torch_cases.reduced_poseidon`` (MNT4-753 constants, three rounds):
a 4-leaf and a 3-leaf tree at height 4 (one padding-chain hash; the 3-leaf
tree pads its last level with H(one)), against the python-int oracle and
against the digits the JAX ``FieldBasedMerkleTree`` returned for the same
leaves (``JAX_MERKLE``; a ``slow`` test holds the JAX tree to them); a left
and a right path verified and re-hashed to the root by the oracle, a wrong
leaf and a wrong root refused, the path-length error.

Every 2 -> 1 hash is a plain permutation of seconds here, so the hasher of
these tests remembers each sponge it has permuted (``RememberingHash``):
verifying a path of the tree re-hashes nodes the build already hashed.  The
tree's code runs as it is; only repeated permutations of the same state are
looked up.  Integer arithmetic: tolerance 0.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gingerlib_tpu import params as JP
from gingerlib_tpu.fields import fp as jfp
from gingerlib_tpu.primitives import merkle as jmerkle, poseidon as jpos
from gingerlib_tpu_torch import params as TP
from gingerlib_tpu_torch.fields import fp as tfp
from gingerlib_tpu_torch.ops import limbs as tlimbs
from gingerlib_tpu_torch.primitives.merkle import FieldBasedMerkleTree
from gingerlib_tpu_torch.primitives.poseidon import (PoseidonHash,
                                                     PoseidonParams)
from gingerlib_tpu_torch.primitives.poseidon_host import PoseidonHost
from test_torch_cases import JAX_MERKLE, merkle_leaves, reduced_poseidon

torch.set_num_threads(1)
HEIGHT = 4
F = TP.MNT4753_FR


class RememberingHash(PoseidonHash):
    """The port's sponge, permuting each state it has not seen before (in
    one batch) and looking up the ones it has."""

    def __init__(self, params):
        super().__init__(params, device="cpu")
        self.seen = {}

    def permute(self, state):
        rows = [s.numpy().tobytes() for s in state]
        new = [i for i, k in enumerate(rows) if k not in self.seen]
        if new:
            out = super().permute(state[new])
            for i, o in zip(new, out):
                self.seen[rows[i]] = o
        return torch.stack([self.seen[k] for k in rows])


@pytest.fixture(scope="module")
def setup():
    d = reduced_poseidon("mnt4753")
    P = PoseidonParams(F, d["t"], d["r_f"], d["r_p"], d["rate"], d["c2"],
                       d["round_cst"], d["mds"], d["after_zero_perm"],
                       device="cpu")
    h = RememberingHash(P)
    vals = merkle_leaves()
    leaves = torch.from_numpy(tfp.fp_from_ints(F, vals))
    trees = {n: FieldBasedMerkleTree(h, HEIGHT, device="cpu").build(
        leaves[:n]) for n in (4, 3)}
    return dict(d=d, h=h, vals=vals, leaves=leaves, trees=trees,
                host=PoseidonHost(d, F.modulus))


def host_tree(host, vals):
    """Every level of the tree by the python-int oracle, then the padding
    chain's root."""
    empty = host.evaluate([1])
    levels = [list(vals) + [empty] * ((1 << (len(vals) - 1).bit_length())
                                      - len(vals))]
    while len(levels[-1]) > 1:
        cur = levels[-1]
        levels.append([host.evaluate(cur[i:i + 2])
                       for i in range(0, len(cur), 2)])
    root = levels[-1][0]
    for _ in range(len(levels), HEIGHT):
        root = host.evaluate([root, empty])
    return levels, root


def ints(x):
    return tfp.fp_to_ints(F, x.reshape(-1, F.n_digits))


@pytest.mark.parametrize("n", [4, 3])
def test_tree_matches_oracle_and_jax(setup, n):
    tree = setup["trees"][n]
    levels, root = host_tree(setup["host"], setup["vals"][:n])
    assert [ints(lvl) for lvl in tree.levels] == levels
    assert len(tree.padding) == 1
    assert ints(tree.root()) == [root]
    spelled = [tlimbs.from_digits_batch(lvl) for lvl in tree.levels]
    spelled.append([tlimbs.from_digits(tree.root())])
    assert spelled == JAX_MERKLE[n]


def test_three_leaves_pad_with_the_empty_leaf(setup):
    """A 3-leaf tree is the 4-leaf tree of its leaves and H(one)."""
    t3 = setup["trees"][3]
    four = torch.cat([setup["leaves"][:3], t3.empty_leaf()[None]])
    t4 = FieldBasedMerkleTree(setup["h"], HEIGHT, device="cpu").build(four)
    assert torch.equal(t4.root(), t3.root())
    assert ints(t3.empty_leaf()) == [setup["host"].evaluate([1])]


@pytest.mark.parametrize("index,directions", [
    (1, [True, False, False]), (2, [False, True, False])])
def test_path_verifies_and_rehashes_to_the_root(setup, index, directions):
    """A right child at the leaves (1) and a left one (2), each with the
    padding leaf as its last sibling."""
    tree, host = setup["trees"][4], setup["host"]
    path = tree.generate_proof(index)
    assert [d for _, d in path] == directions
    assert torch.equal(path[-1][0], tree.empty_leaf())
    assert tree.verify_proof(tree.root(), setup["leaves"][index], path)
    cur = setup["vals"][index]
    for sib, right in path:
        s = ints(sib)[0]
        cur = host.evaluate([s, cur] if right else [cur, s])
    assert [cur] == ints(tree.root())


def test_wrong_leaf_rejected(setup):
    tree = setup["trees"][4]
    path = tree.generate_proof(1)
    assert not tree.verify_proof(tree.root(), setup["leaves"][0], path)


def test_wrong_root_rejected(setup):
    tree = setup["trees"][4]
    bad = tree.root().clone()
    bad[0] ^= 1
    assert not tree.verify_proof(bad, setup["leaves"][2],
                                 tree.generate_proof(2))


def test_path_length_and_height_errors(setup):
    tree = setup["trees"][4]
    path = tree.generate_proof(0)
    with pytest.raises(ValueError, match="path length"):
        tree.verify_proof(tree.root(), setup["leaves"][0], path[:-1])
    with pytest.raises(ValueError, match="HEIGHT"):
        FieldBasedMerkleTree(setup["h"], 2, device="cpu").build(
            setup["leaves"])


# ---------------------------------------------------------------------------
# slow: the JAX tree on the same leaves
# ---------------------------------------------------------------------------

def jax_tree_digits(n):
    d = reduced_poseidon("mnt4753")
    jh = jpos.PoseidonHash(jpos.PoseidonParams(
        JP.MNT4753_FR, d["t"], d["r_f"], d["r_p"], d["rate"], d["c2"],
        d["round_cst"], d["mds"], d["after_zero_perm"]))
    leaves = jnp.asarray(jfp.fp_from_ints(jh.F, merkle_leaves()[:n]))
    t = jmerkle.FieldBasedMerkleTree(jh, HEIGHT).build(leaves)
    out = [tlimbs.from_digits_batch(np.asarray(lvl)) for lvl in t.levels]
    out.append([tlimbs.from_digits(np.asarray(t.root()))])
    return out


@pytest.mark.slow
@pytest.mark.parametrize("n", [4, 3])
def test_jax_tree_gives_the_recorded_digits(n):
    assert jax_tree_digits(n) == JAX_MERKLE[n]
