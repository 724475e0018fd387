"""The Poseidon permutation (x^-1 S-box, T = 3): kernel K9 and its plain
version.

Counterpart of ``gingerlib_tpu/ops/pallas_poseidon.py``.  Three functions,
dispatched on where the state lives, as in ``fields/fp.py`` -- no fallback
and no switch:

* ``permute_cuda`` -> ``csrc/poseidon.cu``; replaces ``permute_fused`` (its
  entry, round and exit kernels).  A group of threads per sponge, all
  rounds in one launch; a block of S sponges shares one inversion a round
  through a product tree in shared memory, S from the batch
  (``block_sponges``; the source note in the ``.cu`` file says why).  The
  JAX package's RNS form and its ``GINGERLIB_FUSED_POSEIDON`` /
  ``GINGERLIB_POSEIDON_TILE`` switches are the TPU's and are not carried
  over.
* ``permute_block_model``: the kernel's schedule in plain PyTorch -- blocks
  of S sponges, each block's S-box inputs through its own product tree in
  the kernel's order of products -- for the tests.
* ``permute_plain``: the array path of ``PoseidonHash.permute`` in the JAX
  package -- add the round constants, invert the S-box lanes of the whole
  batch with one shared-inversion tree (``fp.batch_inverse_tree``), mix by
  the MDS matrix -- over ``fp.add_mod`` / ``fp.mont_mul``, so on a GPU it
  runs on the field kernels, some 40 launches a round.
* ``permute``: the kernel for a CUDA state, the plain version for a CPU one.

The state is ``[B, 3, n_digits]`` int64 digits in Montgomery form, canonical
in and out; both versions give the same digits (an inverse is unique).  The
kernel counts its launches in ``fields.fp.launch_counts["poseidon_permute"]``.
"""

from __future__ import annotations

import torch

from ..fields import fp as fpmod
from . import limbs

KERNEL_DIGITS = (16, 24, 48)   # widths K9 is built for


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _sbox_full(F, state):
    B, t, nd = state.shape
    return fpmod.batch_inverse_tree(F, state.reshape(B * t, nd)).reshape(
        B, t, nd)


def _sbox_partial(F, state):
    s0 = fpmod.batch_inverse_tree(F, state[:, 0, :])
    return torch.cat([s0[:, None, :], state[:, 1:, :]], dim=1)


def _mix(F, mds, state):
    """new_i = sum_j MDS[i, j] * s_j (matrix_mix_short, mod.rs:374-425)."""
    prods = fpmod.mont_mul(F, mds[None], state[:, None])     # [B, t, t, nd]
    acc = prods[:, :, 0, :]
    for j in range(1, mds.shape[0]):
        acc = fpmod.add_mod(F, acc, prods[:, :, j, :])
    return acc


def permute_plain(params, state):
    """The array path: ``R_F`` full rounds, ``R_P`` partial ones, ``R_F - 1``
    full ones, each ending in the MDS mix, and a last full round without
    it."""
    F = params.field
    rounds = params.n_rounds
    for r in range(rounds):
        state = fpmod.add_mod(F, state, params.rc[r])
        if params.r_f <= r < params.r_f + params.r_p:
            state = _sbox_partial(F, state)
        else:
            state = _sbox_full(F, state)
        if r < rounds - 1:
            state = _mix(F, params.mds, state)
    return state


# ---------------------------------------------------------------------------
# the kernel's block schedule
# ---------------------------------------------------------------------------

MAX_BLOCK_SPONGES = 64      # S at most (csrc/poseidon.cu kMaxSponges)
MIN_BLOCKS_PER_SM = 1       # blocks an SM that S must leave


def block_sponges(n: int, sms: int) -> int:
    """Sponges a block (S) that the kernel's launcher takes for a batch of
    ``n`` on a card of ``sms`` SMs: the largest power of two up to
    ``MAX_BLOCK_SPONGES`` whose ceil(n / S) blocks leave every SM at least
    ``MIN_BLOCKS_PER_SM``; 1 where none above 1 does."""
    s = MAX_BLOCK_SPONGES
    while s > 1 and -(-n // s) < MIN_BLOCKS_PER_SM * sms:
        s //= 2
    return s


def block_sponges_cuda(n: int) -> int:
    """The S the kernel's launcher takes for a batch of ``n`` on the current
    CUDA device (its own computation, which ``block_sponges`` models)."""
    s = fpmod._kernel("gl_poseidon_block_sponges")(n)
    if s < 1:
        raise RuntimeError(f"poseidon_permute: device query failed (code "
                           f"{-s})")
    return s


def _tree_inverse(F, leaves):
    """Inverses of non-zero leaves [blocks, n, nd], one tree a block in the
    kernel's order: level by level, pairs multiplied and an odd last
    element passed up; the root inverted; down again, each pair's
    inverses from its parent's and the sibling's product."""
    blocks, _, nd = leaves.shape
    levels = [leaves]
    while levels[-1].shape[1] > 1:
        cur = levels[-1]
        h = cur.shape[1] // 2
        up = fpmod.mont_mul(F, cur[:, 0:2 * h:2], cur[:, 1:2 * h:2])
        levels.append(torch.cat([up, cur[:, 2 * h:]], dim=1))
    inv = fpmod.inv_mod(F, levels[-1].reshape(blocks, nd)).reshape(
        blocks, 1, nd)
    for child in reversed(levels[:-1]):
        h = child.shape[1] // 2
        ip = inv[:, :h]
        pairs = torch.stack([fpmod.mont_mul(F, ip, child[:, 1:2 * h:2]),
                             fpmod.mont_mul(F, ip, child[:, 0:2 * h:2])],
                            dim=2).reshape(blocks, 2 * h, nd)
        inv = torch.cat([pairs, inv[:, h:]], dim=1)
    return inv


def permute_block_model(params, state, sponges: int):
    """The permutation as the kernel schedules it, in plain PyTorch, for
    blocks of ``sponges`` (S): the batch padded with zero states to whole
    blocks (a block's last groups run on a zero state, as the kernel's
    groups past the batch do); each round's S-box inputs of a block (3 S
    in a full round, S in a partial one; leaf q k + t is element t of
    sponge q) inverted through the block's own tree (``_tree_inverse``),
    zeros entering as one and leaving as zero.  The same digits as
    ``permute_plain``: an inverse is unique."""
    F = params.field
    B, t, nd = state.shape
    blocks = -(-B // sponges)
    state = torch.cat([state, state.new_zeros(blocks * sponges - B, t, nd)])
    one = F.tensor("one_mont", state.device)
    rounds = params.n_rounds
    for r in range(rounds):
        state = fpmod.add_mod(F, state, params.rc[r])
        k = 1 if params.r_f <= r < params.r_f + params.r_p else t
        x = state[:, :k]
        zero = limbs.is_zero(x).unsqueeze(-1)
        inv = _tree_inverse(F, torch.where(zero, one, x).reshape(
            blocks, sponges * k, nd)).reshape(-1, k, nd)
        state = torch.cat([torch.where(zero, torch.zeros_like(inv), inv),
                           state[:, k:]], dim=1)
        if r < rounds - 1:
            state = _mix(F, params.mds, state)
    return state[:B]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

# {batch: launches} of the kernel since the last clear (chip_smoke.py times
# the kernel at the widths a path launched it)
launch_widths: dict = {}


def permute_cuda(params, state):
    """Launch the Poseidon kernel on a CUDA state [B, 3, nd]: the whole
    permutation of every sponge in one launch."""
    F = params.field
    fpmod._check_operand(F, state, "poseidon_permute", KERNEL_DIGITS)
    if params.t != 3:
        raise NotImplementedError(f"poseidon_permute: the kernel is built "
                                  f"for a state of 3, not {params.t}")
    if state.dim() != 3 or state.shape[1] != 3:
        raise ValueError(f"poseidon_permute: expected [B, 3, nd], got "
                         f"{tuple(state.shape)}")
    if state.device != params.device:
        raise ValueError(f"poseidon_permute: state on {state.device}, "
                         f"parameters on {params.device}")
    n = state.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"poseidon_permute: batch of {n} is too large")
    x = state.contiguous()
    if x.data_ptr() & 15:
        x = x.clone()
    out = torch.empty_like(x)
    consts = params.kernel_consts
    rc = fpmod._kernel("gl_poseidon_permute")(
        F.n_digits, x.data_ptr(), out.data_ptr(), n, consts.data_ptr(),
        consts.numel(), params.r_f, params.r_p, F.inv32, fpmod._raw_stream(x))
    if rc != 0:
        raise RuntimeError(f"poseidon_permute: kernel launch failed "
                           f"(code {rc})")
    if n:
        fpmod.count_launch("poseidon_permute", F.n_digits)
        launch_widths[n] = launch_widths.get(n, 0) + 1
    return out


def permute(params, state):
    """The Poseidon permutation of a batch of sponges [B, 3, nd]."""
    if state.is_cuda:
        return permute_cuda(params, state)
    return permute_plain(params, state)
