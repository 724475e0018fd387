"""The Poseidon permutation (x^-1 S-box, T = 3): kernel K9 and its plain
version.

Counterpart of ``gingerlib_tpu/ops/pallas_poseidon.py``.  Three functions,
dispatched on where the state lives, as in ``fields/fp.py`` -- no fallback
and no switch:

* ``permute_cuda`` -> ``csrc/poseidon.cu``; replaces ``permute_fused`` (its
  entry, round and exit kernels).  One thread per sponge, all rounds in one
  launch; the JAX package's RNS form and its ``GINGERLIB_FUSED_POSEIDON`` /
  ``GINGERLIB_POSEIDON_TILE`` switches are the TPU's and are not carried
  over.  Its time goes to the binary-Euclid inversions, one a round per
  sponge (source note in the ``.cu`` file).
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
from ..fields.fp import launch_counts


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
# the kernel
# ---------------------------------------------------------------------------

def permute_cuda(params, state):
    """Launch the Poseidon kernel on a CUDA state [B, 3, nd]: the whole
    permutation of every sponge in one launch."""
    F = params.field
    fpmod._check_operand(F, state, "poseidon_permute")
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
        launch_counts["poseidon_permute"] += 1
    return out


def permute(params, state):
    """The Poseidon permutation of a batch of sponges [B, 3, nd]."""
    if state.is_cuda:
        return permute_cuda(params, state)
    return permute_plain(params, state)
