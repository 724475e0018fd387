"""Poseidon hash (x^-1 S-box, T = 3, rate 2), batched.

Counterpart of ``gingerlib_tpu/primitives/poseidon.py`` (the reference's
PoseidonHash / PoseidonBatchHash), with the round schedule of the code, not
of doc/Poseidon.md:

    R_F full rounds | R_P partial rounds | R_F - 1 full rounds | one last
    full round without the MDS mix.

MNT4-753: R_F = 4, R_P = 57 (65 rounds); MNT6-753: R_F = 2, R_P = 60 (64).
A hash is a batch of sponges ``[B, T, n_digits]`` in Montgomery form.  The
permutation is ``ops/poseidon_kernels.permute``: on a GPU one launch of the
Poseidon kernel for the whole batch and all rounds, on the CPU the array
path (a shared-inversion tree a round).  The absorb schedule around it
(``evaluate``) is array code over the field's add.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import params as PP
from ..device import resolve_device
from ..fields import fp as fpmod
from ..fields.fp import FpParams
from ..ops import poseidon_kernels
from ..ops.limbs import DTYPE, limbs32


class PoseidonParams:
    """Round counts and constants of one Poseidon instance, as Montgomery
    digit tensors on ``device`` (``None``: the GPU).  ``rc`` holds the
    constants of every round in order, ``[2 R_F + R_P, T, nd]``: the JAX
    package's ``rc_full1``, ``rc_partial``, ``rc_full2`` and ``rc_last`` one
    after the other."""

    def __init__(self, field: FpParams, t: int, r_f: int, r_p: int,
                 rate: int, c2: int, round_cst, mds, after_zero_perm,
                 device=None):
        """From python ints in standard form, as the JAX class takes them;
        round constants beyond the schedule's ``2 R_F + R_P`` rounds are
        not used."""
        nd = field.n_digits
        n_rc = t * (2 * r_f + r_p)
        if len(round_cst) < n_rc:
            raise ValueError(f"{2 * r_f + r_p} rounds need {n_rc} round "
                             f"constants, got {len(round_cst)}")
        self._set(field, t, r_f, r_p, rate,
                  fpmod.fp_from_int(field, c2),
                  fpmod.fp_from_ints(field, round_cst[:n_rc]).reshape(
                      -1, t, nd),
                  fpmod.fp_from_ints(field, mds).reshape(t, t, nd),
                  fpmod.fp_from_ints(field, after_zero_perm), device)

    @classmethod
    def from_digits(cls, field: FpParams, t: int, r_f: int, r_p: int,
                    rate: int, c2, rc, mds, after_zero_perm, device=None):
        """From Montgomery digit arrays (any integer dtype): ``c2`` [nd],
        ``rc`` [2 R_F + R_P, t, nd], ``mds`` [t, t, nd], ``after_zero_perm``
        [t, nd]."""
        self = cls.__new__(cls)
        self._set(field, t, r_f, r_p, rate, c2, rc, mds, after_zero_perm,
                  device)
        return self

    def _set(self, field, t, r_f, r_p, rate, c2, rc, mds, after_zero_perm,
             device):
        device = resolve_device(device)
        nd = field.n_digits
        shapes = {"c2": (nd,), "rc": (2 * r_f + r_p, t, nd),
                  "mds": (t, t, nd), "after_zero_perm": (t, nd)}
        arrays = {"c2": c2, "rc": rc, "mds": mds,
                  "after_zero_perm": after_zero_perm}
        if r_f < 1 or r_p < 0 or not 0 < rate < t:
            raise ValueError(f"round counts R_F={r_f}, R_P={r_p} or rate "
                             f"{rate} of a width-{t} state")
        self.field = field
        self.t, self.r_f, self.r_p, self.rate = t, r_f, r_p, rate
        self.device = device
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            if arr.shape != shapes[name]:
                raise ValueError(f"{name}: expected shape {shapes[name]}, "
                                 f"got {arr.shape}")
            setattr(self, name, torch.from_numpy(
                arr.astype(np.int64)).to(device))

    @property
    def n_rounds(self) -> int:
        return 2 * self.r_f + self.r_p

    @functools.cached_property
    def kernel_consts(self) -> torch.Tensor:
        """What the Poseidon kernel copies into shared memory, as 32-bit
        limbs on the device: p, one, R^3, the MDS matrix row-major, then
        the round constants round by round."""
        F = self.field
        host = np.concatenate([
            limbs32(F.modulus_digits), limbs32(F.one_mont),
            limbs32(F.r3_digits), limbs32(self.mds.cpu().numpy()),
            limbs32(self.rc.cpu().numpy())])
        return torch.from_numpy(host.view(np.int32)).to(self.device)

    @staticmethod
    def mnt4753(device=None) -> "PoseidonParams":
        return _named("mnt4753", resolve_device(device))

    @staticmethod
    def mnt6753(device=None) -> "PoseidonParams":
        return _named("mnt6753", resolve_device(device))


@functools.lru_cache()
def _named(name: str, device: torch.device) -> PoseidonParams:
    from ..params._gen import poseidon_gen
    d = getattr(poseidon_gen, "POSEIDON_" + name.upper())
    field = PP.MNT4753_FR if name == "mnt4753" else PP.MNT6753_FR
    return PoseidonParams(field, d["t"], d["r_f"], d["r_p"], d["rate"],
                          d["c2"], d["round_cst"], d["mds"],
                          d["after_zero_perm"], device=device)


class PoseidonHash:
    """Batched sponge; mirrors FieldBasedHash::evaluate (mod.rs:580-616).
    ``device`` (``None``: the GPU) must be the one the parameters live on."""

    def __init__(self, params: PoseidonParams, device=None):
        device = resolve_device(device)
        if params.device != device:
            raise ValueError(f"the Poseidon parameters live on "
                             f"{params.device}, not on the requested device "
                             f"{device}")
        self.p = params
        self.F = params.field
        self.device = device

    def permute(self, state):
        """state [B, T, nd] -> the permuted state (one kernel launch on a
        GPU)."""
        return poseidon_kernels.permute(self.p, state)

    def init_state(self, batch: int):
        return self.p.after_zero_perm.expand(batch, *self.p.after_zero_perm
                                             .shape)

    def evaluate(self, inputs):
        """inputs [B, L, nd] Montgomery field elements -> [B, nd].

        Absorbs rate-sized chunks, adding C2 to the capacity with each; a
        trailing partial chunk goes into the first elements, as in the
        reference (mod.rs:603-612)."""
        B, L, nd = inputs.shape
        F, P = self.F, self.p
        rate = P.rate
        state = self.init_state(B)
        full, rem = divmod(L, rate)
        for i in range(full):
            absorbed = fpmod.add_mod(F, state[:, :rate],
                                     inputs[:, i * rate:(i + 1) * rate])
            cap = fpmod.add_mod(F, state[:, rate:], P.c2)
            state = self.permute(torch.cat([absorbed, cap], dim=1))
        if rem:
            a0 = fpmod.add_mod(F, state[:, :rem], inputs[:, full * rate:])
            cap = fpmod.add_mod(F, state[:, rate:], P.c2)
            state = self.permute(torch.cat([a0, state[:, rem:rate], cap],
                                           dim=1))
        return state[:, 0].contiguous()

    def hash_2_1(self, left, right):
        """Batched 2 -> 1 compression [B, nd] x [B, nd] -> [B, nd]."""
        return self.evaluate(torch.stack([left, right], dim=1))

    def evaluate_ints(self, rows):
        """rows: lists of python ints, all of one length -> list of ints."""
        arr = np.stack([fpmod.fp_from_ints(self.F, row) for row in rows])
        out = self.evaluate(torch.from_numpy(arr).to(self.device, DTYPE))
        return fpmod.fp_to_ints(self.F, out.cpu())
