"""Concrete curve instantiations of the port: the MNT4-753/MNT6-753 cycle
(Groth16 and GM17 setup, prove and verify over either curve) and BLS12-377
(the narrow width the CPU tests use; its pairing is not ported yet).

Each constructor takes ``device`` under the package's device rule and caches
one object per device (and, for G1, per choice of ``ec_rns``: the RNS
multiplies in ``batch_affine_add``, see ``SWCurveOps``).  Constants come
from ``params/_gen`` (standard form); Frobenius tables are derived on the
fly.

An engine is what Groth16 takes: the pairing where there is one (an
``MNTPairing``, which carries ``g1`` and ``g2``), else an ``Engine`` of the
two groups, which can set up and prove but not verify.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from .. import params as PP
from ..device import resolve_device
from ..params._gen import curves_gen as CG, towers_gen as TG
from ..fields import towers as T
from .pairing_mnt import MNTPairing
from .sw import SWCurveOps


@dataclass(frozen=True)
class Engine:
    """The two source groups of a curve whose pairing is not ported: the
    prover needs nothing else."""
    g1: SWCurveOps
    g2: SWCurveOps


@functools.lru_cache()
def mnt4753_towers():
    """(Fq, Fq2, Fq4) of MNT4-753."""
    return T.build_mnt4_towers(PP.MNT4753_FQ, TG.MNT4753_FQ2["nonresidue"])


@functools.lru_cache()
def mnt6753_towers():
    """(Fq, Fq3, Fq6) of MNT6-753."""
    return T.build_mnt6_towers(PP.MNT6753_FQ, TG.MNT6753_FQ3["nonresidue"])


@functools.lru_cache()
def bls12_377_towers():
    return T.build_quadratic_tower(PP.BLS12_377_FQ,
                                   TG.BLS12_377_FQ2["nonresidue"])


@functools.lru_cache()
def _curve(family: str, group: str, device, ec_rns: bool = False
           ) -> SWCurveOps:
    towers, c, fr = {
        "mnt4753": (mnt4753_towers, CG.MNT4753, PP.MNT4753_FR),
        "mnt6753": (mnt6753_towers, CG.MNT6753, PP.MNT6753_FR),
        "bls12_377": (bls12_377_towers, CG.BLS12_377, PP.BLS12_377_FR),
    }[family]
    if group == "g1":
        return SWCurveOps(f"{family}_g1", towers()[0], c["a"], c["b"],
                          generator_host=(c["g1_x"], c["g1_y"]),
                          cofactor=c["cofactor"],
                          cofactor_inv=c["cofactor_inv"],
                          scalar_field=fr, device=device, ec_rns=ec_rns)
    return SWCurveOps(f"{family}_g2", towers()[1], c["g2_a"], c["g2_b"],
                      generator_host=(c["g2_x"], c["g2_y"]),
                      cofactor=c["g2_cofactor"],
                      cofactor_inv=c["g2_cofactor_inv"],
                      scalar_field=fr, device=device)


def mnt4753_g1(device=None, ec_rns: bool = False) -> SWCurveOps:
    return _curve("mnt4753", "g1", resolve_device(device), ec_rns)


def mnt4753_g2(device=None) -> SWCurveOps:
    return _curve("mnt4753", "g2", resolve_device(device))


def mnt6753_g1(device=None, ec_rns: bool = False) -> SWCurveOps:
    return _curve("mnt6753", "g1", resolve_device(device), ec_rns)


def mnt6753_g2(device=None) -> SWCurveOps:
    """G2 of MNT6-753, over Fq3."""
    return _curve("mnt6753", "g2", resolve_device(device))


def bls12_377_g1(device=None, ec_rns: bool = False) -> SWCurveOps:
    return _curve("bls12_377", "g1", resolve_device(device), ec_rns)


def bls12_377_g2(device=None) -> SWCurveOps:
    return _curve("bls12_377", "g2", resolve_device(device))


# (curve constants, G1, G2, GT's tower, easy part: the Frobenius power and
# whether the (q + 1) factor follows)
_MNT = {
    "mnt4753": (CG.MNT4753, mnt4753_g1, mnt4753_g2, mnt4753_towers, 2, False),
    "mnt6753": (CG.MNT6753, mnt6753_g1, mnt6753_g2, mnt6753_towers, 3, True),
}


@functools.lru_cache()
def _mnt_pairing(family: str, device) -> MNTPairing:
    c, g1, g2, towers, easy_frob, q_plus_1 = _MNT[family]
    return MNTPairing(
        family, g1(device), g2(device), towers()[2], wnaf=c["wnaf"],
        ate_is_neg=c["ate_is_loop_count_neg"],
        w1=c["final_exponent_last_chunk_1"],
        w0_abs=c["final_exponent_last_chunk_abs_of_w0"],
        w0_is_neg=c["final_exponent_last_chunk_w0_is_neg"],
        easy_frob=easy_frob, easy_mul_q_plus_1=q_plus_1)


def mnt4753_pairing(device=None) -> MNTPairing:
    return _mnt_pairing("mnt4753", resolve_device(device))


def mnt6753_pairing(device=None) -> MNTPairing:
    """MNT6-753's ate pairing: GT in Fq6, the easy part q^3 - 1 then
    q + 1."""
    return _mnt_pairing("mnt6753", resolve_device(device))


def mnt4753_engine(device=None) -> MNTPairing:
    """MNT4-753's engine: its pairing, with ``g1`` and ``g2``."""
    return mnt4753_pairing(device)


def mnt6753_engine(device=None) -> MNTPairing:
    """MNT6-753's engine: its pairing, with ``g1`` and ``g2``."""
    return mnt6753_pairing(device)


def bls12_377_engine(device=None) -> Engine:
    return Engine(bls12_377_g1(device), bls12_377_g2(device))
