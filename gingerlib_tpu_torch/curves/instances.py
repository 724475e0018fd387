"""Concrete curve instantiations of the port: MNT4-753 (the main path:
setup, prove and verify) and BLS12-377 (the narrow width the CPU tests use;
its pairing is not ported yet).

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
def bls12_377_towers():
    return T.build_quadratic_tower(PP.BLS12_377_FQ,
                                   TG.BLS12_377_FQ2["nonresidue"])


@functools.lru_cache()
def _curve(family: str, group: str, device, ec_rns: bool = False
           ) -> SWCurveOps:
    towers, c, fr = {
        "mnt4753": (mnt4753_towers, CG.MNT4753, PP.MNT4753_FR),
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


def bls12_377_g1(device=None, ec_rns: bool = False) -> SWCurveOps:
    return _curve("bls12_377", "g1", resolve_device(device), ec_rns)


def bls12_377_g2(device=None) -> SWCurveOps:
    return _curve("bls12_377", "g2", resolve_device(device))


@functools.lru_cache()
def _mnt4753_pairing(device) -> MNTPairing:
    c = CG.MNT4753
    return MNTPairing(
        "mnt4753", mnt4753_g1(device), mnt4753_g2(device),
        mnt4753_towers()[2], wnaf=c["wnaf"],
        ate_is_neg=c["ate_is_loop_count_neg"],
        w1=c["final_exponent_last_chunk_1"],
        w0_abs=c["final_exponent_last_chunk_abs_of_w0"],
        w0_is_neg=c["final_exponent_last_chunk_w0_is_neg"])


def mnt4753_pairing(device=None) -> MNTPairing:
    return _mnt4753_pairing(resolve_device(device))


def mnt4753_engine(device=None) -> MNTPairing:
    """MNT4-753's engine: its pairing, with ``g1`` and ``g2``."""
    return mnt4753_pairing(device)


def bls12_377_engine(device=None) -> Engine:
    return Engine(bls12_377_g1(device), bls12_377_g2(device))
