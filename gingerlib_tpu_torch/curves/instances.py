"""Concrete curve instantiations of the port: MNT4-753 (the proving path)
and BLS12-377 (the narrow width the CPU tests use).

Each constructor takes ``device`` under the package's device rule and caches
one curve object per device (and, for G1, per choice of ``ec_rns``: the RNS
multiplies in ``batch_affine_add``, see ``SWCurveOps``).  Constants come from ``params/_gen`` (standard
form); Frobenius tables are derived on the fly.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from .. import params as PP
from ..device import resolve_device
from ..params._gen import curves_gen as CG, towers_gen as TG
from ..fields import towers as T
from .sw import SWCurveOps


@dataclass(frozen=True)
class Engine:
    """The two source groups of a pairing.  The prover needs nothing else;
    the pairing itself arrives with the verifier."""
    g1: SWCurveOps
    g2: SWCurveOps


@functools.lru_cache()
def mnt4753_towers():
    return T.build_quadratic_tower(PP.MNT4753_FQ,
                                   TG.MNT4753_FQ2["nonresidue"])


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


def mnt4753_engine(device=None) -> Engine:
    return Engine(mnt4753_g1(device), mnt4753_g2(device))


def bls12_377_engine(device=None) -> Engine:
    return Engine(bls12_377_g1(device), bls12_377_g2(device))
