"""Concrete curve instantiations of the port: the MNT4-753/MNT6-753 cycle,
BLS12-377 and BLS12-381, SW6 (CP6-782, whose Fr is BLS12-377's Fq: the
BLS12-377 recursion's outer curve) and MNT6-298 (Groth16 and GM17 setup,
prove and verify over each curve), and the twisted-Edwards curves over
BLS12-381 Fr (Jubjub), BLS12-377 Fr (Edwards-BLS12) and BLS12-377 Fq = SW6
Fr (Edwards-SW6).

Each constructor takes ``device`` under the package's device rule and caches
one object per device (and, for G1, per choice of ``ec_rns``: the RNS
multiplies in ``batch_affine_add``, see ``SWCurveOps``).  Constants come
from ``params/_gen`` (standard form); Frobenius tables are derived on the
fly.

An engine is what Groth16 and GM17 take: the curve's pairing (an
``MNTPairing`` or a ``Bls12Pairing``), which carries ``g1`` and ``g2``.
"""

from __future__ import annotations

import functools

from .. import params as PP
from ..device import resolve_device
from ..params._gen import curves_gen as CG, towers_gen as TG
from ..fields import towers as T
from .pairing_bls12 import Bls12Pairing
from .pairing_host import SW6_W1
from .pairing_mnt import MNTPairing
from .sw import SWCurveOps
from .twisted_edwards import TECurveOps


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
    """(Fq, Fq2, Fq6, Fq12) of BLS12-377."""
    return T.build_bls12_towers(PP.BLS12_377_FQ,
                                TG.BLS12_377_FQ2["nonresidue"],
                                TG.BLS12_377_FQ6["nonresidue"])


@functools.lru_cache()
def bls12_381_towers():
    """(Fq, Fq2, Fq6, Fq12) of BLS12-381."""
    return T.build_bls12_towers(PP.BLS12_381_FQ,
                                TG.BLS12_381_FQ2["nonresidue"],
                                TG.BLS12_381_FQ6["nonresidue"])


@functools.lru_cache()
def sw6_towers():
    """(Fq, Fq3, Fq6) of SW6: MNT6-shaped, 782 bits (49 digits)."""
    return T.build_mnt6_towers(PP.SW6_FQ, TG.SW6_FQ3["nonresidue"])


@functools.lru_cache()
def mnt6298_towers():
    """(Fq, Fq3, Fq6) of MNT6-298 (19 digits)."""
    return T.build_mnt6_towers(PP.MNT6298_FQ, TG.MNT6298_FQ3["nonresidue"])


@functools.lru_cache()
def _curve(family: str, group: str, device, ec_rns: bool = False
           ) -> SWCurveOps:
    towers, c, fr = {
        "mnt4753": (mnt4753_towers, CG.MNT4753, PP.MNT4753_FR),
        "mnt6753": (mnt6753_towers, CG.MNT6753, PP.MNT6753_FR),
        "bls12_377": (bls12_377_towers, CG.BLS12_377, PP.BLS12_377_FR),
        "bls12_381": (bls12_381_towers, CG.BLS12_381, PP.BLS12_381_FR),
        "sw6": (sw6_towers, CG.SW6, PP.SW6_FR),
        "mnt6298": (mnt6298_towers, CG.MNT6298, PP.MNT6298_FR),
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


def bls12_381_g1(device=None, ec_rns: bool = False) -> SWCurveOps:
    return _curve("bls12_381", "g1", resolve_device(device), ec_rns)


def bls12_381_g2(device=None) -> SWCurveOps:
    return _curve("bls12_381", "g2", resolve_device(device))


def sw6_g1(device=None, ec_rns: bool = False) -> SWCurveOps:
    """G1 of SW6, a = 5, over the 782-bit Fq."""
    return _curve("sw6", "g1", resolve_device(device), ec_rns)


def sw6_g2(device=None) -> SWCurveOps:
    """G2 of SW6, over Fq3."""
    return _curve("sw6", "g2", resolve_device(device))


def mnt6298_g1(device=None, ec_rns: bool = False) -> SWCurveOps:
    return _curve("mnt6298", "g1", resolve_device(device), ec_rns)


def mnt6298_g2(device=None) -> SWCurveOps:
    """G2 of MNT6-298, over Fq3."""
    return _curve("mnt6298", "g2", resolve_device(device))


def find_wnaf(n: int):
    """NAF of n, LSB first, the top digit (1) trimmed: the loop digits of a
    pairing whose constants give only the loop count (biginteger/mod.rs
    find_wnaf and the trimming of mnt4753/mod.rs:42)."""
    out = []
    while n > 0:
        if n & 1:
            z = 2 - (n % 4)
            n -= z
        else:
            z = 0
        out.append(z)
        n >>= 1
    if out[-1] != 1:
        raise ValueError("the NAF's top digit is not 1")
    return out[:-1]


# (curve constants, G1, G2, GT's tower, easy part: the Frobenius power and
# whether the (q + 1) factor follows)
_MNT = {
    "mnt4753": (CG.MNT4753, mnt4753_g1, mnt4753_g2, mnt4753_towers, 2, False),
    "mnt6753": (CG.MNT6753, mnt6753_g1, mnt6753_g2, mnt6753_towers, 3, True),
    "sw6": (CG.SW6, sw6_g1, sw6_g2, sw6_towers, 3, True),
    "mnt6298": (CG.MNT6298, mnt6298_g1, mnt6298_g2, mnt6298_towers, 3, True),
}


@functools.lru_cache()
def _mnt_pairing(family: str, device) -> MNTPairing:
    c, g1, g2, towers, easy_frob, q_plus_1 = _MNT[family]
    # SW6's W1 is not among the extracted constants (curves/sw6/mod.rs:
    # 227-239); SW6 and MNT6-298 give the loop count, not its digits
    w1 = SW6_W1 if family == "sw6" else c["final_exponent_last_chunk_1"]
    wnaf = c["wnaf"] if "wnaf" in c else find_wnaf(c["ate_loop_count"])
    return MNTPairing(
        family, g1(device), g2(device), towers()[2], wnaf=wnaf,
        ate_is_neg=c["ate_is_loop_count_neg"], w1=w1,
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


def sw6_pairing(device=None) -> MNTPairing:
    """SW6's ate pairing (curves/sw6/mod.rs:64-269): MNT6-shaped (Fq3
    twist, GT in Fq6, easy part (q^3 - 1)(q + 1), hard part w1 q + w0),
    over the 782-bit loop count of the reference's limbs in NAF form
    (``pairing_host.host_sw6_pairing`` says why 782 and not 388 bits)."""
    return _mnt_pairing("sw6", resolve_device(device))


def mnt6298_pairing(device=None) -> MNTPairing:
    """MNT6-298's ate pairing: GT in Fq6, as MNT6-753's."""
    return _mnt_pairing("mnt6298", resolve_device(device))


def sw6_engine(device=None) -> MNTPairing:
    """SW6's engine: its pairing, with ``g1`` and ``g2``."""
    return sw6_pairing(device)


def mnt6298_engine(device=None) -> MNTPairing:
    """MNT6-298's engine: its pairing, with ``g1`` and ``g2``."""
    return mnt6298_pairing(device)


# (curve constants, G1, G2, GT's tower, twist type)
_BLS12 = {
    "bls12_377": (CG.BLS12_377, bls12_377_g1, bls12_377_g2, bls12_377_towers,
                  "D"),
    "bls12_381": (CG.BLS12_381, bls12_381_g1, bls12_381_g2, bls12_381_towers,
                  "M"),
}


@functools.lru_cache()
def _bls12_pairing(family: str, device) -> Bls12Pairing:
    c, g1, g2, towers, twist = _BLS12[family]
    _, _, fq6, fq12 = towers()
    return Bls12Pairing(family, g1(device), g2(device), fq6, fq12, c["x"],
                        c["x_is_negative"], twist)


def bls12_377_pairing(device=None) -> Bls12Pairing:
    """BLS12-377's ate pairing: GT in Fq12, the D-twist, x > 0."""
    return _bls12_pairing("bls12_377", resolve_device(device))


def bls12_381_pairing(device=None) -> Bls12Pairing:
    """BLS12-381's ate pairing: GT in Fq12, the M-twist, x < 0."""
    return _bls12_pairing("bls12_381", resolve_device(device))


def bls12_377_engine(device=None) -> Bls12Pairing:
    """BLS12-377's engine: its pairing, with ``g1`` and ``g2``."""
    return bls12_377_pairing(device)


def bls12_381_engine(device=None) -> Bls12Pairing:
    """BLS12-381's engine: its pairing, with ``g1`` and ``g2``."""
    return bls12_381_pairing(device)


# (base field, scalar field, curve constants)
_TE = {
    "jubjub": (PP.JUBJUB_FQ, PP.JUBJUB_FR, CG.JUBJUB),
    "edwards_bls12": (PP.EDWARDS_BLS12_FQ, PP.EDWARDS_BLS12_FR,
                      CG.EDWARDS_BLS12),
    "edwards_sw6": (PP.EDWARDS_SW6_FQ, PP.EDWARDS_SW6_FR, CG.EDWARDS_SW6),
}


@functools.lru_cache()
def _te(name: str, device) -> TECurveOps:
    fq, fr, c = _TE[name]
    return TECurveOps(name, T.FpOps(fq), c["a"], c["d"],
                      generator_host=(c["g_x"], c["g_y"]),
                      cofactor=c["cofactor"], cofactor_inv=c["cofactor_inv"],
                      scalar_field=fr, mont_a=c["mont_a"],
                      mont_b=c["mont_b"], device=device)


def jubjub(device=None) -> TECurveOps:
    """Jubjub over BLS12-381 Fr (algebra/src/curves/jubjub/mod.rs)."""
    return _te("jubjub", resolve_device(device))


def edwards_bls12(device=None) -> TECurveOps:
    """The Edwards curve over BLS12-377 Fr (curves/edwards_bls12/mod.rs)."""
    return _te("edwards_bls12", resolve_device(device))


def edwards_sw6(device=None) -> TECurveOps:
    """The Edwards curve over SW6 Fr = BLS12-377 Fq
    (curves/edwards_sw6/mod.rs)."""
    return _te("edwards_sw6", resolve_device(device))
