"""Concrete field parameter registry of the port.

The raw integers in ``_gen/`` are the port's own copy of the constants
extracted from the ginger-lib sources; everything derived (Montgomery
constants for the 16-bit digit layout, twiddles) is computed from them.

The MNT cycle is cross-wired: MNT4753_FR is MNT6753_FQ and vice versa.
"""

from ..fields.fp import FpParams
from ._gen import fields_gen as _F

_CACHE = {}


def _mk(name: str, d: dict) -> FpParams:
    if name not in _CACHE:
        _CACHE[name] = FpParams(
            name=name,
            modulus=d["modulus"],
            generator=d["generator"],
            two_adicity=d["two_adicity"],
            root_of_unity=d["root_of_unity"],
        )
    return _CACHE[name]


MNT4753_FQ = _mk("mnt4753_fq", _F.MNT4753_FQ)
MNT6753_FQ = _mk("mnt6753_fq", _F.MNT6753_FQ)
MNT4753_FR = MNT6753_FQ  # cycle wiring
MNT6753_FR = MNT4753_FQ

BLS12_377_FQ = _mk("bls12_377_fq", _F.BLS12_377_FQ)
BLS12_377_FR = _mk("bls12_377_fr", _F.BLS12_377_FR)
BLS12_381_FQ = _mk("bls12_381_fq", _F.BLS12_381_FQ)
JUBJUB_FQ = _mk("jubjub_fq", _F.JUBJUB_FQ)
BLS12_381_FR = JUBJUB_FQ
JUBJUB_FR = _mk("jubjub_fr", _F.JUBJUB_FR)
SW6_FQ = _mk("sw6_fq", _F.SW6_FQ)
SW6_FR = BLS12_377_FQ
MNT6298_FQ = _mk("mnt6298_fq", _F.MNT6298_FQ)
MNT6298_FR = _mk("mnt6298_fr", _F.MNT6298_FR)
EDWARDS_BLS12_FQ = BLS12_377_FR
EDWARDS_BLS12_FR = _mk("edwards_bls12_fr", _F.EDWARDS_BLS12_FR)
EDWARDS_SW6_FQ = SW6_FR
EDWARDS_SW6_FR = _mk("edwards_sw6_fr", _F.EDWARDS_SW6_FR)

ALL_FIELDS = {
    p.name: p for p in (
        MNT4753_FQ, MNT6753_FQ, BLS12_377_FQ, BLS12_377_FR, BLS12_381_FQ,
        JUBJUB_FQ, JUBJUB_FR, SW6_FQ, MNT6298_FQ, MNT6298_FR,
        EDWARDS_BLS12_FR, EDWARDS_SW6_FR,
    )
}
