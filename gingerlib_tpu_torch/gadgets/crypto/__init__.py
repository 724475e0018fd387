from .nizk import (Gm17VerifierGadget, Groth16VerifierGadget,  # noqa: F401
                   bls12_377_verifier_gadget,
                   mnt4753_gm17_verifier_gadget, mnt4753_verifier_gadget,
                   mnt6753_gm17_verifier_gadget, mnt6753_verifier_gadget)
from .poseidon import PoseidonGadget  # noqa: F401
