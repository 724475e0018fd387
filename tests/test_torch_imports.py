"""The port stands alone and keeps its device rule.

* No module of ``gingerlib_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax``, ``gingerlib_tpu`` or anything outside the package by a relative
  import.  Checked on the syntax trees (what is in ``sys.modules`` says
  nothing: an interpreter start-up hook may have imported jax already).
* ``device=None`` means the GPU: on a machine without one, every entry point
  raises instead of running on the CPU.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "gingerlib_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "gingerlib_tpu", "flax", "optax"}

# the package, the smoke script, and the tests that run on a machine with a
# GPU, which need not have jax
SOURCES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu_kernels.py",
    ROOT / "tests" / "test_torch_cases.py"]


def imports_of(path: pathlib.Path):
    """(top-level module name or None, relative level, line) per import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], 0, node.lineno
        elif isinstance(node, ast.ImportFrom):
            top = node.module.split(".")[0] if node.module else None
            yield top, node.level, node.lineno


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"fp.py", "sw.py", "groth16.py", "chip_smoke.py", "ec_kernels.py",
            "msm.py", "convert.py", "poseidon.py", "poseidon_kernels.py",
            "poseidon_host.py", "merkle.py", "poseidon_gen.py",
            "merkle_gen.py", "rns.py", "rns_kernels.py", "ec_rns.py",
            "towers.py", "host_ext.py", "pairing_mnt.py", "pairing_host.py",
            "anchors_gen.py", "fft.py", "r1cs.py", "serialize.py",
            "gm17.py", "gm17_host.py", "boolean.py", "ext_fields.py",
            "groups.py", "pairing.py", "nizk.py", "circuits.py",
            "pairing_bls12.py", "twisted_edwards.py", "points.py",
            "pedersen.py", "commitment.py", "group_hash_host.py",
            "schnorr.py", "vrf.py", "signatures_host.py", "te_groups.py",
            "bowe_hopwood.py"} <= names
    # the BLS12 pairing and its gadget, both modules of that name; the
    # Pedersen, Schnorr and VRF primitives and their gadgets, and the
    # Poseidon primitive and gadget
    for name in ("pairing_bls12.py", "pedersen.py", "schnorr.py", "vrf.py",
                 "poseidon.py"):
        assert len([p for p in SOURCES if p.name == name]) == 2, name


# the public names of the MNT6-753 and GM17 slice, of the recursion's (the
# gadgets, the host Groth16, the bridge, the circuits), of the BLS12
# slice's, of the twisted-Edwards and signatures slice's and of the SW6
# and MNT6-298 slice's, module by module
PUBLIC = {
    "curves.twisted_edwards": ["TECurveOps", "products"],
    "curves.points": ["lanes", "stack", "unstack", "mul_ints",
                      "affine_ints", "affine_host"],
    "curves.instances#te": ["jubjub", "edwards_bls12", "edwards_sw6"],
    "curves.sw#te": ["SWCurveOps"],
    "primitives.pedersen": ["PedersenWindow", "PedersenCRH",
                            "BoweHopwoodCRH", "tree_sum"],
    "primitives.commitment": ["PedersenCommitment", "TECompressor",
                              "PedersenCRHCompressor"],
    "primitives.group_hash_host": ["BoweHopwoodHost",
                                   "mnt6753_g1_group_hash"],
    "primitives.schnorr": ["SchnorrSignature", "FieldBasedSchnorr"],
    "primitives.vrf": ["EcVrfProof", "FieldBasedEcVrf",
                       "in_prime_subgroup"],
    "primitives.signatures_host": ["HostSchnorr", "HostVrf"],
    "gadgets.std.te_groups": ["TEPointG", "TEGroupGadget"],
    "gadgets.crypto.pedersen": ["bytes_to_bit_gadgets", "PedersenCRHGadget",
                                "PedersenCommitmentGadget",
                                "PedersenCRHCompressorGadget"],
    "gadgets.crypto.bowe_hopwood": ["BoweHopwoodGadget"],
    "gadgets.crypto.poseidon": ["PoseidonGadget"],
    "gadgets.crypto.schnorr": ["SchnorrVerificationGadget",
                               "mnt4753_schnorr_gadget"],
    "gadgets.crypto.vrf": ["EcVrfVerificationGadget", "mnt4753_vrf_gadget"],
    "gadgets.crypto#te": ["PoseidonGadget"],
    "utils.convert#te": ["pedersen_crh_from_numpy", "bowe_hopwood_from_numpy",
                         "pedersen_commitment_from_numpy"],
    "circuits#te": ["schnorr_verification_circuit",
                    "pedersen_commitment_circuit"],
    "curves.instances#odd": ["sw6_towers", "mnt6298_towers", "sw6_g1",
                             "sw6_g2", "mnt6298_g1", "mnt6298_g2",
                             "find_wnaf", "sw6_pairing", "mnt6298_pairing",
                             "sw6_engine", "mnt6298_engine"],
    "curves.pairing_host#odd": ["SW6_W1", "host_sw6_pairing",
                                "host_mnt6298_pairing"],
    "proofs.groth16_host#odd": ["host_groth16_sw6", "host_groth16_mnt6298"],
    "proofs.gm17_host#odd": ["host_gm17_mnt6298"],
    "fields.fp#odd": ["KERNEL_DIGITS", "POW_DIGITS", "launch_digits",
                      "count_launch"],
    "curves.pairing_bls12": ["Bls12Pairing"],
    "fields.towers#bls12": ["build_bls12_towers"],
    "fields.host_ext#bls12": ["frob_table_fp6_3over2", "frob_table_fp12",
                              "build_bls12_host_towers"],
    "curves.instances#bls12": ["bls12_377_towers", "bls12_381_towers",
                               "bls12_381_g1", "bls12_381_g2",
                               "bls12_377_pairing", "bls12_381_pairing",
                               "bls12_377_engine", "bls12_381_engine"],
    "curves.pairing_host#bls12": ["HostBls12Pairing",
                                  "host_bls12_377_pairing",
                                  "host_bls12_381_pairing"],
    "proofs.groth16": ["accumulate_inputs", "verify_proof"],
    "proofs.groth16_host#bls12": ["host_groth16_bls12_377",
                                  "host_groth16_bls12_381"],
    "gadgets.std.ext_fields#bls12": ["build_bls12_tower_gadgets"],
    "gadgets.std.pairing_bls12": ["Bls12PairingGadget",
                                  "bls12_377_pairing_gadget",
                                  "bls12_381_pairing_gadget"],
    "gadgets.crypto#bls12": ["bls12_377_verifier_gadget"],
    "fields.towers": ["CubicExtOps", "QuadExtOps", "build_mnt6_towers",
                      "ext_pow_const", "ext_cyclotomic_pow_const",
                      "ext_batch_inverse_tree"],
    "fields.host_ext": ["cubic_mul", "cubic_inv", "cubic_pow", "ext_ops",
                        "frob_table_fp3", "frob_table_fp6_2over3",
                        "build_mnt6_host_towers", "HostTower"],
    "curves.instances": ["mnt6753_towers", "mnt6753_g1", "mnt6753_g2",
                         "mnt6753_pairing", "mnt6753_engine"],
    "curves.pairing_host": ["host_mnt6753_pairing"],
    "proofs.gm17": ["GM17VerifyingKey", "GM17Parameters", "GM17Proof",
                    "sap_size", "sap_at_device", "generate_parameters",
                    "sap_domain", "sap_witness_map", "create_proof",
                    "verify_proof", "compile_circuit"],
    "proofs.gm17_host": ["HostGM17", "HostGM17Params", "host_gm17_mnt4753",
                         "host_gm17_mnt6753", "expected_gm17_proof",
                         "sap_at", "sap_domain", "sap_full_assignment"],
    "utils.convert": ["gm17_params_from_numpy", "groth16_vk_to_host",
                      "gm17_vk_to_host", "proof_to_host"],
    "gadgets.std": ["Boolean", "FpG"],
    "gadgets.std.boolean": ["Boolean"],
    "gadgets.std.fp": ["FpG"],
    "gadgets.std.ext_fields": ["FpGOps", "QuadExtG", "CubicExtG",
                               "build_mnt4_tower_gadgets",
                               "build_mnt6_tower_gadgets"],
    "gadgets.std.groups": ["AffinePointG", "SWGroupGadget"],
    "gadgets.std.pairing": ["MNTPairingGadget", "mnt4753_pairing_gadget",
                            "mnt6753_pairing_gadget"],
    "gadgets.crypto": ["Groth16VerifierGadget", "Gm17VerifierGadget",
                       "mnt4753_verifier_gadget", "mnt6753_verifier_gadget",
                       "mnt4753_gm17_verifier_gadget",
                       "mnt6753_gm17_verifier_gadget"],
    "gadgets.crypto.nizk": ["Groth16VerifierGadget", "Gm17VerifierGadget",
                            "mnt4753_verifier_gadget",
                            "mnt6753_verifier_gadget",
                            "mnt4753_gm17_verifier_gadget",
                            "mnt6753_gm17_verifier_gadget"],
    "proofs.groth16_host": ["HostParams", "HostGroth16",
                            "host_groth16_mnt4753", "host_groth16_mnt6753",
                            "expected_proof"],
    "circuits": ["benchmark_circuit", "mul_circuit",
                 "groth16_verifier_circuit"],
}


@pytest.mark.parametrize("module", sorted(PUBLIC))
def test_public_names(module):
    import importlib
    mod = importlib.import_module(
        f"gingerlib_tpu_torch.{module.split('#')[0]}")
    missing = [n for n in PUBLIC[module] if not hasattr(mod, n)]
    assert not missing, f"{module} lacks {missing}"


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_import_of_jax_or_the_jax_package(path):
    depth = len(path.relative_to(ROOT).parts) - 1   # packages above the file
    for top, level, line in imports_of(path):
        if level == 0:
            assert top not in FORBIDDEN, f"{path}:{line} imports {top}"
        else:
            # a relative import may climb to the package root, not past it
            assert path.is_relative_to(PKG) and level <= depth, \
                f"{path}:{line} leaves the package"


def _cpu_case():
    from gingerlib_tpu_torch import params as TP
    from gingerlib_tpu_torch.circuits import benchmark_circuit
    from gingerlib_tpu_torch.curves import instances as CI
    cs, _ = benchmark_circuit(TP.BLS12_377_FR, 1, 1)
    return CI.bls12_377_engine("cpu"), cs


ENTRY_POINTS = ["compile_r1cs", "Domain", "mnt4753_g1", "mnt4753_g2",
                "bls12_377_g1", "mnt4753_engine", "mnt4753_pairing",
                "generate_parameters",
                "create_proof", "params_from_numpy", "compiled_from_numpy",
                "points_from_numpy", "PoseidonParams", "PoseidonHash",
                "FieldBasedMerkleTree", "poseidon_params_from_numpy",
                "mnt4753_g1(ec_rns=True)", "bls12_377_g1(ec_rns=True)",
                "rns.to_rns", "rns_from_numpy", "MixedRadixDomain",
                "best_domain", "qap_at_device", "fp_from_bytes",
                "ext_from_bytes", "affine_from_bytes", "proof_from_bytes",
                "vk_from_bytes", "params_from_bytes", "mnt6753_g1",
                "mnt6753_g2", "mnt6753_engine", "mnt6753_pairing",
                "gm17.generate_parameters", "gm17.create_proof",
                "gm17.sap_at_device", "gm17_params_from_numpy",
                "gm17.compile_circuit", "bls12_381_g1", "bls12_381_g2",
                "bls12_377_pairing", "bls12_381_pairing",
                "bls12_377_engine", "bls12_381_engine", "jubjub",
                "edwards_bls12", "edwards_sw6"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_device_none_raises_without_a_gpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gingerlib_tpu_torch import params as TP
    from gingerlib_tpu_torch.curves import instances as CI
    from gingerlib_tpu_torch.ops.fft import (Domain, MixedRadixDomain,
                                             best_domain)
    from gingerlib_tpu_torch.primitives.merkle import FieldBasedMerkleTree
    from gingerlib_tpu_torch.primitives.poseidon import (PoseidonHash,
                                                         PoseidonParams)
    from gingerlib_tpu_torch.ops import rns
    from gingerlib_tpu_torch.proofs import gm17, groth16
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
    from gingerlib_tpu_torch.utils import convert, serialize
    eng, cs = _cpu_case()
    mnt = CI.mnt4753_engine("cpu")
    toxic = dict(alpha=2, beta=3, gamma=5, delta=7, t=11)
    calls = {
        "compile_r1cs": lambda: compile_r1cs(cs),
        "Domain": lambda: Domain(TP.BLS12_377_FR, 8),
        "mnt4753_g1": CI.mnt4753_g1,
        "mnt4753_g2": CI.mnt4753_g2,
        "bls12_377_g1": CI.bls12_377_g1,
        "mnt4753_engine": CI.mnt4753_engine,
        "mnt4753_pairing": CI.mnt4753_pairing,
        "generate_parameters":
            lambda: groth16.generate_parameters(eng, cs, **toxic),
        # params and compiled are not reached: the device is resolved first
        "create_proof": lambda: groth16.create_proof(
            eng, None, compile_r1cs(cs, device="cpu"), cs.assignment(),
            r=1, s=2),
        "params_from_numpy": lambda: convert.params_from_numpy(eng, None),
        "compiled_from_numpy":
            lambda: convert.compiled_from_numpy(TP.BLS12_377_FR, None),
        "points_from_numpy": lambda: convert.points_from_numpy(()),
        "PoseidonParams": PoseidonParams.mnt4753,
        # the parameters are on the CPU; the hash and the tree are asked
        # for without a device
        "PoseidonHash": lambda: PoseidonHash(PoseidonParams.mnt4753("cpu")),
        "FieldBasedMerkleTree": lambda: FieldBasedMerkleTree(
            PoseidonHash(PoseidonParams.mnt4753("cpu"), device="cpu"), 4),
        "poseidon_params_from_numpy":
            lambda: convert.poseidon_params_from_numpy(None),
        "mnt4753_g1(ec_rns=True)": lambda: CI.mnt4753_g1(ec_rns=True),
        "bls12_377_g1(ec_rns=True)": lambda: CI.bls12_377_g1(ec_rns=True),
        "rns.to_rns": lambda: rns.to_rns(
            rns.make_context(TP.BLS12_377_FQ.modulus), [1, 2]),
        "rns_from_numpy": lambda: convert.rns_from_numpy(
            np.zeros((128, 2), np.uint32)),
        "MixedRadixDomain": lambda: MixedRadixDomain(TP.MNT6753_FR, 10),
        "best_domain": lambda: best_domain(TP.BLS12_377_FR, 8),
        "qap_at_device": lambda: groth16.qap_at_device(cs, 11),
        # the bytes are not read: the device is resolved first
        "fp_from_bytes": lambda: serialize.fp_from_bytes(
            TP.MNT4753_FQ, b""),
        "ext_from_bytes": lambda: serialize.ext_from_bytes(mnt.fqk, b""),
        "affine_from_bytes": lambda: serialize.affine_from_bytes(
            mnt.g1, b""),
        "proof_from_bytes": lambda: serialize.proof_from_bytes(mnt, b""),
        "vk_from_bytes": lambda: serialize.vk_from_bytes(mnt, b""),
        "params_from_bytes": lambda: serialize.params_from_bytes(mnt, b""),
        "mnt6753_g1": CI.mnt6753_g1,
        "mnt6753_g2": CI.mnt6753_g2,
        "mnt6753_engine": CI.mnt6753_engine,
        "mnt6753_pairing": CI.mnt6753_pairing,
        "gm17.generate_parameters": lambda: gm17.generate_parameters(
            eng, cs, alpha=2, beta=3, t=11),
        # params and compiled are not reached: the device is resolved first
        "gm17.create_proof": lambda: gm17.create_proof(
            eng, None, gm17.compile_circuit(cs, device="cpu"),
            cs.assignment(),
            d1=1, d2=2, r=3),
        "gm17.sap_at_device": lambda: gm17.sap_at_device(cs, 11),
        "gm17_params_from_numpy":
            lambda: convert.gm17_params_from_numpy(eng, None),
        "gm17.compile_circuit": lambda: gm17.compile_circuit(cs),
        "bls12_381_g1": CI.bls12_381_g1,
        "bls12_381_g2": CI.bls12_381_g2,
        "bls12_377_pairing": CI.bls12_377_pairing,
        "bls12_381_pairing": CI.bls12_381_pairing,
        "bls12_377_engine": CI.bls12_377_engine,
        "bls12_381_engine": CI.bls12_381_engine,
        "jubjub": CI.jubjub,
        "edwards_bls12": CI.edwards_bls12,
        "edwards_sw6": CI.edwards_sw6,
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_engine_on_another_device_is_refused():
    from gingerlib_tpu_torch.proofs import groth16
    eng, cs = _cpu_case()
    with pytest.raises(ValueError, match="requested device"):
        groth16.generate_parameters(eng, cs, alpha=2, beta=3, gamma=5,
                                    delta=7, t=11, device="meta")
