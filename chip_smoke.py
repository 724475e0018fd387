#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--time-plain-addsub]

What it does, in order (any failure raises, so the exit code is non-zero):

1. requires a CUDA device, prints its name and power limit, and builds the
   CUDA kernels of ``gingerlib_tpu_torch/csrc`` from source;
2. holds every kernel against its plain PyTorch version on the device, at the
   shapes each path below gives it, with exact equality (integer
   arithmetic: tolerance 0), and times both with CUDA events: the field
   kernels (multiply, add/sub/neg, inverse) at the 2^10 rung's shapes and at
   the 2^16 rung's (2^17-row FFT passes, batches of setup's 327,697 G1 and
   65,544 G2 scalars), the inverse also on 2^15 elements and, against
   python's pow too, on the inputs of its host test at 48, 24 and 16 digits
   (2^k for every k, runs of ones, those that take the most passes or
   negate a row), and the curve kernels (projective
   addition, affine addition before and after its shared inversion, and
   the inversion's three kernels: up, tail and down) on real curve points
   with every special lane mixed in, at 2^15, 2^18 and 2^19 lanes, the
   inversion also at the edges of its tiles, and the RNS kernels (the RNS multiply at
   MNT4-753 Fq [1] and [2^16] and BLS12-377 Fq [2^12], around its tile of 16
   (1, 15, 16, 17, 127, 128, 129 elements) and at 2^15, 2^18 and 2^19, with
   rows of every residue at m_i - 1, strided and broadcast operands and the
   inversion tree's paired down-sweep, six chained squarings against
   python's pow, times at 1, 2^16 and 2^20 lanes beside the positional
   multiply; the RNS affine addition's pre and post kernels and its K7 tree
   at the same widths of MNT4-753 G1 lanes and at 2^16, against their plain
   versions and the positional addition; each with its bound beside the
   bound as PR 4-8 counted it, the extensions on the CUDA cores);
3. holds the Pippenger MSMs (``msm_hybrid`` on G1 at two cutoffs,
   ``msm_affine`` on G2, ``msm_affine`` over RNS G1) against ``msm_naive``
   at 2^12 points, and times one 2^16-point MSM of each (``msm`` line; G1
   at three cutoffs); drives the RNS path -- ``msm_affine`` over MNT4-753
   G1 built with ``ec_rns=True`` at 2^16 points, launches counted (K7's
   must be 9,909: each addition's tree levels up and down and its root)
   and by width, against ``msm_hybrid`` and the closed form, the
   positional ``msm_affine`` beside it (``ec_rns`` line), and K7, pre and
   post at the widths it launched them (``ec_rns_by_width`` line: time,
   bound and loss by class of widths); then the pow
   chain at [1, 48] and [4096, 48] (Legendre and square-root exponents of
   MNT4-753 Fq and Fr, a short one; the launcher's window must be
   ``fp.pow_window``'s, and the bound counts that window's chain, the
   binary ladder's beside it as ``bound_ms_before``) and the Poseidon
   permutation on the zero state and on 2^15 seeded sponges with special
   lanes, both parameter sets, with the sponges a block (S) its launcher
   took, which must be ``poseidon_kernels.block_sponges``'s;
4. drives the port's paths through their public entry points: Groth16 over
   MNT4-753 on the chained-multiplication benchmark circuit at 2^10 and
   2^16 constraints (4 inputs): ``compile_r1cs`` -> ``generate_parameters``
   (the QAP at the toxic point on the device, every query and
   single element through a windowed table of the generator, w = 8, built
   anew at each rung; its verifying key's GT element by one prepared
   pairing; seconds and launches by phase: ``setup_phases_s``) ->
   ``create_proof`` with pinned toxic waste and blinding (below 2^12
   points an MSM is a double-and-add loop; the 2^16 rung goes through the
   Pippenger paths and the curve kernels) -> ``verify_proof`` twice a rung
   (the input accumulation, three host ladders, one prepared Miller loop
   over the three pairs, one final exponentiation; first and steady
   seconds, launches by kind, and at 2^10 the seconds by phase: ``verify``
   line); the proof and the vk through bytes and back at every rung, the
   2^10 parameters too (``serialization`` line); at 2^10 the windowed
   queries against the 768-step loop ``fixed_base_msm``; the 2^20 FFT over
   MNT4-753 Fr and the mixed-radix FFT over MNT6-753 Fr at the size
   ``best_domain`` takes for 2^17 (``fft``, ``fft_mixed`` lines: the tables
   built on the device beside python ints, seconds, launches); one pairing
   of the reference's anchor points; ``legendre`` and
   ``sqrt_mod`` on
   2^12 elements of MNT4-753 Fr and Fq; and a 2^16-leaf MNT4-753 Poseidon
   Merkle tree of height 17 (``merkle`` line: one K9 launch a level, 16,
   and 32 additions, asserted), then K9 at each of the tree's level widths
   (``poseidon_by_width`` line: S, device time, bound and loss a width);
   after the 2^16 rung, the
   inversion tree's three kernels and the affine addition's two at the
   widths that rung launched them (``inv_tree_by_width`` and
   ``ec_affine_by_width`` lines: time and loss by class of widths), and all
   five at the widest batch it launched, the windowed query's first level
   (``ec_affine_at_widest``); then MNT6-753 (G1 with a = 11, G2 over Fq3,
   GT in Fq6): the pairing of the reference's MNT6-753 anchor points with
   the seconds and launches of its host ladder, Miller loop and final
   exponentiation, and the launches of one multiply in each tower
   (``pairing_mnt6``); Groth16 over MNT6-753 at 32,763
   constraints (5 inputs: the 2^15 domain, the largest radix-2 one) through
   the same rung, verify and serialization steps (lines tagged "family":
   "mnt6753"); GM17 over MNT4-753 at 2^10 (SAP domain 4,096, radix 2) and
   over MNT6-753 at 2^14 (SAP size 32,777: the mixed domain of 40,960)
   with setup, prove and verify seconds, phases and launches (``gm17``
   lines); one step of recursion (``recursion`` line): an MNT4-753
   Groth16 proof of 7 * 11 = 77 made on the card, its vk and proof brought
   to the host (``utils.convert``), the 61,407-constraint verifier circuit
   built by the gadgets with the statement's 753 bits as public inputs and
   checked on the host, and that circuit's GM17 proof over MNT6-753 on the
   mixed domain of 163,840 points (setup, prove and verify with phases,
   launches, curve widths and peak memory), then K1 and add/sub/neg at
   the widest layout of each class of its setup
   (``field_kernels_at_setup_recursion``); and K4, K5 and K6 on MNT6-753
   G1 against their plain versions at the widest batch the MNT6 paths and
   the recursion launched each, then on MNT4-753 and MNT6-753 G1 in turns
   (``mnt6_curve_kernels``); then BLS12-377 and BLS12-381 (GT in Fq12 over
   Fq6 over Fq2; the D- and the M-twist): on each, the pairing of the
   generators and of (2P, 3Q) against ``HostBls12Pairing``, e(3P, 5Q) =
   e(P, Q)^15 and GT^r = 1 on the card, the seconds and launches of the
   line coefficients, the Miller loop and the final exponentiation, and
   the launches of one product in Fq2, Fq6 and Fq12, of a cyclotomic
   square and of an f * line (``pairing_bls12`` lines); Groth16 over
   BLS12-381 at 2^16 constraints through the same rung and verify steps
   as MNT4-753's (lines tagged "family": "bls12_381"); GM17 over both
   curves at 2^10; the BLS12-377 recursion (``recursion_bls12``): an
   inner proof of 7 * 11 = 77 made and verified on the card, equal to
   ``HostGroth16``'s, and its 42,006-constraint verifier circuit built and
   checked on the host (its outer proof over SW6 follows below); and K1,
   K2, add/sub/neg, K4, K5 and K6 at 24 digits against their plain
   versions at the BLS12-381 rung's and the pairings' widest layouts and
   widths (``bls12_curve_kernels``, ``field_kernels_at_bls12``; rows
   ``*_d24`` of the kernels line); then SW6 and MNT6-298, whose fields
   have an odd digit count (49 and 19): K1 and add/sub/neg on every pair
   of 0, 1, 2, p - 1, p - 2, (p - 1)/2 and seeded values, on halves and
   rows, K1 with one operand up to R - 1, K2 on its host test's inputs
   against pow, K6 at the edges of its tiles
   (``field_kernels_at_odd_widths``); on each curve the pairing of the
   generators against the python-int oracle (on SW6 also the pinned GT
   of the reference's 782-bit loop), e(3P, 5Q) = e(P, Q)^15 and GT^r = 1,
   with the seconds and launches of its phases (``pairing_odd``);
   Groth16 over MNT6-298 at 2^10 through the same rung, verify and
   serialization steps, and the golden bytes of the proof A = [2]G1,
   B = G2, C = G1; GM17 over MNT6-298 at 2^10; the BLS12-377 recursion's
   outer Groth16 proof over SW6 of the 42,006-constraint verifier circuit
   above (254 inputs, the domain 2^16 over SW6 Fr = BLS12-377 Fq: the
   section's main path: a ``rung`` line tagged "sw6" and the
   ``recursion_bls12`` line's ``outer_sw6``), whose launch counts by digit
   count must show K1, add/sub, K2 and K4-K6 at 49 digits; and K1, K2,
   add/sub/neg and K4-K6 at 19 and 49 digits against their plain versions
   at the widest layouts and widths of the MNT6-298 paths and of the
   outer proof (``odd_curve_kernels``; rows ``*_d19`` and ``*_d49`` of the
   kernels line); then the twisted-Edwards curves, on
   each of Jubjub, Edwards-BLS12 and Edwards-SW6 the generator on the
   curve, the group laws on 2^10 seeded points and one full-width scalar
   multiply with its seconds and launches (``twisted_edwards`` lines);
   Pedersen over Edwards-BLS12 at the window of the reference's benches,
   250 x 8: the commitment's setup, a 250-byte evaluate, a commit and the
   compressor, and the Bowe-Hopwood group hash of the VRF over MNT6-753 G1
   set up on the card (``pedersen``); Schnorr keygen, sign, verify and
   keyverify and the VRF's keygen, prove and proof_to_hash over MNT6-753
   G1 with MNT4-753-Fr Poseidon, each call's seconds, launches and the
   rejection loops' tries (``signatures``); Groth16 over MNT4-753 of the
   19,292-constraint Schnorr verification circuit of that signature and
   over BLS12-377 of the opening of that commitment (12,387 constraints),
   setup, prove and verify by phase (``rung`` lines with ``"circuit"``);
   and K1, add/sub/neg and K2 at 16 digits at the widest layouts of the
   16-digit lines (``field_kernels_at_te``; rows ``*_d16`` of the
   kernels line);
5. checks the results: each device proof equals the closed-form python-int
   oracle coordinate for coordinate, a repeat gives the same proof (over
   MNT4-753 at 2^10 and 2^16), a proof with another ``s`` differs; setup's device QAP equals ``qap_at`` (every
   a_i, b_i, c_i, Z(t) and m); the windowed queries equal the loop's
   points; proof bytes equal those written from the oracle's coordinates,
   the decoded proof verifies under the decoded vk, and the decoded 2^10
   parameters prove the same proof; ``ifft(fft(x)) == x`` digit for digit
   and 8 sampled outputs equal Horner's rule in python ints (one forked
   process a sample); ``verify_proof`` accepts every rung's proof
   and the one with another ``s``, and refuses the 2^10 proof with its
   first input plus one and with C + G1's generator; ``alpha_g1_beta_g2``
   equals the python-int oracle's e(alpha*G1, beta*G2), and the anchor
   pairing the reference's GT (over MNT6-753 too, whose proofs equal the
   oracle and verify, a wrong input and an altered C refused, a circuit
   one constraint past the 2^15 domain refused; the GM17 proofs equal the
   closed-form oracle ``expected_gm17_proof``, verify, and a wrong input is
   refused); the recursion's inner vk and proof equal ``HostGroth16``'s,
   verify, and the input 78 is refused; its circuit has 61,407
   constraints and 754 inputs and is satisfied; its outer proof equals
   ``expected_gm17_proof``, its SAP at t ``sap_at``, and verify accepts the
   bits of 77 and refuses those of 78 and C + G1's generator; the Legendre
   symbols, roots
   and masks agree with python ints; the tree equals the one the plain
   permutation builds on the device, sixteen sampled paths verify and hash
   to its root in python ints, a wrong leaf is refused, a 2^10-leaf tree
   equals the python-int tree node for node, and the phantom root holds;
   the field API launches K3 once a call (4); the twisted-Edwards group
   laws hold and [k] G and four seeded points equal python ints (the TE
   gadget's host helpers), [r] G = 0 on all three curves; the Pedersen
   generators, hash, commitment and x, and a short input's Bowe-Hopwood
   hash, equal python ints and ``BoweHopwoodHost``; Schnorr's (pk, e, s)
   equal ``HostSchnorr``'s, verify accepts and refuses message + 1,
   keyverify accepts; the VRF's (gamma, c, s) and output equal
   ``HostVrf``'s and a wrong message is refused; both circuits' proofs
   equal the closed form, their QAPs ``qap_at``, and verify accepts them
   and refuses a wrong public input and an altered C; the MNT6-298
   pairing equals its oracle and the SW6 pairing its oracle and the pinned
   GT; the MNT6-298 Groth16 and GM17 proofs equal their closed forms,
   verify, and a wrong input and an altered C are refused, and the golden
   proof bytes are written from their points and read back; the SW6
   outer proof equals ``expected_proof("sw6", ...)``, its QAP ``qap_at``,
   and verify accepts the bits of 77 and refuses those of 78 and C + G1's
   generator; and the launch
   counters, set
   to zero before each path, show that every kernel was launched on the path
   that reaches it (K7 and K8 on the RNS path), and K1 and K2 on the
   verifier's, and K1, K2, add/sub and K4-K6 on the MNT6-753 2^15 rung,
   both GM17 rungs and the recursion, and at 49 digits on the SW6 outer
   proof;
6. prints the card's name and power limit, the kernel table as one JSON
   line, and as the last line
   ``{"ok": true, "device": {...}}``.

Nothing here runs on the CPU except the python-int oracles.

``--time-plain-addsub`` adds one measurement (minutes long) before the last
lines: setup and prove at 2^6 constraints with the modular add, subtract and
negate kernels swapped for their plain PyTorch versions, beside the same
with the kernels, and a check that both give the same proof.
"""

import argparse
import ctypes
import json
import math
import multiprocessing
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

TOXIC = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)
R_BLIND, S_BLIND = 31337, 71717
NUM_INPUTS = 4
# K7 launches of msm_affine over MNT4-753 G1 at 2^16 points (c = 11, 69
# windows in 9 chunks: 405 additions, sum L = 4,752 tree levels): L up, one
# at the root, L down, one launch each
RNS_PATH_K7_LAUNCHES = 9909

# Peak rates of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM, and
# 67 TFLOP/s float32 outside the tensor cores, i.e. 33.5e12 fused
# multiply-adds a second.  32-bit integer multiply-adds run at half the
# float32 rate, and one 32x32->64-bit multiply-add is two of them (low and
# high word), so integer work is counted in 32-bit integer operations
# against 16.75e12 a second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 2 / 2
# dense int8 tensor-core rate (a multiply-add is two operations); the RNS
# kernels run their inner products there, as u8 x u8 products
PEAK_INT8_OPS_PER_S = 1.979e15


# the polynomial whose samples the forked Horner workers evaluate:
# (coefficients, modulus), set in the parent before the fork
_HORNER = {}


def _horner_at(point):
    """x(point) by Horner's rule in python ints, x = _HORNER's."""
    coeffs, q = _HORNER["coeffs"], _HORNER["modulus"]
    acc = 0
    for cf in reversed(coeffs):
        acc = (acc * point + cf) % q
    return acc


def _oracle_child(fn, send):
    """fn() in a forked process: sends (result, seconds, error)."""
    t = time.perf_counter()
    try:
        out = (fn(), time.perf_counter() - t, None)
    except BaseException as e:      # the parent raises it
        out = (None, 0.0, repr(e))
    send.send(out)
    send.close()


class HostOracle:
    """fn() -- python ints only, nothing of CUDA -- computed in a forked
    process while this one drives the card; ``get()`` waits for it and
    returns (fn(), its seconds).  The process is a daemon: it ends with
    the script."""

    def __init__(self, fn):
        ctx = multiprocessing.get_context("fork")
        self.recv, send = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_oracle_child, args=(fn, send),
                                daemon=True)
        self.proc.start()
        send.close()

    def get(self):
        try:
            val, secs, err = self.recv.recv()
        finally:
            self.proc.join()
        if err is not None:
            raise AssertionError(f"host oracle failed: {err}")
        return val, secs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time-plain-addsub", action="store_true",
                    help="also time setup and prove with plain PyTorch "
                         "add/sub/neg instead of their kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    from gingerlib_tpu_torch import params as PP
    from gingerlib_tpu_torch.circuits import (benchmark_circuit,
                                              groth16_verifier_circuit,
                                              mul_circuit,
                                              pedersen_commitment_circuit,
                                              schnorr_verification_circuit)
    from gingerlib_tpu_torch.curves import instances as CI
    from gingerlib_tpu_torch.curves.points import affine_ints, mul_ints
    from gingerlib_tpu_torch.curves import pairing_host
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.fields import host_ext as HE
    from gingerlib_tpu_torch.fields import towers as T
    from gingerlib_tpu_torch.ops import cuda_lib, ec_kernels, limbs, rns
    from gingerlib_tpu_torch.ops import fft as fft_mod
    from gingerlib_tpu_torch.ops import ec_rns as ER
    from gingerlib_tpu_torch.ops import rns_kernels as RK
    from gingerlib_tpu_torch.ops import msm as msm_mod
    from gingerlib_tpu_torch.ops import poseidon_kernels as PK
    from gingerlib_tpu_torch.params._gen import poseidon_gen
    from gingerlib_tpu_torch.params._gen import towers_gen as TG
    from gingerlib_tpu_torch.params._gen.merkle_gen import \
        MNT4753_PHANTOM_MERKLE_ROOT
    from gingerlib_tpu_torch.gadgets.std.te_groups import TEGroupGadget
    from gingerlib_tpu_torch.primitives import pedersen as ped_mod
    from gingerlib_tpu_torch.primitives.commitment import (
        PedersenCommitment, PedersenCRHCompressor)
    from gingerlib_tpu_torch.primitives.group_hash_host import \
        mnt6753_g1_group_hash
    from gingerlib_tpu_torch.primitives.merkle import FieldBasedMerkleTree
    from gingerlib_tpu_torch.primitives.pedersen import (BoweHopwoodCRH,
                                                         PedersenWindow)
    from gingerlib_tpu_torch.primitives.schnorr import FieldBasedSchnorr
    from gingerlib_tpu_torch.primitives.signatures_host import (HostSchnorr,
                                                                HostVrf)
    from gingerlib_tpu_torch.primitives.vrf import FieldBasedEcVrf
    from gingerlib_tpu_torch.primitives.poseidon import (PoseidonHash,
                                                         PoseidonParams)
    from gingerlib_tpu_torch.primitives.poseidon_host import PoseidonHost
    from gingerlib_tpu_torch.proofs import gm17, gm17_host, groth16, \
        groth16_host
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
    from gingerlib_tpu_torch.utils import convert, serialize
    from gingerlib_tpu_torch.utils.timing import graph_ms
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.join(root, "tests"), os.path.join(root, "tools")]
    import divsteps_model
    from test_torch_cases import (GOLDEN_MNT6298_PROOF, SW6_GT_G1G2,
                                  host_alpha_beta, inv_inputs,
                                  mnt4753_anchor, mnt6298_golden_points,
                                  mnt6753_anchor)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    cuda_lib.build()
    print(f"built {len(cuda_lib.SOURCES)} kernel libraries with nvcc in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # registers, stack frame and spills of every kernel, as ptxas reports them
    print("ptxas " + json.dumps(cuda_lib.resource_usage()), flush=True)

    # ------------------------------------------------------------------
    # 2. kernels against their plain versions, on the device
    # ------------------------------------------------------------------
    fq = PP.MNT4753_FQ
    nd, L = fq.n_digits, (fq.n_digits + 1) // 2
    p, R = fq.modulus, 1 << (16 * fq.n_digits)
    gen = torch.Generator().manual_seed(2024)
    eng = CI.mnt4753_engine()
    engines = {"mnt4753": eng, "mnt6753": CI.mnt6753_engine()}
    fr = eng.g1.scalar_field
    g1, g2 = eng.g1, eng.g2
    MUL_OPS = (2 * L * L + L) * 2      # 32-bit integer operations a multiply

    def rand_elems(n, bound=p):
        """n uniform integers below ``bound`` as digits on the device."""
        raw = torch.randint(0, 1 << 16, (n, nd + 4), generator=gen,
                            dtype=torch.int64)
        vals = [v % bound for v in limbs.from_digits_batch(raw)]
        return torch.from_numpy(limbs.to_digits_batch(vals, nd)).to(dev)

    def digits(vals):
        return torch.from_numpy(limbs.to_digits_batch(vals, nd)).to(dev)

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def event_seconds(fn):
        """(result, seconds) of one call, between CUDA events: for work too
        long to repeat."""
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1) / 1e3

    def bound(nbytes, nops, tensor_ops=0):
        """(bound_ms, bound_by): the largest of the bytes over the memory
        rate, the 32-bit integer operations over their peak rate and the
        byte products of the tensor cores over the int8 rate."""
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        by_ops = max(nops / PEAK_INT32_OPS_PER_S,
                     tensor_ops / PEAK_INT8_OPS_PER_S) * 1e3
        return max(by_bytes, by_ops), \
            "bytes" if by_bytes >= by_ops else "operations"

    def compare(name, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} against "
                                 f"{tuple(want.shape)} of the plain version")
        err = int((got - want).abs().max()) if got.numel() else 0
        if err != 0:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"(max abs digit error {err})")
        return err

    N = 1 << 11
    edge = [0, 1, p - 1]
    a_big = rand_elems(N)
    b_big = rand_elems(N)
    a_big[:3] = digits(edge)
    b_big[:3] = digits([p - 1, p - 1, p - 1])
    wide = rand_elems(N, R)                 # one operand >= p but < R
    wide[:2] = digits([R - 1, p])
    lanes = rand_elems(3000).reshape(1000, 3, nd)   # curve-loop shape

    errs = {}
    errs["mont_mul"] = max(
        compare("mont_mul [2^11,48]", fp.mont_mul(fq, a_big, b_big),
                fp.mont_mul_plain(fq, a_big, b_big)),
        compare("mont_mul [2^11,48] wide operand",
                fp.mont_mul(fq, wide, b_big),
                fp.mont_mul_plain(fq, wide, b_big)),
        compare("mont_mul [1,48]", fp.mont_mul(fq, a_big[2:3], b_big[5:6]),
                fp.mont_mul_plain(fq, a_big[2:3], b_big[5:6])),
        compare("mont_mul constant operand", fp.mont_mul(fq, a_big, b_big[7]),
                fp.mont_mul_plain(fq, a_big, b_big[7])),
        compare("mont_mul twiddle broadcast",
                fp.mont_mul(fq, a_big.reshape(8, 256, nd), b_big[:256]),
                fp.mont_mul_plain(fq, a_big.reshape(8, 256, nd),
                                  b_big[:256])),
        compare("mont_mul strided slices",
                fp.mont_mul(fq, a_big[0::2], b_big[1::2]),
                fp.mont_mul_plain(fq, a_big[0::2], b_big[1::2])),
        compare("mont_mul [1000,3,48]", fp.mont_mul(fq, lanes, lanes),
                fp.mont_mul_plain(fq, lanes, lanes)),
        compare("from_mont of a wide value", fp.from_mont(fq, wide),
                fp.mont_redc(fq, torch.nn.functional.pad(wide, (0, nd)))))
    for name, kern, plain in (("fp_add", fp.add_mod, fp.add_mod_plain),
                              ("fp_sub", fp.sub_mod, fp.sub_mod_plain)):
        errs[name] = max(
            compare(f"{name} [2^11,48]", kern(fq, a_big, b_big),
                    plain(fq, a_big, b_big)),
            compare(f"{name} swapped", kern(fq, b_big, a_big),
                    plain(fq, b_big, a_big)),
            compare(f"{name} [1000,3,48] against a row",
                    kern(fq, lanes, lanes[5, 1]),
                    plain(fq, lanes, lanes[5, 1])))
    errs["fp_neg"] = compare("fp_neg [2^11,48]", fp.neg_mod(fq, a_big),
                             fp.neg_mod_plain(fq, a_big))
    inv_one = a_big[5:6]
    errs["inv_bea"] = compare("inv_bea [1,48]", fp.inv_bea(fq, inv_one),
                              fp.inv_bea_plain(fq, inv_one))
    # the inputs of the host test of the inverse at the three widths the
    # kernels are built for (MNT4-753 Fq and MNT6-753 Fq, which is
    # MNT4-753 Fr, at 48 digits; BLS12-377 Fq and Fr): 0, 1, 2, p - 1,
    # (p - 1)/2, 2^k for every k, runs of ones, seeded values, and those
    # that take the most passes or make a pass negate a row
    inv_checked = {}
    for F in (fq, PP.MNT6753_FQ, PP.BLS12_377_FQ, PP.BLS12_377_FR):
        vals = [v for kind in inv_inputs(F.modulus, F.name).values()
                for v in kind]
        xs = torch.from_numpy(limbs.to_digits_batch(vals, F.n_digits)).to(dev)
        got = fp.inv_bea(F, xs)
        errs["inv_bea"] = max(errs["inv_bea"], compare(
            f"inv_bea {F.name} [{len(vals)},{F.n_digits}]", got,
            fp.inv_bea_plain(F, xs)))
        if limbs.from_digits_batch(got.cpu()) != [
                pow(v, -1, F.modulus) if v else 0 for v in vals]:
            raise AssertionError(f"inv_bea {F.name} disagrees with python's "
                                 f"pow(v, -1, p)")
        inv_checked[F.name] = len(vals)
    print("inv_bea_inputs_checked " + json.dumps(inv_checked), flush=True)
    for mixed in ((a_big.cpu(), b_big), (a_big, b_big.cpu())):
        try:
            fp.mont_mul(fq, *mixed)
        except ValueError:
            continue
        raise AssertionError("mont_mul took operands on two devices")
    # the narrower widths the library is built for
    for small in (PP.BLS12_377_FQ, PP.BLS12_377_FR):
        xs = torch.from_numpy(limbs.to_digits_batch(
            [0, 1, small.modulus - 1, 12345], small.n_digits)).to(dev)
        compare(f"mont_mul {small.name}", fp.mont_mul(small, xs, xs),
                fp.mont_mul_plain(small, xs, xs))
        compare(f"fp_sub {small.name}", fp.sub_mod(small, xs, xs.flip(0)),
                fp.sub_mod_plain(small, xs, xs.flip(0)))

    def inv_ops(v, modulus):
        """32-bit integer operations the inverse of v takes: its passes (by
        tools/divsteps_model.py), each 31 divsteps on two-word values (12
        a step: the test, compare, subtract and shift, and the matrix's
        two-word updates) and the rows of its matrix: 4L multiply-adds on
        x and y, 6L on u and v with the multiples of p (2 each), and 4L
        for the two reductions."""
        return divsteps_model.inverse(v, modulus).passes * (31 * 12 + 24 * L)

    # Bytes the function must move: a field element is nd 16-bit digits.
    # The int64 boundary layout spends 8 bytes on each digit; that is the
    # port's choice, not the function's need, and is kept as a separate
    # figure where it matters (the large-batch line below).
    elem_bytes = nd * 2
    layout_bytes = nd * 8

    # The same five at the shapes the 2^16-constraint rung gives them: here
    # its witness map's FFT passes over 2^17 rows; after the rung, the
    # widest operand layouts its setup launched them at, as the rung
    # recorded them (``field_kernels_at_setup``).  (The inverse is only
    # ever called on one element, on either path.)
    field_ops = {
        # name: (kernel, plain version, 32-bit integer operations an element)
        "mont_mul": (lambda a, b: fp.mont_mul(fq, a, b),
                     lambda a, b: fp.mont_mul_plain(fq, a, b), MUL_OPS),
        "fp_add": (lambda a, b: fp.add_mod(fq, a, b),
                   lambda a, b: fp.add_mod_plain(fq, a, b), 2 * L),
        "fp_sub": (lambda a, b: fp.sub_mod(fq, a, b),
                   lambda a, b: fp.sub_mod_plain(fq, a, b), 2 * L),
        "fp_neg": (lambda a, b: fp.neg_mod(fq, a),
                   lambda a, b: fp.neg_mod_plain(fq, a), L),
    }

    def elems(rows):
        """Uniform digits with the top one zero: below 2^752, under both
        MNT4-753 moduli; the edge values first."""
        raw = torch.randint(0, 1 << 16, (rows, nd), generator=gen,
                            dtype=torch.int64)
        raw[:, -1] = 0
        out = raw.to(dev)
        out[:3] = digits(edge)
        return out

    def plain_by_chunks(plain, a, b, rows=1 << 15):
        """The plain version over chunks of rows: it is elementwise, and its
        temporaries are a hundred times its operands."""
        w = a.shape[-1]                    # digits of the operands' field
        if b is None:
            shape, fa = a.shape, a.reshape(-1, w)
            fb = fa
        else:
            a_e, b_e = torch.broadcast_tensors(a, b)
            shape = a_e.shape
            fa, fb = a_e.reshape(-1, w), b_e.reshape(-1, w)
        return torch.cat([plain(fa[i:i + rows], fb[i:i + rows])
                          for i in range(0, fa.shape[0], rows)]
                         ).reshape(shape)

    def field_row(name, label, kern, plain, a, b, ops_each):
        """A timed case: the kernel's times, the plain version's, the
        bound.  The bound reads each input element once: an operand given
        twice (b = a) counts once, a broadcast axis (stride 0) once."""
        got = kern(a, b)
        w = a.shape[-1]                    # digits of the operands' field

        def distinct(t):
            return math.prod(n for n, st in zip(t.shape, t.stride()) if st)

        n_in = distinct(a) + (0 if b is None or b is a else distinct(b))
        n_out = got.numel() // w
        b_ms, b_by = bound((n_in // w + n_out) * 2 * w, n_out * ops_each)
        return {"name": name, "case": label, "rows": n_out,
                "ms": time_ms(lambda: kern(a, b), 20),
                "device_ms": graph_ms(lambda: kern(a, b), 20),
                "plain_ms": time_ms(lambda: plain_by_chunks(plain, a, b), 1),
                "bound_ms": b_ms, "bound_by": b_by}

    def field_kernels_at_2p16_shapes():
        """Returns ({kernel: max error over the cases}, the timed cases as
        rows).  A function so that its gigabytes die with it."""
        n17 = 1 << 17
        x17, y17 = elems(n17), elems(n17)
        cases = [("[2^17,48] dense", name, x17,
                  None if name == "fp_neg" else y17, True)
                 for name in field_ops]
        # beside the path's shapes: a batch that fills the card
        cases.append(("[2^20,48] dense", "mont_mul", elems(1 << 20),
                      elems(1 << 20), True))
        twiddles = y17[:n17 // 2]
        for h in (1, 1 << 8, 1 << 16):      # first, a middle and last pass
            y = x17.reshape(n17 // (2 * h), 2, h, nd)
            E, O = y[:, 0], y[:, 1]
            t = y17[n17 // 2:].reshape(O.shape)
            cases += [
                (f"fft pass, half-length {h}: odd half x twiddles",
                 "mont_mul", O, twiddles[0:n17 // 2:n17 // (2 * h)], False),
                (f"fft pass, half-length {h}: even half + t", "fp_add", E, t,
                 False),
                (f"fft pass, half-length {h}: even half - t", "fp_sub", E, t,
                 False)]
        errs16 = dict.fromkeys(field_ops, 0)
        rows = []
        for label, name, a, b, timed_case in cases:
            kern, plain, ops_each = field_ops[name]
            err = compare(f"{name} {label}", kern(a, b),
                          plain_by_chunks(plain, a, b))
            errs16[name] = max(errs16[name], err)
            if timed_case:
                rows.append(dict(field_row(name, label, kern, plain, a, b,
                                           ops_each), max_abs_err=err))
        return errs16, rows

    errs16, field_rows = field_kernels_at_2p16_shapes()
    print("field_kernel_shapes " + json.dumps(field_rows), flush=True)

    work = {
        # name: (bytes moved, 32-bit integer operations)
        "mont_mul": (3 * N * elem_bytes, N * MUL_OPS),
        "fp_add": (3 * N * elem_bytes, N * 2 * L),
        "fp_sub": (3 * N * elem_bytes, N * 2 * L),
        "fp_neg": (2 * N * elem_bytes, N * L),
        "inv_bea": (2 * elem_bytes,
                    inv_ops(limbs.from_digits(inv_one[0]), p)),
    }
    timed = {
        "mont_mul": (lambda: fp.mont_mul(fq, a_big, b_big),
                     lambda: fp.mont_mul_plain(fq, a_big, b_big), 200, 10),
        "fp_add": (lambda: fp.add_mod(fq, a_big, b_big),
                   lambda: fp.add_mod_plain(fq, a_big, b_big), 200, 10),
        "fp_sub": (lambda: fp.sub_mod(fq, a_big, b_big),
                   lambda: fp.sub_mod_plain(fq, a_big, b_big), 200, 10),
        "fp_neg": (lambda: fp.neg_mod(fq, a_big),
                   lambda: fp.neg_mod_plain(fq, a_big), 200, 10),
        "inv_bea": (lambda: fp.inv_bea(fq, inv_one),
                    lambda: fp.inv_bea_plain(fq, inv_one), 50, 1),
    }
    meta = {
        "mont_mul": ("gingerlib_tpu_torch/csrc/mont_mul.cu",
                     "gingerlib_tpu/ops/pallas_mont.py:685"),
        "inv_bea": ("gingerlib_tpu_torch/csrc/inv_bea.cu",
                    "gingerlib_tpu/ops/pallas_mont.py:844"),
        "fp_add": ("gingerlib_tpu_torch/csrc/fp_addsub.cu",
                   "gingerlib_tpu/fields/fp.py:164"),
        "fp_sub": ("gingerlib_tpu_torch/csrc/fp_addsub.cu",
                   "gingerlib_tpu/fields/fp.py:173"),
        "fp_neg": ("gingerlib_tpu_torch/csrc/fp_addsub.cu",
                   "gingerlib_tpu/fields/fp.py:181"),
    }
    # ms, plain_ms and bound_ms: at the 2^10 path's shape ([2^11,48], one
    # element for the inverse); at_2p16_shape: the same three at the widest
    # layout the 2^16 setup launched the kernel at (filled after that
    # rung); max_abs_err: over every shape of both paths
    kernels = []
    for name, (kern, plain, reps, plain_reps) in timed.items():
        b_ms, b_by = bound(*work[name])
        row = {
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": 0,
            "max_abs_err": max(errs[name], errs16.get(name, 0)),
            "ms": time_ms(kern, reps), "device_ms": graph_ms(kern, reps),
            "plain_ms": time_ms(plain, plain_reps),
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes a 753-bit modular operation
            "library_ms": None,
        }
        if name == "inv_bea":
            row["at_2p16_shape"] = {k: row[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}
            row["at_2p16_shape"].update(
                case="[1,48], as on the 2^10 path", rows=1)
        kernels.append(row)
    # K2 on a batch beside the path's one element: 2^15 seeded elements, a
    # thread each (a warp runs as many passes as its longest lane)
    inv_wide = rand_elems(1 << 15)
    want, plain_s = event_seconds(lambda: fp.inv_bea_plain(fq, inv_wide))
    err = compare("inv_bea [2^15,48]", fp.inv_bea(fq, inv_wide), want)
    kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], err)
    b_ms, b_by = bound(2 * (1 << 15) * elem_bytes, sum(
        inv_ops(v, p) for v in limbs.from_digits_batch(inv_wide.cpu())))
    kernels[-1]["at_2p15_rows"] = {
        "rows": 1 << 15, "ms": time_ms(lambda: fp.inv_bea(fq, inv_wide), 10),
        "device_ms": graph_ms(lambda: fp.inv_bea(fq, inv_wide), 10),
        "plain_ms": plain_s * 1e3, "bound_ms": b_ms, "bound_by": b_by}
    del inv_wide, want
    print("kernels agree with their plain versions on the device "
          "(tolerance 0)", flush=True)

    # Beside the path's shapes, where a launch costs more than the work:
    # the multiply at batches that fill the card, against its bound and the
    # int64 layout's bytes
    print("mont_mul_large_batch " + json.dumps([
        {"rows": r["rows"], "ms": r["ms"], "device_ms": r["device_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "share_of_bound": r["bound_ms"] / r["device_ms"],
         "int64_layout_bytes_ms":
             3 * r["rows"] * layout_bytes / PEAK_BYTES_PER_S * 1e3}
        for r in field_rows if r["name"] == "mont_mul" and r["case"] in (
            "[2^17,48] dense", "[2^20,48] dense")]), flush=True)

    # What the host pays per launch before the kernel is reached: the
    # current-stream lookup, and a whole call of the wrapper with the device
    # kept waiting on nothing (a batch of one).
    look = 20000
    t0 = time.perf_counter()
    for _ in range(look):
        torch.cuda.current_stream(0).cuda_stream
    stream_us = (time.perf_counter() - t0) / look * 1e6
    one = a_big[:1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(look):
        fp.mont_mul(fq, one, one)
    torch.cuda.synchronize()
    print("host_cost_per_launch " + json.dumps(
        {"current_stream_lookup_us": stream_us,
         "mont_mul_call_us": (time.perf_counter() - t0) / look * 1e6}),
        flush=True)

    # ------------------------------------------------------------------
    # 2b. the curve kernels against their plain versions, on the device
    # ------------------------------------------------------------------

    def multiples(curve, n, seed):
        """n multiples [k]G of the generator with seeded 32-bit k: the
        projective points as the loop leaves them (Z != 1), their affine
        form, and the k."""
        ks = torch.randint(1, 1 << 32, (n,), dtype=torch.int64,
                           generator=torch.Generator().manual_seed(seed))
        sd = torch.stack([ks & 0xFFFF, ks >> 16], dim=1).to(dev)
        proj = msm_mod.fixed_base_msm(curve, curve.generator_affine, sd)
        return proj, curve.to_affine(proj), ks.tolist()

    B = ec_kernels.INV_TILE            # elements a tile of K6

    def tile_muls(x):
        """Multiplies of one level of K6's tree that the data in x [N, nd]
        needs going up: k - 1 for a tile of k non-zero elements (down takes
        twice as many)."""
        live = (x != 0).any(-1)
        live = torch.cat([live, live.new_zeros(-live.shape[0] % B)])
        return int((live.reshape(-1, B).sum(1) - 1).clamp(min=0).sum())

    def tree_root(x):
        """The value the tail inverts for x [N <= INV_TILE, nd]: the product
        of its non-zero elements, as stored (Montgomery form)."""
        return limbs.from_digits_batch(
            ec_kernels.inv_up_plain(fq, x)[1].cpu())[0]

    def compare_all(name, got, want):
        return max(compare(f"{name}[{i}]", g.to(torch.int64),
                           w.to(torch.int64))
                   for i, (g, w) in enumerate(zip(got, want)))

    # lanes 0..6 of every curve-kernel input: equal points, opposite
    # points, infinity on the right, on the left and on both sides, a
    # doubling with y = 0 (no such point exists on these curves: fabricated
    # coordinates, the kernels look at them lane by lane), and equal points
    # in two projective forms (K4 only)
    N_SPECIAL = 7

    def proj_case(curve, proj, n):
        """Operands of the projective addition: n lanes of distinct points,
        the special lanes first."""
        P = tuple(c[:n].clone() for c in proj)
        Q = tuple(c[:n].roll(1, 0).clone() for c in proj)
        zero = curve.zero((1,))
        negP = curve.neg(P)
        lam = proj[0][n - 1]                       # any non-zero element
        for k in range(3):
            Q[k][0] = P[k][0]
            Q[k][1] = negP[k][1]
            Q[k][2] = zero[k][0]
            P[k][3] = zero[k][0]
            P[k][4] = zero[k][0]
            Q[k][4] = zero[k][0]
            Q[k][6] = curve.F.mul(P[k][6], lam)
        P[1][5] = 0
        for k in range(3):
            Q[k][5] = P[k][5]
        return P, Q

    def affine_case(curve, aff, n):
        """Operands of the batched affine addition, as ((x, y), inf)."""
        ax, ay = aff
        x1, y1 = ax[:n].clone(), ay[:n].clone()
        x2, y2 = ax[:n].roll(1, 0).clone(), ay[:n].roll(1, 0).clone()
        inf1 = torch.zeros(n, dtype=torch.bool, device=dev)
        inf2 = torch.zeros(n, dtype=torch.bool, device=dev)
        x2[0], y2[0] = x1[0], y1[0]
        x2[1], y2[1] = x1[1], curve.F.neg(y1[1])
        inf2[2] = inf1[3] = inf1[4] = inf2[4] = True
        for t in (x2, y2, x1, y1):
            t[4] = 0
        x2[2] = y2[2] = x1[3] = y1[3] = 0
        y1[5] = 0
        x2[5], y2[5] = x1[5], y1[5]
        return ((x1, y1), inf1), ((x2, y2), inf2)

    def curve_kernel_section():
        """Holds K4-K6 against their plain versions at the path's shapes and
        returns {kernel: its row at the shape the kernels line reports}.
        A function so that its hundreds of megabytes die with it."""
        big_lanes = 1 << 18
        g1_proj, g1_aff, _ = multiples(g1, big_lanes, seed=7)
        curve_rows = {}
        shapes_line = []
        k4_rows = []

        # K4 at one lane (the window fold's width; timed on the doubling
        # P + P it mostly runs), at 2^10 lanes, at the Fenwick phase's width
        # (8 windows x 2047 buckets) and at the first projective tree level
        # below the default cutoff
        for n in (1, 1 << 10, 8 * 2047, 1 << 15):
            err = 0
            if n == 1:
                P = tuple(c[8:9].clone() for c in g1_proj)
                Q = tuple(c[9:10] for c in g1_proj)
                err = max(compare_all(
                    "ec_proj_add [1] P+Q", ec_kernels.proj_add(g1, P, Q),
                    ec_kernels.proj_add_plain(g1, P, Q)), compare_all(
                    "ec_proj_add [1] P+P", ec_kernels.proj_add(g1, P, P),
                    g1.double(P)))
                Q = P
                muls = 17                     # a doubling, a != 0
            else:
                P, Q = proj_case(g1, g1_proj, n)
                # lanes: 3 with an operand at infinity (no multiply), 2 that
                # cancel or double a y = 0 point (5), 2 doublings (5 + 12),
                # the rest 14
                muls = 2 * 5 + 2 * 17 + (n - N_SPECIAL) * 14
            err = max(err, compare_all(
                f"ec_proj_add [{n}]", ec_kernels.proj_add(g1, P, Q),
                ec_kernels.proj_add_plain(g1, P, Q)))
            if n > 1:
                # strided halves, as the tree levels pass them
                err = max(err, compare_all(
                    f"ec_proj_add [{n // 2}] even/odd",
                    ec_kernels.proj_add(g1, tuple(c[0::2] for c in P),
                                        tuple(c[1::2] for c in Q)),
                    ec_kernels.proj_add_plain(g1, tuple(c[0::2] for c in P),
                                              tuple(c[1::2] for c in Q))))
            reps = 200 if n == 1 else 20
            b_ms, b_by = bound(9 * n * elem_bytes, muls * MUL_OPS)
            row = {"lanes": n, "max_abs_err": err,
                   "ms": time_ms(lambda: ec_kernels.proj_add(g1, P, Q), reps),
                   "device_ms": graph_ms(
                       lambda: ec_kernels.proj_add(g1, P, Q), reps),
                   "plain_ms": time_ms(
                       lambda: ec_kernels.proj_add_plain(g1, P, Q), 3),
                   "bound_ms": b_ms, "bound_by": b_by}
            shapes_line.append(dict(row, name="ec_proj_add"))
            k4_rows.append(row)
            if n == 8 * 2047:
                curve_rows["ec_proj_add"] = dict(row)
        # the doubling of the window fold: P + P must be double(P)
        compare_all("ec_proj_add P+P against double",
                    ec_kernels.proj_add(g1, P, P), g1.double(P))

        # K6 at the edges of its tiles (INV_TILE elements): a batch of one,
        # two, a tile less one, a tile, a tile and one, two tiles and three,
        # three tiles and five, with zeros on the first and last element of
        # every tile and, in the last, one whole tile of zeros.  A batch of
        # up to a tile takes one tail launch and no inverse kernel, one of
        # up to INV_TILE^2 elements an up, a tail and a down.
        k6_err = {"inv_tree_up": 0, "inv_tree_tail": 0, "inv_tree_down": 0}
        edge_widths = (1, 2, B - 1, B, B + 1, 2 * B + 3, 3 * B + 5)
        for n in edge_widths:
            x = rand_elems(n)
            x[0] = x[n - 1] = 0
            for i in range(B - 1, n, B):
                x[i:i + 2] = 0
            if n >= 3 * B:
                x[B:2 * B] = 0
            before = dict(fp.launch_counts)
            got = ec_kernels.batch_inverse(fq, x)
            launched = {k: v - before[k] for k, v in fp.launch_counts.items()
                        if v != before[k]}
            want = {"inv_tree_tail": 1} if n <= B else {
                "inv_tree_up": 1, "inv_tree_tail": 1, "inv_tree_down": 1}
            if launched != want:
                raise AssertionError(f"batch_inverse [{n}] launched "
                                     f"{launched}, not {want}")
            compare(f"batch_inverse [{n}] edges", got,
                    ec_kernels.batch_inverse_plain(fq, x))
            if fp.fp_to_ints(fq, got) != [pow(v, -1, p) if v else 0
                                          for v in fp.fp_to_ints(fq, x)]:
                raise AssertionError(f"batch_inverse [{n}] disagrees with "
                                     f"pow(v, -1, p)")
            if n <= B:
                k6_err["inv_tree_tail"] = max(k6_err["inv_tree_tail"], compare(
                    f"inv_tree_tail [{n}]", ec_kernels.inv_tail_cuda(fq, x),
                    ec_kernels.inv_tail_plain(fq, x)))
                continue
            tree, roots = ec_kernels.inv_up_cuda(fq, x)
            want_tree, want_roots = ec_kernels.inv_up_plain(fq, x)
            k6_err["inv_tree_up"] = max(
                k6_err["inv_tree_up"],
                compare(f"inv_tree_up [{n}] trees",
                        ec_kernels.unpack_limbs(tree), want_tree),
                compare(f"inv_tree_up [{n}] products", roots, want_roots))
            rinv = ec_kernels.batch_inverse(fq, roots)
            k6_err["inv_tree_down"] = max(k6_err["inv_tree_down"], compare(
                f"inv_tree_down [{n}]",
                ec_kernels.inv_down_cuda(fq, tree, rinv, n),
                ec_kernels.inv_down_plain(fq, want_tree, rinv, n)))
        shapes_line.append({"name": "batch_inverse_edges",
                            "lanes": list(edge_widths), "max_abs_err": 0,
                            "launches_checked": True})

        # K5 and K6 at the narrowest and two of the widest affine tree
        # levels of a 2^16-point MSM (8 windows a chunk, default cutoff):
        # 2^15, 2^18 and 2^19 lanes (the points of 2^18 twice)
        for n in (1 << 15, big_lanes, 2 * big_lanes):
            aff = g1_aff if n <= big_lanes else tuple(
                torch.cat([c, c]) for c in g1_aff)
            a_pt, b_pt = affine_case(g1, aff, n)
            del aff
            (x1, y1), inf1 = a_pt
            (x2, y2), inf2 = b_pt
            pre = ec_kernels.affine_pre(g1, x1, y1, x2, y2, inf1, inf2)
            err_pre = compare_all(
                f"ec_affine_pre [{n}]", pre,
                ec_kernels.affine_pre_plain(g1, x1, y1, x2, y2, inf1, inf2))
            num, den, inf3 = pre
            den2 = den.reshape(n, nd)
            if int((~(den2 != 0).any(-1)).sum()) < 3:
                raise AssertionError("the inversion's input holds no zeros")
            # K6's three kernels one at a time on the denominators: up on
            # them, the tail on the tiles' products (at 2^19 on the products
            # of the products), down; then the whole inversion they make up
            tree, roots = ec_kernels.inv_up_cuda(fq, den2)
            want_tree, want_roots = ec_kernels.inv_up_plain(fq, den2)
            err_up = max(
                compare(f"inv_tree_up [{n}] trees",
                        ec_kernels.unpack_limbs(tree), want_tree),
                compare(f"inv_tree_up [{n}] products", roots, want_roots))
            rinv = ec_kernels.batch_inverse(fq, roots)
            err_down = compare(
                f"inv_tree_down [{n}]",
                ec_kernels.inv_down_cuda(fq, tree, rinv, n),
                ec_kernels.inv_down_plain(fq, want_tree, rinv, n))
            tail_in = roots
            while tail_in.shape[0] > B:
                tail_in = ec_kernels.inv_up_plain(fq, tail_in)[1]
            err_tail = compare(f"inv_tree_tail [{tail_in.shape[0]}]",
                               ec_kernels.inv_tail_cuda(fq, tail_in),
                               ec_kernels.inv_tail_plain(fq, tail_in))
            before = dict(fp.launch_counts)
            dinv2 = ec_kernels.batch_inverse(fq, den2)
            inv_launches = {k: v - before[k]
                            for k, v in fp.launch_counts.items()
                            if v != before[k]}
            levels = 1 if n <= B * B else 2
            if inv_launches != {"inv_tree_up": levels, "inv_tree_tail": 1,
                                "inv_tree_down": levels}:
                raise AssertionError(f"batch_inverse [{n}] launched "
                                     f"{inv_launches}")
            err_inv = compare(f"batch_inverse [{n}]", dinv2,
                              ec_kernels.batch_inverse_plain(fq, den2))
            err_inv = max(err_inv, compare(
                f"batch_inverse [{n - 3}] ragged", ec_kernels.batch_inverse(
                    fq, den2[3:]), dinv2[3:]))
            err_up, err_down = max(err_up, err_inv), max(err_down, err_inv)
            err_tail = max(err_tail, err_inv)
            if fp.fp_to_ints(fq, dinv2[:12]) != [
                    pow(v, -1, p) if v else 0
                    for v in fp.fp_to_ints(fq, den2[:12])]:
                raise AssertionError("batch_inverse disagrees with "
                                     "pow(v, -1, p)")
            dinv = dinv2.reshape(den.shape)
            post_args = (num, dinv, x1, y1, x2, y2, inf1, inf2, inf3)
            err_post = compare_all(
                f"ec_affine_post [{n}]",
                ec_kernels.affine_post(g1, *post_args),
                ec_kernels.affine_post_plain(g1, *post_args))
            (sx, sy), sinf = g1.batch_affine_add(
                ((x1[0::2], y1[0::2]), inf1[0::2]),
                ((x2[1::2], y2[1::2]), inf2[1::2]))
            (wx, wy), winf = ec_kernels.batch_affine_add_plain(
                g1, ((x1[0::2], y1[0::2]), inf1[0::2]),
                ((x2[1::2], y2[1::2]), inf2[1::2]))
            compare_all(f"batch_affine_add [{n // 2}] even/odd",
                        (sx, sy, sinf), (wx, wy, winf))
            live = int((~(inf1 | inf2 | inf3)).sum())
            muls = tile_muls(den2)
            tiles, m = roots.shape[0], tail_in.shape[0]
            rows = {
                # six values and three flag bytes a lane; two subtractions
                # everywhere, a squaring and four additions where it doubles
                "ec_affine_pre": (
                    n, err_pre, (6 * elem_bytes + 3) * n,
                    n * 2 * 2 * L + 2 * (MUL_OPS + 4 * 2 * L),
                    lambda: ec_kernels.affine_pre(g1, x1, y1, x2, y2, inf1,
                                                  inf2),
                    lambda: ec_kernels.affine_pre_plain(g1, x1, y1, x2, y2,
                                                        inf1, inf2)),
                # eight values and three flag bytes a lane; three multiplies
                # and four subtractions where lambda is used
                "ec_affine_post": (
                    n, err_post, (8 * elem_bytes + 3) * n,
                    live * (3 * MUL_OPS + 4 * 2 * L),
                    lambda: ec_kernels.affine_post(g1, *post_args),
                    lambda: ec_kernels.affine_post_plain(g1, *post_args)),
                # reads the elements, writes the trees and their roots
                "inv_tree_up": (
                    n, err_up, (n + tiles * 2 * B) * elem_bytes,
                    muls * MUL_OPS,
                    lambda: ec_kernels.inv_up_cuda(fq, den2),
                    lambda: ec_kernels.inv_up_plain(fq, den2)),
                # the tiles' products: reads and writes them; a multiply up
                # and two down for each non-zero one not first in its tile,
                # and the root's inverse
                "inv_tree_tail": (
                    m, err_tail, 2 * m * elem_bytes,
                    3 * tile_muls(tail_in) * MUL_OPS + inv_ops(
                        tree_root(tail_in), p),
                    lambda: ec_kernels.inv_tail_cuda(fq, tail_in),
                    lambda: ec_kernels.inv_tail_plain(fq, tail_in)),
                # reads the trees below their roots and the roots' inverses,
                # writes the inverses
                "inv_tree_down": (
                    n, err_down, (tiles * (2 * B - 1) + n) * elem_bytes,
                    2 * muls * MUL_OPS,
                    lambda: ec_kernels.inv_down_cuda(fq, tree, rinv, n),
                    lambda: ec_kernels.inv_down_plain(fq, want_tree, rinv,
                                                      n)),
            }
            for name, (lanes, err, nbytes, nops, kern, plain) in rows.items():
                b_ms, b_by = bound(nbytes, nops)
                row = {"lanes": lanes, "max_abs_err": max(err,
                                                          k6_err.get(name, 0)),
                       "ms": time_ms(kern, 10),
                       "device_ms": graph_ms(kern, 10),
                       "plain_ms": time_ms(plain, 2), "bound_ms": b_ms,
                       "bound_by": b_by}
                if name == "inv_tree_tail":
                    row["below"] = n
                shapes_line.append(dict(row, name=name))
                if n == big_lanes:
                    curve_rows[name] = row
            # the whole inversion
            shapes_line.append({
                "name": "batch_inverse", "lanes": n, "max_abs_err": err_inv,
                "ms": time_ms(lambda: ec_kernels.batch_inverse(fq, den2), 10),
                "device_ms": graph_ms(
                    lambda: ec_kernels.batch_inverse(fq, den2), 10),
                "plain_ms": time_ms(
                    lambda: ec_kernels.batch_inverse_plain(fq, den2), 2),
                "launches": inv_launches})
            del a_pt, b_pt, x1, y1, x2, y2, pre, num, den, den2, tree, \
                want_tree, dinv2, dinv, post_args, rows
        print("curve_kernel_shapes " + json.dumps(shapes_line), flush=True)

        # the narrower widths: BLS12-377 G1 (24 digits, a = 0) through all
        # four, its scalar field (16 digits) through the inversion
        b1 = CI.bls12_377_g1()
        b_proj, b_aff, _ = multiples(b1, 256, seed=8)
        P, Q = proj_case(b1, b_proj, 256)
        compare_all("ec_proj_add bls12_377", ec_kernels.proj_add(b1, P, Q),
                    ec_kernels.proj_add_plain(b1, P, Q))
        a_pt, b_pt = affine_case(b1, b_aff, 256)
        (bx, by), binf = b1.batch_affine_add(a_pt, b_pt)
        (wx, wy), winf = ec_kernels.batch_affine_add_plain(b1, a_pt, b_pt)
        compare_all("batch_affine_add bls12_377", (bx, by, binf),
                    (wx, wy, winf))
        fr377 = PP.BLS12_377_FR
        xs = torch.from_numpy(limbs.to_digits_batch(
            [0, 1, fr377.modulus - 1] + list(range(2, 40)),
            fr377.n_digits)).to(dev)
        compare("inv_tree bls12_377 Fr", ec_kernels.batch_inverse(fr377, xs),
                ec_kernels.batch_inverse_plain(fr377, xs))
        try:
            ec_kernels.proj_add(g2, g2.zero((4,)), g2.zero((4,)))
        except NotImplementedError:
            pass
        else:
            raise AssertionError("the G1 kernel took a curve over Fq2")
        print("curve kernels agree with their plain versions on the device "
              "(tolerance 0)", flush=True)
        curve_rows["ec_proj_add"]["by_lanes"] = k4_rows
        return curve_rows

    curve_rows = curve_kernel_section()

    # K5 and K6 by width, run after the 2^16 rung at the widths it launched
    # them
    def classes_of(key, widths):
        """[(class, launches, widths in it, its most frequent width)] of
        the launches of kernel ``key`` by width, narrowest class first."""
        classes = {}
        for n, c in widths.items():
            classes.setdefault(ec_kernels.width_class(key, n),
                               []).append((c, n))
        return [(label, sum(c for c, _ in m), len(m), max(m)[1])
                for label, m in sorted(classes.items(), key=lambda kv: min(
                    n for _, n in kv[1]))]

    def timed_row(key, label, launches, n_widths, n, fn, nbytes, nops,
                  tensor_ops=0):
        """One class of a kernel's launches: device time at its most
        frequent width, the bound there and the class's loss, its launches
        x (time - bound) at that width."""
        b_ms, b_by = bound(nbytes, nops, tensor_ops)
        reps = 100 if n <= 1 << 12 else 20
        row = {"kernel": key, "class": label, "launches": launches,
               "widths": n_widths, "timed_width": n, "ms": time_ms(fn, reps),
               "device_ms": graph_ms(fn, reps), "bound_ms": b_ms,
               "bound_by": b_by}
        row["loss_ms"] = launches * (row["device_ms"] - b_ms)
        return row

    def inv_tree_by_width(widths):
        """K6's three kernels at the widths the 2^16 rung launched them, on
        seeded non-zero elements: up and down at the classes of their widths
        (the rung's batches), the tail at those of the tiles' products."""
        if widths["inv_tree_up"] != widths["inv_tree_down"]:
            raise AssertionError("K6's up and down kernels ran at other "
                                 "widths")
        rows = []
        for label, launches, n_widths, n in classes_of(
                "inv_tree_up", widths["inv_tree_up"]):
            x = rand_elems(n)
            tree, roots = ec_kernels.inv_up_cuda(fq, x)
            rinv = ec_kernels.batch_inverse(fq, roots)
            compare(f"inv_tree_down [{n}]",
                    ec_kernels.inv_down_cuda(fq, tree, rinv, n),
                    ec_kernels.inv_down_plain(
                        fq, ec_kernels.unpack_limbs(tree), rinv, n))
            tiles, muls = roots.shape[0], tile_muls(x)
            rows.append(timed_row(
                "inv_tree_up", label, launches, n_widths, n,
                lambda: ec_kernels.inv_up_cuda(fq, x),
                (n + tiles * 2 * B) * elem_bytes, muls * MUL_OPS))
            rows.append(timed_row(
                "inv_tree_down", label, launches, n_widths, n,
                lambda: ec_kernels.inv_down_cuda(fq, tree, rinv, n),
                (tiles * (2 * B - 1) + n) * elem_bytes, 2 * muls * MUL_OPS))
            del x, tree, roots, rinv
        for label, launches, n_widths, n in classes_of(
                "inv_tree_tail", widths["inv_tree_tail"]):
            x = rand_elems(n)
            compare(f"inv_tree_tail [{n}]", ec_kernels.inv_tail_cuda(fq, x),
                    ec_kernels.inv_tail_plain(fq, x))
            rows.append(timed_row(
                "inv_tree_tail", label, launches, n_widths, n,
                lambda: ec_kernels.inv_tail_cuda(fq, x), 2 * n * elem_bytes,
                3 * tile_muls(x) * MUL_OPS + inv_ops(tree_root(x), p)))
        return rows

    def ec_affine_by_width(widths):
        """K5's two kernels at the widths the 2^16 rung launched them, as
        ``inv_tree_by_width``: operands from 2^18 seeded points (repeated
        above 2^18 lanes), the special lanes first."""
        if widths["ec_affine_pre"] != widths["ec_affine_post"]:
            raise AssertionError("K5's pre and post kernels ran at other "
                                 "widths")
        _, points, _ = multiples(g1, 1 << 18, seed=7)
        rows = []
        for label, launches, n_widths, n in classes_of(
                "ec_affine_pre", widths["ec_affine_pre"]):
            copies = -(-n // points[0].shape[0])
            a_pt, b_pt = affine_case(g1, tuple(
                torch.cat([c] * copies) for c in points), n)
            (x1, y1), inf1 = a_pt
            (x2, y2), inf2 = b_pt
            pre = ec_kernels.affine_pre(g1, x1, y1, x2, y2, inf1, inf2)
            compare_all(f"ec_affine_pre [{n}]", pre,
                        ec_kernels.affine_pre_plain(g1, x1, y1, x2, y2, inf1,
                                                    inf2))
            num, den, inf3 = pre
            dinv = ec_kernels.batch_inverse(fq, den.reshape(n, nd)).reshape(
                den.shape)
            post_args = (num, dinv, x1, y1, x2, y2, inf1, inf2, inf3)
            compare_all(f"ec_affine_post [{n}]",
                        ec_kernels.affine_post(g1, *post_args),
                        ec_kernels.affine_post_plain(g1, *post_args))
            live = int((~(inf1 | inf2 | inf3)).sum())
            rows.append(timed_row(
                "ec_affine_pre", label, launches, n_widths, n,
                lambda: ec_kernels.affine_pre(g1, x1, y1, x2, y2, inf1, inf2),
                (6 * elem_bytes + 3) * n,
                n * 2 * 2 * L + 2 * (MUL_OPS + 4 * 2 * L)))
            rows.append(timed_row(
                "ec_affine_post", label, launches, n_widths, n,
                lambda: ec_kernels.affine_post(g1, *post_args),
                (8 * elem_bytes + 3) * n, live * (3 * MUL_OPS + 4 * 2 * L)))
            del a_pt, b_pt, x1, y1, x2, y2, pre, num, den, dinv, post_args
        return rows

    def k5k6_at_widest(widths, curve=None):
        """K5's two kernels and K6's inversion against their plain versions
        at the widest batch a rung launched them (the windowed query's
        first tree level), on distinct points of ``curve`` (MNT4-753 G1 by
        default) with the special lanes first."""
        curve = curve or g1
        fq = curve.fp
        n = max(widths["ec_affine_pre"])
        if max(widths["inv_tree_up"]) != n:
            raise AssertionError("K6 ran wider than K5")
        _, points, _ = multiples(curve, 1 << 18, seed=9)
        copies = -(-n // points[0].shape[0])
        a_pt, b_pt = affine_case(curve, tuple(
            torch.cat([c] * copies) for c in points), n)
        del points
        (x1, y1), inf1 = a_pt
        (x2, y2), inf2 = b_pt
        pre = ec_kernels.affine_pre(curve, x1, y1, x2, y2, inf1, inf2)
        err = compare_all(f"ec_affine_pre [{n}]", pre,
                          ec_kernels.affine_pre_plain(curve, x1, y1, x2, y2,
                                                      inf1, inf2))
        num, den, inf3 = pre
        den2 = den.reshape(n, fq.n_digits)
        tree, roots = ec_kernels.inv_up_cuda(fq, den2)
        want_tree, want_roots = ec_kernels.inv_up_plain(fq, den2)
        err = max(err, compare(f"inv_tree_up [{n}] trees",
                               ec_kernels.unpack_limbs(tree), want_tree),
                  compare(f"inv_tree_up [{n}] products", roots, want_roots))
        rinv = ec_kernels.batch_inverse(fq, roots)
        err = max(err, compare(
            f"inv_tree_down [{n}]",
            ec_kernels.inv_down_cuda(fq, tree, rinv, n),
            ec_kernels.inv_down_plain(fq, want_tree, rinv, n)))
        del tree, want_tree, want_roots, rinv
        dinv = ec_kernels.batch_inverse(fq, den2)
        err = max(err, compare(f"batch_inverse [{n}]", dinv,
                               ec_kernels.batch_inverse_plain(fq, den2)))
        post_args = (num, dinv.reshape(den.shape), x1, y1, x2, y2, inf1,
                     inf2, inf3)
        err = max(err, compare_all(
            f"ec_affine_post [{n}]", ec_kernels.affine_post(curve,
                                                            *post_args),
            ec_kernels.affine_post_plain(curve, *post_args)))
        return {"curve": curve.name, "lanes": n, "max_abs_err": err,
                "kernels": ["ec_affine_pre", "inv_tree_up", "inv_tree_tail",
                            "inv_tree_down", "ec_affine_post"]}

    class layout_log:
        """While active, counts the field kernels' launches (K1 and
        add/sub/neg all go through ``fp._launch_binary``) by kernel, field
        and operand layout: the shape and strides of each operand."""

        def __enter__(self):
            self.real, self.seen = fp._launch_binary, {}

            def call(params, a, b, name, op):
                key = (name, params.name, tuple(a.shape), a.stride(),
                       tuple(b.shape), b.stride(), b is a)
                self.seen[key] = self.seen.get(key, 0) + 1
                return self.real(params, a, b, name, op)
            fp._launch_binary = call
            return self

        def __exit__(self, *exc):
            fp._launch_binary = self.real

    def field_kernels_at_setup(seen, timed_field=None):
        """K1 and add/sub/neg against their plain versions at the layouts
        a rung's setup launched them at (``layout_log``), the widest of
        each class: kernel, field, the output's shape past its first axis
        (the stack of an extension's products: Fq2's three rows, Fq3's
        six, Fq6's three Fq3 products of six), and which operands
        broadcast.  At MNT4-753 2^16 that takes in the windowed G2 query's
        stacked products and component views at its first tree level and
        the query scalars' one conversion to standard form; at MNT6-753
        2^15 the same over Fq3, and the Fq6 products of setup's pairing.
        Fresh operands of the same shapes and strides; the widest of each
        kernel also timed (of the field named ``timed_field`` where
        given).
        Returns ({kernel: max error}, rows, {kernel:
        its timed row})."""
        # MNT6-753's Fq and Fr are MNT4-753's Fr and Fq (the same objects);
        # the BLS12 paths' at 24 and 16 digits
        fields = {F.name: F for F in (
            fq, fr, PP.MNT6753_FQ, PP.MNT6753_FR, PP.BLS12_377_FQ,
            PP.BLS12_377_FR, PP.BLS12_381_FQ, PP.BLS12_381_FR, PP.SW6_FQ,
            PP.MNT6298_FQ, PP.MNT6298_FR)}
        # (kernel, plain version, 32-bit operations an element of l limbs)
        fns = {"mont_mul": (fp.mont_mul, fp.mont_mul_plain,
                            lambda l: (2 * l * l + l) * 2),
               "fp_add": (fp.add_mod, fp.add_mod_plain, lambda l: 2 * l),
               "fp_sub": (fp.sub_mod, fp.sub_mod_plain, lambda l: 2 * l),
               "fp_neg": (fp.neg_mod, fp.neg_mod_plain, lambda l: l)}

        def out_rows(key):
            shape = torch.broadcast_shapes(key[2], key[4])
            return shape.numel() // shape[-1]

        def layout_class(key):
            out = tuple(torch.broadcast_shapes(key[2], key[4]))
            return (key[0], key[1], len(out), out[1:-1], key[2] == out,
                    key[4] == out, key[6])

        def operand(shape, stride):
            """Seeded digits laid out as (shape, stride), every element's
            top digit zero (below both MNT4-753 moduli, MNT6-753's too)."""
            span = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
            buf = torch.randint(0, 1 << 16, (span,), generator=gen,
                                dtype=torch.int64).to(dev)
            top = torch.arange(span, device=dev).as_strided(shape, stride)
            buf[top[..., -1].reshape(-1)] = 0
            return buf.as_strided(shape, stride)

        def bind(fn, F, unary):
            return (lambda a, b: fn(F, a)) if unary else \
                (lambda a, b: fn(F, a, b))

        widest = {}
        for key, count in seen.items():
            slot = layout_class(key)
            if slot not in widest or out_rows(key) > out_rows(widest[slot][0]):
                widest[slot] = (key, count)
        errs, rows, timed = {}, [], {}
        for key, count in sorted(widest.values(),
                                 key=lambda e: (e[0][0], -out_rows(e[0]))):
            name, fname, a_shape, a_stride, b_shape, b_stride, same = key
            F = fields[fname]
            unary = name == "fp_neg"
            kern_f, plain_f, ops_each = fns[name]
            kern, plain = bind(kern_f, F, unary), bind(plain_f, F, unary)
            a = operand(a_shape, a_stride)
            b = None if unary else a if same else operand(b_shape, b_stride)
            label = f"setup {fname} a{list(a_shape)}/{list(a_stride)}" + (
                "" if unary else " b = a" if same else
                f" b{list(b_shape)}/{list(b_stride)}")
            err = compare(f"{name} {label}", kern(a, b),
                          plain_by_chunks(plain, a, b))
            errs[name] = max(errs.get(name, 0), err)
            row = {"name": name, "case": label, "rows": out_rows(key),
                   "setup_launches": count, "max_abs_err": err}
            if name not in timed and timed_field in (None, F.name):
                # sorted: the widest comes first
                row.update(field_row(name, label, kern, plain, a, b,
                                     ops_each((F.n_digits + 1) // 2)))
                timed[name] = row
            rows.append(row)
            del a, b
        return errs, rows, timed

    def loss_line(rows):
        by_kernel = {}
        for r in rows:
            by_kernel[r["kernel"]] = by_kernel.get(r["kernel"], 0) + \
                r["loss_ms"]
        return {"rows": rows, "loss_ms": sum(by_kernel.values()),
                "loss_ms_by_kernel": by_kernel}

    curve_meta = {
        "ec_proj_add": ("gingerlib_tpu_torch/csrc/ec_add.cu",
                        "gingerlib_tpu/ops/pallas_ec.py:580"),
        "ec_affine_pre": ("gingerlib_tpu_torch/csrc/ec_affine.cu",
                          "gingerlib_tpu/ops/pallas_ec.py:161"),
        "ec_affine_post": ("gingerlib_tpu_torch/csrc/ec_affine.cu",
                           "gingerlib_tpu/ops/pallas_ec.py:192"),
        "inv_tree_up": ("gingerlib_tpu_torch/csrc/inv_tree.cu",
                        "gingerlib_tpu/ops/pallas_ec.py:313"),
        # the tile that the TPU's recursion ends on, with the root's inverse
        "inv_tree_tail": ("gingerlib_tpu_torch/csrc/inv_tree.cu",
                          "gingerlib_tpu/ops/pallas_ec.py:366"),
        "inv_tree_down": ("gingerlib_tpu_torch/csrc/inv_tree.cu",
                          "gingerlib_tpu/ops/pallas_ec.py:342"),
    }
    for name, (source, replaces) in curve_meta.items():
        row = curve_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "lanes": row["lanes"],
            "max_abs_err": max(r["max_abs_err"]
                               for r in row.get("by_lanes", [row])),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            # no PyTorch call computes a curve addition or a 753-bit inverse
            "library_ms": None,
        })
        kernels[-1]["device_ms"] = row["device_ms"]
        if name == "ec_proj_add":
            kernels[-1]["by_lanes"] = row["by_lanes"]
        if name == "inv_tree_tail":
            kernels[-1]["products_of_lanes"] = row["below"]

    # ------------------------------------------------------------------
    # 2c. the RNS kernels (K7, K8) against their plain versions
    # ------------------------------------------------------------------
    g1r = CI.mnt4753_g1(ec_rns=True)
    rctx = rns.make_context(p)
    K_CH = rctx.k
    WDT = rns.crt_width(rctx)

    def madd_ops(terms, term_bits):
        """32-bit integer operations of a sum of `terms` products, each below
        2^term_bits: one 32-bit multiply-add a term, and a fold into a
        64-bit sum (two operations) each time the 32-bit one could fill."""
        return terms + 2 * -(-terms // (1 << (32 - term_bits)))

    # The work of one RNS multiply, from its formulas.  Channelwise, 32-bit
    # integer operations: about 10k channel products with their reductions
    # (multiply, high multiply, multiply, subtract, compare: 5 each) and 2k
    # alpha terms (below 2^25, a 32-bit sum: 1 each).  Inner products, on
    # the tensor cores: two k x k base extensions, each term a product of
    # two values below 2^14, i.e. four u8 x u8 products of their byte
    # splits, two operations (multiply and add) each.
    RNS_OPS = 5 * 10 * K_CH + 2 * K_CH
    RNS_TENSOR_OPS = 2 * K_CH * K_CH * 4 * 2
    # the count of PR 4-8, for the side-by-side line: the extensions' terms
    # as 32-bit multiply-adds (one a term, 64-bit folds) on the CUDA cores
    RNS_OPS_CUDA_CORES = 2 * K_CH * madd_ops(K_CH, 28) + RNS_OPS
    RES_BYTES = 2 * K_CH * 2        # an element's residues at 2 bytes each
    PACKED_BYTES = RK.LANES * 4     # what the packed int32 layout moves

    def k7_work(n):
        """(bytes, channelwise operations, tensor operations, operations as
        counted before) of n RNS multiplies."""
        return (3 * n * RES_BYTES, n * RNS_OPS, n * RNS_TENSOR_OPS,
                n * RNS_OPS_CUDA_CORES)

    def pre_work(n, dbl):
        """The same for pre on n lanes, dbl of them doubling: four digit
        rows to residues (2k sums of nd digit terms, each 16 x 14 bits: four
        byte products on the tensor cores; a 64-bit channel reduction, 10
        operations, a sum), four normalising multiplies and a squaring where
        a lane doubles, two channel subtractions (3 operations a channel)."""
        conv_before = 4 * 2 * K_CH * madd_ops(nd, 30)
        ch = n * (4 * 2 * K_CH * 10 + 4 * RNS_OPS + 2 * 2 * K_CH * 3) \
            + dbl * RNS_OPS
        return (n * (4 * elem_bytes + 2 + 5 * RES_BYTES + 2), ch,
                n * (4 * 2 * K_CH * nd * 4 * 2 + 4 * RNS_TENSOR_OPS)
                + dbl * RNS_TENSOR_OPS,
                n * (conv_before + 4 * RNS_OPS_CUDA_CORES + 2 * 2 * K_CH * 3)
                + dbl * RNS_OPS_CUDA_CORES)

    def post_work(n, live):
        """The same for post on n lanes, live of them not a select: five
        multiplies and five offset subtractions (6 operations a channel),
        two CRTs (wdt sums of k sigma terms on the tensor cores, k sigma
        products and alpha terms, the alpha subtraction of each column, the
        carries and borrows of nd + 1 digits and a subtraction: 6 k + 6 wdt
        + 8 (nd + 1))."""
        tail = 4 * WDT + 8 * (nd + 1)
        ch = live * (5 * RNS_OPS + 5 * 2 * K_CH * 6
                     + 2 * (6 * K_CH + 2 * WDT + tail))
        return (n * (5 * RES_BYTES + 6 * elem_bytes + 3), ch,
                live * (5 * RNS_TENSOR_OPS + 2 * K_CH * WDT * 4 * 2),
                live * (5 * RNS_OPS_CUDA_CORES + 5 * 2 * K_CH * 6
                        + 2 * (WDT * madd_ops(K_CH, 30) + tail)))

    def work_bounds(work):
        """(bound_ms, bound_by, bound_ms as counted before)."""
        nbytes, ops, tensor, before = work
        b_ms, b_by = bound(nbytes, ops, tensor)
        return b_ms, b_by, bound(nbytes, before)[0]

    def packed(F, digits):
        ctx = rns.make_context(F.modulus)
        return RK.pack_rns(ctx, *rns.to_rns_digits(ctx, digits))

    def field_digits(F, n, seed):
        """n seeded values below F's modulus (0, 1, p - 1 first) as
        digits on the device."""
        raw = torch.randint(0, 1 << 16, (n, F.n_digits + 4), dtype=torch.int64,
                            generator=torch.Generator().manual_seed(seed))
        vals = [v % F.modulus for v in limbs.from_digits_batch(raw)]
        vals[:3] = [0, 1, F.modulus - 1][:n]
        return vals, torch.from_numpy(
            limbs.to_digits_batch(vals[:n], F.n_digits)).to(dev)

    RNS_EDGES = (1, 15, 16, 17, 127, 128, 129)   # around the tile of 16
    RNS_WIDE = (1 << 15, 1 << 18, 1 << 19)

    def lanes_of(a_pt, b_pt, n, start=0):
        """Lanes start .. start + n - 1 of an addition's operands."""
        cut = lambda t: t[start:start + n]
        return tuple(((tuple(cut(c) for c in pt[0])), cut(pt[1]))
                     for pt in (a_pt, b_pt))

    def rns_case(points, n):
        """Operands of the RNS addition on n lanes (special lanes first;
        below 9 lanes, the first n of a 9-lane case) from the affine
        points, repeated as needed."""
        m = max(n, 9)
        copies = -(-m // points[0].shape[0])
        return lanes_of(*affine_case(g1, tuple(
            torch.cat([c] * copies) for c in points), m), n)

    def ec_rns_kernel_section():
        """K7 at MNT4-753 Fq [1] and [2^16] and BLS12-377 Fq [2^12], around
        the tile of 16 (1 .. 129 elements) and at 2^15, 2^18 and 2^19, with
        rows of every residue at m_i - 1, strided, broadcast and the paired
        down-sweep, six chained squarings against python's pow, times at 1,
        2^16 and 2^20 beside K1; K8's pre, tree and post at the same
        widths on MNT4-753 G1 lanes with the special lanes, against their
        plain versions, the whole addition at 2^16 also against the
        positional one (K5/K6), and BLS12-377 G1 at 256 lanes.
        Returns ({kernel: its row}, the line's dict)."""
        line, rows = {"channels": K_CH}, {}
        err7 = 0
        n16 = 1 << 16
        _, d16 = field_digits(fq, n16, seed=61)
        x16 = packed(fq, d16)
        m_row = torch.from_numpy(
            RK.kernel_consts(p)[:RK.LANES].astype("int64")).to(dev)
        x16[5] = x16[6] = torch.where(m_row > 1, m_row - 1, 0).to(
            torch.int32)                      # every residue at m_i - 1
        y16 = x16.roll(1, 0)
        for F, n in ((fq, 1), (fq, n16), (PP.BLS12_377_FQ, 1 << 12)):
            x = x16[5:6] if n == 1 else (
                x16 if F is fq else packed(F, field_digits(F, n, 62)[1]))
            y = x.roll(1, 0) if n > 1 else x16[7:8]
            err7 = max(err7, compare(
                f"rns_mont {F.name} [{n}]", RK.mont_mul_rns(F.modulus, x, y),
                RK.mont_mul_rns_plain(F.modulus, x, y)))
        # the tree's shapes: strided halves, one row against all, the paired
        # down-sweep
        err7 = max(err7, compare(
            "rns_mont even/odd halves", RK.mont_mul_rns(p, x16[0::2],
                                                        x16[1::2]),
            RK.mont_mul_rns_plain(p, x16[0::2], x16[1::2])), compare(
            "rns_mont one row against all", RK.mont_mul_rns(p, x16, y16[:1]),
            RK.mont_mul_rns_plain(p, x16, y16[:1])), compare(
            "rns_mont paired down-sweep", RK.mont_mul_rns_down(
                p, y16[:n16 // 2], x16),
            RK.mont_mul_rns_down_plain(p, y16[:n16 // 2], x16)))
        for n in RNS_EDGES + RNS_WIDE:
            x = x16.repeat(-(-n // n16), 1)[:n]
            y = x.roll(3, 0)
            err7 = max(err7, compare(f"rns_mont [{n}]", RK.mont_mul_rns(
                p, x, y), RK.mont_mul_rns_plain(p, x, y)))
            if n % 2 == 0:
                err7 = max(err7, compare(
                    f"rns_mont paired down-sweep [{n}]",
                    RK.mont_mul_rns_down(p, y[:n // 2], x),
                    RK.mont_mul_rns_down_plain(p, y[:n // 2], x)))
            del x, y
        # six chained squarings from x M_A, held to python's pow
        vals, d = field_digits(fq, 64, seed=63)
        r2 = torch.from_numpy(RK.rns_row(rctx, rctx.MA * rctx.MA % p)).to(
            dev)[None]
        cur = RK.mont_mul_rns(p, packed(fq, d), r2)
        want = list(vals)
        for i in range(6):
            nxt = RK.mont_mul_rns(p, cur, cur)
            err7 = max(err7, compare(f"rns_mont squaring {i}", nxt,
                                     RK.mont_mul_rns_plain(p, cur, cur)))
            cur = nxt
            want = [w * w % p for w in want]
            got = rns.from_rns(rctx, RK.unpack_rns(rctx, cur)[0])
            if any(g >= 3 * p for g in got) or \
                    [g % p for g in got] != [w * rctx.MA % p for w in want]:
                raise AssertionError("rns_mont: chained squarings disagree "
                                     "with pow")
        # times at 1, 2^16 and 2^20 lanes, K1 on as many elements beside
        k7 = []
        a16 = rand_elems(n16)
        for n in (1, n16, 1 << 20):
            x = x16.repeat(-(-n // n16), 1)[:n]
            a = a16.repeat(-(-n // n16), 1)[:n]
            reps = 200 if n == 1 else 20
            b_ms, b_by, b_before = work_bounds(k7_work(n))
            row = {"lanes": n, "ms": time_ms(
                lambda: RK.mont_mul_rns(p, x, x), reps),
                "device_ms": graph_ms(lambda: RK.mont_mul_rns(p, x, x), reps),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_ms_before": b_before,
                "packed_layout_bytes_ms":
                    3 * n * PACKED_BYTES / PEAK_BYTES_PER_S * 1e3,
                "k1_mont_mul_ms": time_ms(lambda: fp.mont_mul(fq, a, a), reps)}
            if n == n16:
                row["plain_ms"] = time_ms(
                    lambda: RK.mont_mul_rns_plain(p, x, x), 3)
                rows["rns_mont"] = dict(row, max_abs_err=err7)
            k7.append(row)
            del x, a
        line["rns_mont"] = k7

        def hold_k8(a_pt, b_pt, tag):
            """K8's pre, its K7 tree and its post against their plain
            versions on one batch: (the errors, the pre outputs, the
            inverses, the post's arguments)."""
            (x1, y1), inf1 = a_pt
            (x2, y2), inf2 = b_pt
            pre = ER.ecr_pre(g1r, x1, y1, x2, y2, inf1, inf2)
            e_pre = compare_all(f"ecr_pre [{tag}]", pre, ER.ecr_pre_plain(
                g1r, x1, y1, x2, y2, inf1, inf2))
            num, den, x1r, y1r, x2r, inf3, dead = pre
            dinv = ER.tree_inverse_rns(g1r, den, dead)
            e_tree = compare(f"tree_inverse_rns [{tag}]", dinv,
                             ER.tree_inverse_rns(g1r, den, dead, plain=True))
            post_args = (num, dinv, x1r, y1r, x2r, x1, y1, x2, y2, inf1,
                         inf2, inf3)
            e_post = compare_all(f"ecr_post [{tag}]",
                                 ER.ecr_post(g1r, *post_args),
                                 ER.ecr_post_plain(g1r, *post_args))
            return (e_pre, e_tree, e_post), pre, dinv, post_args

        # K8 around the tile and at wide batches; 2^18 is the path's largest
        # addition (msm_affine's first tree level over one chunk of 8
        # windows x 2^16 points)
        err_pre = err_post = 0
        pts = multiples(g1, 1 << 18, seed=66)[1]
        for n in RNS_EDGES + RNS_WIDE:
            for start in ((0, 8) if n == 1 else (0,)):
                case = rns_case(pts, n) if start == 0 else \
                    lanes_of(*rns_case(pts, 9), 1, start)
                e = hold_k8(*case, f"{n} from lane {start}")[0]
                err_pre, err7, err_post = (max(err_pre, e[0]), max(err7, e[1]),
                                           max(err_post, e[2]))
                del case
        del pts
        # ... and at 2^16 lanes, the width of the times below
        _, aff, _ = multiples(g1, n16, seed=64)
        a_pt, b_pt = affine_case(g1, aff, n16)
        (x1, y1), inf1 = a_pt
        (x2, y2), inf2 = b_pt
        errs, pre, dinv, post_args = hold_k8(a_pt, b_pt, "2^16")
        err_pre, err_post = max(err_pre, errs[0]), max(err_post, errs[2])
        err7 = max(err7, errs[1])
        rows["rns_mont"]["max_abs_err"] = err7
        num, den, x1r, y1r, x2r, inf3, dead = pre
        got = g1r.batch_affine_add(a_pt, b_pt)
        flat = lambda r: (r[0][0], r[0][1], r[1])
        compare_all("batch_affine_add rns [2^16] against its plain version",
                    flat(got), flat(ER.batch_affine_add_rns_plain(
                        g1r, a_pt, b_pt)))
        compare_all("batch_affine_add rns [2^16] against the positional "
                    "kernels", flat(got), flat(ec_kernels.batch_affine_add(
                        g1, a_pt, b_pt)))
        halves = (((x1[0::2], y1[0::2]), inf1[0::2]),
                  ((x2[1::2], y2[1::2]), inf2[1::2]))
        compare_all("batch_affine_add rns [2^15] even/odd",
                    flat(g1r.batch_affine_add(*halves)),
                    flat(ec_kernels.batch_affine_add(g1, *halves)))
        b1r = CI.bls12_377_g1(ec_rns=True)
        b1 = CI.bls12_377_g1()
        _, b_aff, _ = multiples(b1, 256, seed=65)
        ba, bb = affine_case(b1, b_aff, 256)
        compare_all("batch_affine_add rns bls12_377 [256]",
                    flat(b1r.batch_affine_add(ba, bb)),
                    flat(ec_kernels.batch_affine_add(b1, ba, bb)))
        for mixed in ((x16.cpu(), x16), (x16, x16.cpu())):
            try:
                RK.mont_mul_rns(p, *mixed)
            except ValueError:
                continue
            raise AssertionError("rns_mont took operands on two devices")

        dbl = int((~inf1 & ~inf2 & (x1 == x2).all(-1).reshape(-1)
                   & (y1 == y2).all(-1).reshape(-1)).sum())
        live = int((~(inf1 | inf2 | inf3)).sum())
        for name, err, work, kern, plain in (
                ("ecr_pre", err_pre, pre_work(n16, dbl),
                 lambda: ER.ecr_pre(g1r, x1, y1, x2, y2, inf1, inf2),
                 lambda: ER.ecr_pre_plain(g1r, x1, y1, x2, y2, inf1, inf2)),
                ("ecr_post", err_post, post_work(n16, live),
                 lambda: ER.ecr_post(g1r, *post_args),
                 lambda: ER.ecr_post_plain(g1r, *post_args))):
            b_ms, b_by, b_before = work_bounds(work)
            rows[name] = {"lanes": n16, "max_abs_err": err,
                          "ms": time_ms(kern, 10),
                          "device_ms": graph_ms(kern, 10),
                          "plain_ms": time_ms(plain, 2), "bound_ms": b_ms,
                          "bound_by": b_by, "bound_ms_before": b_before}
        before = dict(fp.launch_counts)
        g1r.batch_affine_add(a_pt, b_pt)
        launches = {k: v - before[k] for k, v in fp.launch_counts.items()
                    if v != before[k]}
        line["batch_affine_add_2p16"] = {
            "rns_ms": time_ms(lambda: g1r.batch_affine_add(a_pt, b_pt), 5),
            "rns_tree_ms": time_ms(
                lambda: ER.tree_inverse_rns(g1r, den, dead), 5),
            "positional_ms": time_ms(
                lambda: ec_kernels.batch_affine_add(g1, a_pt, b_pt), 5),
            "launches_a_rns_addition": launches,
            "doubling_lanes": dbl, "live_lanes": live}
        line["ecr_pre"], line["ecr_post"] = rows["ecr_pre"], rows["ecr_post"]
        print("RNS kernels agree with their plain versions on the device "
              "(tolerance 0)", flush=True)
        return rows, line

    ec_rows, ec_line = ec_rns_kernel_section()

    # ------------------------------------------------------------------
    # 3. Pippenger against double-and-add at 2^12 points; one 2^16-point
    #    MSM of each kind, timed
    # ------------------------------------------------------------------
    def msm_section():
        r_mod = fr.modulus

        def fr_scalars(n, seed):
            raw = torch.randint(
                0, 1 << 16, (n, fr.n_digits + 4), dtype=torch.int64,
                generator=torch.Generator().manual_seed(seed))
            return [v % r_mod for v in limbs.from_digits_batch(raw)]

        def closed_form(name, curve, host, got, ks, scalars):
            """The MSM of the multiples [k_i]G is [sum k_i s_i]G: held
            against python-int curve arithmetic."""
            total = sum(k * s for k, s in zip(ks, scalars)) % r_mod
            x, y = curve.to_affine(tuple(c[None] for c in got))
            if groth16.affine_to_ints(curve, (x[0], y[0])) \
                    != host.mul(host.gen, total):
                raise AssertionError(f"{name}: not [sum k_i s_i]G")

        def same_point(name, curve, got, want):
            if not bool(curve.eq(got, want)):
                raise AssertionError(f"{name}: not the same point")
            ga = curve.to_affine(tuple(c[None] for c in got))
            wa = curve.to_affine(tuple(c[None] for c in want))
            compare_all(name + " affine digits", ga, wa)

        n12 = 1 << 12
        for curve in (g1, g2):
            _, (ax, ay), _ = multiples(curve, n12, seed=9)
            sc = fr_scalars(n12, seed=10)
            ax[1], ay[1] = ax[0], ay[0]         # the same point twice ...
            sc[1] = sc[0]                       # ... in the same buckets
            sc[2] = 0
            sd = torch.from_numpy(
                limbs.to_digits_batch(sc, fr.n_digits)).to(dev)
            inf = torch.zeros(n12, dtype=torch.bool, device=dev)
            inf[5] = True
            want = msm_mod.msm_naive(curve, ax, ay, sd, inf_mask=inf)
            if curve is g1:
                for cutoff in (1 << 15, 64):
                    same_point(f"msm_hybrid 2^12 cutoff {cutoff}", g1,
                               msm_mod.msm_hybrid(g1, ax, ay, sd, inf_mask=inf,
                                                  affine_cutoff=cutoff), want)
                same_point("msm_bucketed 2^12 g1", g1, msm_mod.msm_bucketed(
                    g1, ax, ay, sd, inf_mask=inf), want)
                same_point("msm_affine rns 2^12 g1", g1, msm_mod.msm_affine(
                    g1r, ax, ay, sd, inf_mask=inf), want)
            else:
                same_point("msm_affine 2^12 g2", g2, msm_mod.msm_affine(
                    g2, ax, ay, sd, inf_mask=inf), want)
        print("msm_hybrid (g1), msm_affine over RNS g1 and msm_affine (g2) "
              "equal msm_naive at 2^12 points", flush=True)

        n16 = 1 << 16
        sc = fr_scalars(n16, seed=11)
        sd = torch.from_numpy(limbs.to_digits_batch(sc, fr.n_digits)).to(dev)
        msm_line = {"points": n16}
        host_g1, host_g2, _ = groth16_host.host_curves("mnt4753")
        _, (ax, ay), ks = multiples(g1, n16, seed=13)
        msm_mod.msm_hybrid(g1, ax, ay, sd)    # warm-up: the allocator's pools
        results = {}
        for label, cutoff in (("default_2p15", 1 << 15), ("all_affine", 1),
                              ("all_projective", 1 << 30)):
            results[label], secs = event_seconds(lambda: msm_mod.msm_hybrid(
                g1, ax, ay, sd, affine_cutoff=cutoff))
            msm_line[f"g1_hybrid_{label}_s"] = secs
            msm_line[f"g1_hybrid_{label}_points_per_s"] = n16 / secs
        for label in ("all_affine", "all_projective"):
            same_point(f"msm_hybrid 2^16 {label}", g1, results[label],
                       results["default_2p15"])
        closed_form("msm_hybrid 2^16", g1, host_g1, results["default_2p15"],
                    ks, sc)
        # the RNS path: msm_affine over MNT4-753 G1 with ec_rns=True on the
        # same points and scalars, launches counted from zero; then the
        # positional msm_affine over G1 beside it
        fp.reset_launch_counts()
        ec_kernels.reset_launch_widths()
        res, secs = event_seconds(lambda: msm_mod.msm_affine(g1r, ax, ay, sd))
        path = {"points": n16, "seconds": secs, "points_per_s": n16 / secs,
                "path_launches": {k: v for k, v in fp.launch_counts.items()
                                  if v},
                "launches_by_width": {
                    k: dict(sorted(ec_kernels.launch_widths[k].items()))
                    for k in ec_kernels.RNS_KERNELS}}
        # K7 on the path: an addition of n lanes pads to 2^L >= 128 lanes
        # and multiplies L levels up, once at the root and L levels down,
        # each level one launch
        want_k7 = sum(c * (2 * max(7, (n - 1).bit_length()) + 1)
                      for n, c in path["launches_by_width"]["ecr_pre"].items())
        if path["path_launches"].get("rns_mont") != want_k7 or \
                want_k7 != RNS_PATH_K7_LAUNCHES:
            raise AssertionError(
                f"K7 launched {path['path_launches'].get('rns_mont')} times "
                f"on the RNS path: the additions' widths give {want_k7}, "
                f"and 2^16 points {RNS_PATH_K7_LAUNCHES}")
        same_point("msm_affine rns 2^16 against msm_hybrid", g1, res,
                   results["default_2p15"])
        closed_form("msm_affine rns 2^16", g1, host_g1, res, ks, sc)
        res, path["positional_msm_affine_s"] = event_seconds(
            lambda: msm_mod.msm_affine(g1, ax, ay, sd))
        same_point("msm_affine 2^16 g1 against msm_hybrid", g1, res,
                   results["default_2p15"])
        path["msm_hybrid_s"] = msm_line["g1_hybrid_default_2p15_s"]
        _, (bx, by), ks = multiples(g2, n16, seed=12)
        res, secs = event_seconds(lambda: msm_mod.msm_affine(g2, bx, by, sd))
        closed_form("msm_affine 2^16", g2, host_g2, res, ks, sc)
        msm_line["g2_affine_s"] = secs
        msm_line["g2_affine_points_per_s"] = n16 / secs
        print("msm " + json.dumps(msm_line), flush=True)
        return path

    ec_line["path"] = ec_path = msm_section()
    print("ec_rns " + json.dumps(ec_line), flush=True)

    def ec_rns_by_width(widths):
        """K7, pre and post at the widths the 2^16-point RNS msm_affine
        launched them, as ``inv_tree_by_width``: K7 on seeded residues, pre
        and post on lanes of 2^18 seeded points (repeated above 2^18 lanes)
        with the special lanes first, each checked against its plain
        version."""
        rows = []
        _, d16 = field_digits(fq, 1 << 16, seed=67)
        x16 = packed(fq, d16)
        for label, launches, n_widths, n in classes_of(
                "rns_mont", widths["rns_mont"]):
            x = x16.repeat(-(-n // x16.shape[0]), 1)[:n]
            y = x.roll(1, 0)
            compare(f"rns_mont [{n}]", RK.mont_mul_rns(p, x, y),
                    RK.mont_mul_rns_plain(p, x, y))
            nbytes, ops, tensor, _ = k7_work(n)
            rows.append(timed_row("rns_mont", label, launches, n_widths, n,
                                  lambda: RK.mont_mul_rns(p, x, y), nbytes,
                                  ops, tensor))
            del x, y
        pts = multiples(g1, 1 << 18, seed=7)[1]
        for label, launches, n_widths, n in classes_of(
                "ecr_pre", widths["ecr_pre"]):
            a_pt, b_pt = rns_case(pts, n)
            (x1, y1), inf1 = a_pt
            (x2, y2), inf2 = b_pt
            pre = ER.ecr_pre(g1r, x1, y1, x2, y2, inf1, inf2)
            compare_all(f"ecr_pre [{n}]", pre, ER.ecr_pre_plain(
                g1r, x1, y1, x2, y2, inf1, inf2))
            num, den, x1r, y1r, x2r, inf3, dead = pre
            dinv = ER.tree_inverse_rns(g1r, den, dead)
            post_args = (num, dinv, x1r, y1r, x2r, x1, y1, x2, y2, inf1,
                         inf2, inf3)
            compare_all(f"ecr_post [{n}]", ER.ecr_post(g1r, *post_args),
                        ER.ecr_post_plain(g1r, *post_args))
            dbl = int((~inf1 & ~inf2 & (x1 == x2).all(-1).reshape(-1)
                       & (y1 == y2).all(-1).reshape(-1)).sum())
            live = int((~(inf1 | inf2 | inf3)).sum())
            nbytes, ops, tensor, _ = pre_work(n, dbl)
            rows.append(timed_row(
                "ecr_pre", label, launches, n_widths, n,
                lambda: ER.ecr_pre(g1r, x1, y1, x2, y2, inf1, inf2),
                nbytes, ops, tensor))
            nbytes, ops, tensor, _ = post_work(n, live)
            rows.append(timed_row(
                "ecr_post", label, launches, n_widths, n,
                lambda: ER.ecr_post(g1r, *post_args), nbytes, ops, tensor))
            del a_pt, b_pt, x1, y1, x2, y2, pre, num, den, dinv, post_args
        return rows

    rns_by_width = ec_rns_by_width(ec_path["launches_by_width"])
    print("ec_rns_by_width " + json.dumps(loss_line(rns_by_width)),
          flush=True)
    for name, replaces in (("rns_mont", "gingerlib_tpu/ops/pallas_rns.py:187"),
                           ("ecr_pre", "gingerlib_tpu/ops/pallas_ec_rns.py:289"),
                           ("ecr_post",
                            "gingerlib_tpu/ops/pallas_ec_rns.py:307")):
        row = ec_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gingerlib_tpu_torch/csrc/" + (
                "rns_mont.cu" if name == "rns_mont" else "ec_rns.cu"),
            "replaces": replaces, "launches": 0, "lanes": 1 << 16,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bound_ms_before": row["bound_ms_before"],
            # no PyTorch call computes an RNS multiply or a curve addition
            "library_ms": None,
            "by_width": [
                {key: r[key] for key in ("class", "launches", "timed_width",
                                         "ms", "device_ms", "bound_ms",
                                         "loss_ms")}
                for r in rns_by_width if r["kernel"] == name],
        })

    # ------------------------------------------------------------------
    # 3b. the pow chain (K3) and the Poseidon permutation (K9) against
    #     their plain versions, on the device
    # ------------------------------------------------------------------

    def field_elems(F, n, seed, bound=None):
        """n seeded integers below ``bound`` (default p) of field F: the
        python ints and their digits on the device (standard form)."""
        raw = torch.randint(0, 1 << 16, (n, F.n_digits + 4), dtype=torch.int64,
                            generator=torch.Generator().manual_seed(seed))
        vals = [v % (bound or F.modulus) for v in limbs.from_digits_batch(raw)]
        return vals, torch.from_numpy(
            limbs.to_digits_batch(vals, F.n_digits)).to(dev)

    POW_N = 1 << 12          # the field-API phase's batch

    pow_window = cuda_lib.function("gl_pow_const_window")

    def pow_section():
        """K3 against ``pow_const_plain`` at [1, 48] and [4096, 48] for the
        Legendre and square-root exponents of MNT4-753 Fq and Fr and one
        short exponent; returns (max error, the rows).  Each row's bound
        counts the chain the kernel runs (its window's multiplies, the
        launcher's own count, which must be ``fp.pow_window``'s), and
        ``bound_ms_before`` the binary ladder's bits + popcount."""
        cases = []
        for F in (fq, fr):
            cases += [(F, "legendre", F.legendre_exp_bits),
                      (F, "sqrt", F.sqrt_exp_bits)]
        cases.append((fq, "short 0x9e3779b9",
                      limbs.bits_msb_first(0x9E3779B9, 32)))
        err, rows = 0, []
        for F, label, bits in cases:
            _, a = field_elems(F, POW_N, seed=21)
            a[:3] = torch.from_numpy(limbs.to_digits_batch(
                [0, F.r, F.modulus - 1], F.n_digits)).to(dev)
            nbits, ones = len(bits), int(bits.sum())
            w, _ = fp.pow_window(bits)
            muls = fp.pow_window_muls(bits, w)
            b = np.ascontiguousarray(bits, dtype=np.uint8)
            kmuls = ctypes.c_int()
            if (pow_window(b.ctypes.data, b.size, ctypes.byref(kmuls)),
                    kmuls.value) != (w, muls):
                raise AssertionError(f"pow_const {label}: the launcher's "
                                     f"window is not fp.pow_window's")
            for n in (1, POW_N):
                x = a[5:6] if n == 1 else a
                got = fp.pow_const(F, x, bits)
                want, plain_s = event_seconds(
                    lambda: fp.pow_const_plain(F, x, bits))
                case_err = compare(f"pow_const {F.name} {label} [{n},48]",
                                   got, want)
                err = max(err, case_err)
                # the window chain's multiplies an element; the ladder's
                # bits squarings and popcount multiplies before it
                b_ms, b_by = bound(2 * n * elem_bytes, n * muls * MUL_OPS)
                old_ms, _ = bound(2 * n * elem_bytes,
                                  n * (nbits + ones) * MUL_OPS)
                rows.append({"field": F.name, "exponent": label,
                             "bits": nbits, "rows": n, "window": w,
                             "multiplies": muls,
                             "ladder_multiplies": nbits + ones,
                             "max_abs_err": case_err,
                             "ms": time_ms(lambda: fp.pow_const(F, x, bits),
                                           5),
                             "device_ms": graph_ms(
                                 lambda: fp.pow_const(F, x, bits), 5),
                             "plain_ms": plain_s * 1e3, "bound_ms": b_ms,
                             "bound_by": b_by, "bound_ms_before": old_ms})
        for small in (PP.BLS12_377_FQ, PP.BLS12_377_FR):
            _, x = field_elems(small, 64, seed=22)
            bits = small.legendre_exp_bits
            err = max(err, compare(
                f"pow_const {small.name}", fp.pow_const(small, x, bits),
                fp.pow_const_plain(small, x, bits)))
        return err, rows

    pow_err, pow_rows = pow_section()
    print("pow_kernel_shapes " + json.dumps(pow_rows), flush=True)

    P4 = PoseidonParams.mnt4753()
    P6 = PoseidonParams.mnt6753()
    host4 = PoseidonHost.mnt4753()
    host6 = PoseidonHost.mnt6753()
    POS_B = 1 << 15          # the 2^16-leaf tree's largest level

    def plain_permute_roots(P, state):
        """Runs ``permute_plain`` and returns (its output, the plain
        integers its shared inversions took, one a round): the inputs of
        the function's own inversions."""
        roots, real = [], fp.inv_bea

        def record(F, a):
            roots.append(a)
            return real(F, a)
        fp.inv_bea = record
        try:
            out = PK.permute_plain(P, state)
        finally:
            fp.inv_bea = real
        return out, [limbs.from_digits(r[0].cpu()) for r in roots]

    def permute_work(P, n, roots):
        """(bytes, 32-bit integer operations) the permutation of n sponges
        needs: 3 elements in and out a sponge; a round's S-box by ONE
        shared inversion for the whole batch, 3 multiplies for each element
        it inverts (3 a sponge in a full round, 1 in a partial one) and the
        inversion of the round's root, counted as K2's row counts it; 9
        multiplies and 6 modular additions for the mix of each round but
        the last, and 3 additions of round constants a round."""
        muls = n * (9 * (2 * P.r_f) + 3 * P.r_p + 9 * (P.n_rounds - 1))
        adds = n * (6 * (P.n_rounds - 1) + 3 * P.n_rounds)
        inv = sum(inv_ops(v, P.field.modulus) for v in roots)
        return (2 * n * 3 * elem_bytes, muls * MUL_OPS + adds * 2 * L + inv)

    SMS = torch.cuda.get_device_properties(dev).multi_processor_count

    def block_s(n):
        """The sponges a block K9's launcher takes for a batch of n (its
        own answer, which must be ``block_sponges``'s)."""
        s_ = PK.block_sponges_cuda(n)
        if s_ != PK.block_sponges(n, SMS):
            raise AssertionError(f"poseidon: the launcher takes S = {s_} "
                                 f"at {n} sponges, block_sponges says "
                                 f"{PK.block_sponges(n, SMS)}")
        return s_

    def poseidon_section():
        """K9 against ``permute_plain``: the zero state of both parameter
        sets, then 2^15 seeded sponges with special lanes, some lanes also
        against the python-int oracle; returns (max error, the rows)."""
        err, rows = 0, []
        for name, P, host in (("mnt4753", P4, host4), ("mnt6753", P6, host6)):
            F = P.field
            zero = torch.zeros((1, 3, nd), dtype=torch.int64, device=dev)
            got = PK.permute(P, zero)
            err = max(err, compare(f"poseidon {name} zero state", got,
                                   PK.permute_plain(P, zero)))
            if not torch.equal(got[0], P.after_zero_perm):
                raise AssertionError(f"poseidon {name}: the zero state does "
                                     f"not give AFTER_ZERO_PERM")
            vals, flat = field_elems(F, 3 * POS_B, seed=23)
            state = fp.to_mont(F, flat).reshape(POS_B, 3, nd)
            p_1 = fp.to_mont(F, torch.from_numpy(limbs.to_digits_batch(
                [F.modulus - 1], nd)).to(dev))[0]
            neg_rc0 = fp.neg_mod(F, P.rc[0])
            state[0] = 0                       # the all-zero state
            state[1] = neg_rc0                 # zero after the first add
            state[2, 1] = neg_rc0[1]           # one element zero after it
            state[3] = p_1                     # p - 1 everywhere
            state[4, 0] = p_1
            state[5, 2] = 0
            got = PK.permute_cuda(P, state)
            want, plain_s = event_seconds(lambda: PK.permute_plain(P, state))
            _, roots = plain_permute_roots(P, state)
            if len(roots) != P.n_rounds:
                raise AssertionError(f"poseidon {name}: the plain version "
                                     f"inverted {len(roots)} times, not once "
                                     f"a round")
            err = max(err, compare(f"poseidon {name} [{POS_B},3,48]", got,
                                   want))
            head = fp.fp_to_ints(F, state[:8].reshape(-1, nd).cpu())
            outs = fp.fp_to_ints(F, got[:8].reshape(-1, nd).cpu())
            for i in range(8):
                lane = slice(3 * i, 3 * i + 3)
                if host.permute(head[lane]) != outs[lane]:
                    raise AssertionError(f"poseidon {name} lane {i}: not the "
                                         f"python-int permutation")
            b_ms, b_by = bound(*permute_work(P, POS_B, roots))
            row = {"params": name, "sponges": POS_B,
                   "S": block_s(POS_B), "max_abs_err": err,
                   "ms": time_ms(lambda: PK.permute(P, state), 5),
                   "device_ms": graph_ms(lambda: PK.permute(P, state), 3),
                   "plain_ms": plain_s * 1e3, "bound_ms": b_ms,
                   "bound_by": b_by,
                   # diagnostic, not the bound: the kernel's design inverts
                   # once a round in every sponge, the function once a round
                   "inversions_by_the_kernel": POS_B * P.n_rounds,
                   "inversions_the_function_needs": P.n_rounds}
            _, plain1_s = event_seconds(
                lambda: PK.permute_plain(P, state[6:7]))
            _, roots1 = plain_permute_roots(P, state[6:7])
            b1_ms, b1_by = bound(*permute_work(P, 1, roots1))
            row["one_sponge"] = {
                "S": block_s(1),
                "ms": time_ms(lambda: PK.permute(P, state[6:7]), 10),
                "device_ms": graph_ms(lambda: PK.permute(P, state[6:7]), 10),
                "plain_ms": plain1_s * 1e3, "bound_ms": b1_ms,
                "bound_by": b1_by}
            rows.append(row)
        return err, rows

    pos_err, pos_rows = poseidon_section()
    print("poseidon_kernel_shapes " + json.dumps(pos_rows), flush=True)
    print("pow chain and Poseidon kernels agree with their plain versions on "
          "the device (tolerance 0)", flush=True)
    for name, row, source, replaces in (
            ("pow_const", next(r for r in pow_rows if r["rows"] == POW_N
                               and r["field"] == fq.name
                               and r["exponent"] == "legendre"),
             "gingerlib_tpu_torch/csrc/pow_const.cu",
             "gingerlib_tpu/ops/pallas_mont.py:864"),
            ("poseidon_permute", pos_rows[0],
             "gingerlib_tpu_torch/csrc/poseidon.cu",
             "gingerlib_tpu/ops/pallas_poseidon.py:503")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": pow_err if name == "pow_const" else pos_err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            # no PyTorch call computes a modular power or a permutation
            "library_ms": None,
        })
        kernels[-1]["device_ms"] = row["device_ms"]
        if name == "poseidon_permute":
            kernels[-1]["S"] = row["S"]
        else:
            kernels[-1]["window"] = row["window"]
            kernels[-1]["bound_ms_before"] = row["bound_ms_before"]
            kernels[-1]["by_rows"] = [
                {key: r[key] for key in (
                    "rows", "window", "ms", "device_ms", "plain_ms",
                    "bound_ms", "bound_ms_before", "max_abs_err")}
                for r in pow_rows if r["field"] == fq.name
                and r["exponent"] == "legendre"]

    # ------------------------------------------------------------------
    # 4./5. the main path
    # ------------------------------------------------------------------

    def prove(params, compiled, cs, s=S_BLIND, engine=None):
        """(the proof as python ints, seconds, the proof on the device)"""
        engine = engine or eng
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = groth16.create_proof(engine, params, compiled,
                                     cs.assignment(), r=R_BLIND, s=s)
        ints = groth16.proof_to_ints(engine, proof)   # fetch: a barrier
        return ints, time.perf_counter() - t, proof

    class phase_clock:
        """While active, times the calls that make up setup and prove --
        the QAP at the toxic point, the window bases' host ladder, each
        fixed-base table and windowed query, each kind of MSM, setup's
        pairing -- or those of ``targets`` (module or object, attribute
        name), with a device synchronise on either side of each call (a few
        dozen calls a rung, so the synchronises cost nothing that shows)."""
        labels = {"qap_at_device": "qap", "sap_at_device": "sap",
                  "fixed_base_msm_windowed": "fixed_base_windowed"}

        @staticmethod
        def prover(engine, system=groth16):
            """The phases of one proof system's setup and prove."""
            return ((system, "sap_at_device" if system is gm17
                     else "qap_at_device"),
                    (msm_mod, "_window_bases"),
                    (msm_mod, "fixed_base_table"),
                    (msm_mod, "fixed_base_msm_windowed"),
                    (msm_mod, "_msm_lanes"), (msm_mod, "msm_hybrid"),
                    (msm_mod, "msm_affine"),
                    (system, "_sap_witness_core" if system is gm17
                     else "_witness_map_core"), (engine, "pairing"))

        def __init__(self, targets=None):
            self.targets = targets or self.prover(eng)
            self.calls = []
            self.query_scalars = {}   # scalars of each windowed query
            self.launches = {}        # kernel launches by phase, summed

        def __enter__(self):
            # (owner, name, callable, whether the owner itself holds it: a
            # module's function, not an object's method)
            self.saved = [(m, n, getattr(m, n), n in vars(m))
                          for m, n in self.targets]
            for owner, name, real, _ in self.saved:
                setattr(owner, name, self.timed(name, real))
            return self

        def __exit__(self, *exc):
            for owner, name, real, own in self.saved:
                if own:
                    setattr(owner, name, real)
                else:
                    delattr(owner, name)

        def timed(self, name, real):
            def call(*a, **k):
                before = dict(fp.launch_counts)
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = real(*a, **k)
                torch.cuda.synchronize()
                what = self.labels.get(name, name.lstrip("_"))
                if a and hasattr(a[0], "F"):          # a curve comes first
                    what += ".g1" if a[0].F.K == 1 else ".g2"
                self.calls.append((what, time.perf_counter() - t))
                mine = self.launches.setdefault(what, {})
                for key, v in fp.launch_counts.items():
                    if v > before[key]:
                        mine[key] = mine.get(key, 0) + v - before[key]
                if name == "fixed_base_msm_windowed":
                    self.query_scalars[what] = \
                        self.query_scalars.get(what, 0) + a[2].shape[0]
                return out
            return call

        def take(self):
            """{phase: [seconds of each call]} since the last take."""
            out = {}
            for what, secs in self.calls:
                out.setdefault(what, []).append(secs)
            self.calls = []
            return out

    def rung(log2, phases=None, family="mnt4753", constraints=None,
             circuit=None):
        """Setup and prove at 2^log2 constraints (or ``constraints``) over
        ``family``, on the benchmark circuit or on ``circuit`` (its name
        and constraint system); ``phases``: True to time the calls inside
        with a ``phase_clock``."""
        engine = engines[family]
        if phases is True:
            with phase_clock(phase_clock.prover(engine)) as clock:
                return rung(log2, clock, family, constraints, circuit)
        fr_ = engine.g1.scalar_field
        if circuit is None:
            cs, _ = benchmark_circuit(fr_, NUM_INPUTS,
                                      constraints or 1 << log2)
        else:
            _, cs = circuit
        if not cs.is_satisfied():
            raise AssertionError("the rung's circuit is not satisfied")

        def oracles():
            t = time.perf_counter()
            qap = groth16_host.qap_at(cs, TOXIC["t"])
            qap_s = time.perf_counter() - t
            want = groth16_host.expected_proof(
                family, cs, **TOXIC, r=R_BLIND, s=S_BLIND, qap=qap)
            return qap, want, qap_s, time.perf_counter() - t - qap_s

        # setup's QAP and the closed-form proof in python ints, in a forked
        # process while the card sets up and proves
        oracle = HostOracle(oracles)
        out = {"log2_constraints": log2}
        if family != "mnt4753" or circuit is not None:
            out.update(family=family, constraints=cs.num_constraints)
        if circuit is not None:
            out.update(circuit=circuit[0], inputs=cs.num_inputs)
        # every rung builds its fixed-base tables, as a first setup in a
        # process does (later setups on the same curve reuse them)
        groth16.setup_table.cache_clear()
        fp.reset_launch_counts()
        ec_kernels.reset_launch_widths()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with layout_log() as layouts:
            compiled = compile_r1cs(cs)
            params = groth16.generate_parameters(engine, cs, **TOXIC)
            torch.cuda.synchronize()
        out["setup_s"] = time.perf_counter() - t
        setup_layouts[family, log2] = layouts.seen
        out["setup_launches"] = dict(fp.launch_counts)
        if phases:
            out["setup_phases_s"] = phases.take()
            out["setup_query_scalars"] = phases.query_scalars
            out["setup_phase_launches"] = phases.launches
            out["setup_pairing_launches"] = phases.launches.get("pairing")
            phases.query_scalars, phases.launches = {}, {}
        proof, out["prove_first_s"], proof_dev = prove(params, compiled, cs,
                                                       engine=engine)
        if phases:
            out["prove_phases_s"] = phases.take()
            out["prove_phase_launches"] = phases.launches
            phases.launches = {}
        out["path_launches"] = dict(fp.launch_counts)
        out["path_launches_by_digits"] = {
            k: dict(v) for k, v in fp.launch_digits.items() if v}
        out["prove_launches"] = {
            k: v - out["setup_launches"][k]
            for k, v in out["path_launches"].items()}
        out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
        curve_keys = [k for k in ec_kernels.launch_widths
                      if k not in ec_kernels.RNS_KERNELS]
        out["curve_launches_by_width"] = {
            k: dict(sorted(ec_kernels.launch_widths[k].items()))
            for k in curve_keys}
        out["curve_launches_by_lanes"] = {
            k: ec_kernels.launches_by_class(k) for k in curve_keys}
        # the proof against the closed form, and setup's QAP on the device
        # against the python-int oracle, every value of a, b and c, Z(t)
        # and m
        t = time.perf_counter()
        (qap, want, out["qap_host_oracle_s"], out["oracle_host_s"]), _ = \
            oracle.get()
        out["oracle_wait_s"] = time.perf_counter() - t
        if proof != want:
            raise AssertionError(f"2^{log2}: device proof differs from the "
                                 f"closed-form oracle")
        got = groth16.qap_at_device(cs, TOXIC["t"])
        if [fp.fp_to_ints(fr_, v) for v in got[:3]] != list(qap[:3]) \
                or (got[3], got[4].size) != qap[3:]:
            raise AssertionError(f"2^{log2}: the device QAP differs from "
                                 f"qap_at")
        out["qap_equals_host_oracle"] = True
        del got
        return out, (cs, compiled, params, proof, proof_dev, qap)

    verify_line = {"rungs": {}, "checks": {}}
    setup_layouts = {}     # {(family, log2): the field kernels' layouts
    #                          in setup}

    def verify(params, proof, inputs, label, engine=None, checks=None):
        """One call of ``verify_proof`` (its bool is on the host, so the
        call is complete), timed by the host's clock; its result goes into
        ``checks`` (by default the verify line's) under ``label``."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        ok = groth16.verify_proof(engine or eng, params.vk, proof, inputs)
        secs = time.perf_counter() - t
        (verify_line["checks"] if checks is None else checks)[label] = ok
        return ok, secs

    def verify_rung(log2, cs, params, proof, engine=None, line=None):
        """Verify the rung's proof twice, launches counted on the first;
        it must be accepted."""
        line = line or verify_line
        inputs = cs.input_values[1:]
        fp.reset_launch_counts()
        ok, first = verify(params, proof, inputs, f"2^{log2}", engine)
        launches = dict(fp.launch_counts)
        ok2, steady = verify(params, proof, inputs, f"2^{log2} again",
                             engine)
        if not (ok and ok2):
            raise AssertionError(f"2^{log2}: verify_proof refused the proof")
        line["rungs"][f"2^{log2}"] = {
            "verify_first_s": first, "verify_steady_s": steady,
            "launches": launches}

    serial_line = {"rungs": {}}

    def serialization(log2, cs, params, want, proof_dev, engine=None,
                      line=None):
        """The proof and the vk through bytes and back: the decoded proof
        equals the device one and verifies under the decoded vk, and its
        bytes are those written from the oracle's python-int
        coordinates."""
        engine = engine or eng
        line = line or serial_line
        width = 8 * -(-engine.fp.modulus_bits // 64)    # u64 limbs

        def le(v):
            return v.to_bytes(width, "little")

        t = time.perf_counter()
        raw = serialize.proof_to_bytes(engine, proof_dev)
        back, used = serialize.proof_from_bytes(engine, raw)
        vk_raw = serialize.vk_to_bytes(engine, params.vk)
        vk, vk_used = serialize.vk_from_bytes(engine, vk_raw)
        secs = time.perf_counter() - t
        oracle = b"".join(b"".join(le(v) for v in want[k][0] + want[k][1]) +
                          b"\x00" for k in ("a", "b", "c"))
        if raw != oracle:
            raise AssertionError(f"2^{log2}: proof bytes differ from the "
                                 f"oracle's")
        if used != len(raw) or not all(torch.equal(u, v) for u, v in zip(
                (*back.a, *back.b, *back.c),
                (*proof_dev.a, *proof_dev.b, *proof_dev.c))):
            raise AssertionError(f"2^{log2}: the proof does not round-trip")
        if vk_used != len(vk_raw) or \
                serialize.vk_to_bytes(engine, vk) != vk_raw or not all(
                    torch.equal(u, v) for u, v in zip(
                        (vk.alpha_g1_beta_g2, *vk.gamma_g2, *vk.delta_g2,
                         *vk.gamma_abc_g1),
                        (params.vk.alpha_g1_beta_g2, *params.vk.gamma_g2,
                         *params.vk.delta_g2, *params.vk.gamma_abc_g1))):
            raise AssertionError(f"2^{log2}: the vk does not round-trip")
        if not groth16.verify_proof(engine, vk, back, cs.input_values[1:]):
            raise AssertionError(f"2^{log2}: the decoded proof does not "
                                 f"verify under the decoded vk")
        line["rungs"][f"2^{log2}"] = {
            "proof_bytes": len(raw), "vk_bytes": len(vk_raw),
            "proof_and_vk_to_and_from_bytes_s": secs,
            "equal_to_oracle_bytes": True, "decoded_proof_verifies": True}

    def queries_against_loop(cs, params, qap):
        """The windowed setup's queries against the double-and-add loop
        ``fixed_base_msm`` and ``to_affine``: the first 4,096 scalars of
        each G1 query and the whole G2 query, and full-width scalars (0,
        1, 2, r - 1, r - 2, 2^752, (r - 1) / 2, r - 2^700) through the
        setup's tables."""
        a, b, c, zt, m = qap
        r = fr.modulus
        al, be, de = (TOXIC[k] for k in ("alpha", "beta", "delta"))
        ni = cs.num_inputs
        d_inv = pow(de, -1, r)
        comb = [(be * a[i] + al * b[i] + c[i]) % r for i in range(len(a))]
        scalars = {
            "a_query": a, "b_g1_query": b,
            "h_query": [zt * d_inv * pow(TOXIC["t"], i, r) % r
                        for i in range(m - 1)],
            "l_query": [v * d_inv % r for v in comb[ni:]]}
        special = [0, 1, 2, r - 1, r - 2, 1 << 752, (r - 1) >> 1,
                   r - (1 << 700)]
        t = time.perf_counter()
        checked = {}
        for curve, jobs in ((g1, [(k, v[:4096]) for k, v in scalars.items()]),
                            (g2, [("b_g2_query", b)])):
            ks = [k for _, v in jobs for k in v] + special
            sd = torch.from_numpy(limbs.to_digits_batch(
                [k % r for k in ks], fr.n_digits)).to(dev)
            wx, wy = curve.to_affine(msm_mod.fixed_base_msm(
                curve, curve.generator_affine, sd))
            (sx, sy), sinf = msm_mod.fixed_base_msm_windowed(
                curve, groth16.setup_table(curve), sd[-len(special):],
                groth16.SETUP_WINDOW, fr.modulus_bits)
            if not (torch.equal(sx, wx[-len(special):])
                    and torch.equal(sy, wy[-len(special):])
                    and sinf.tolist() == [k % r == 0 for k in special]):
                raise AssertionError(f"{curve.name}: the windowed query "
                                     f"differs at full-width scalars")
            start = 0
            for name, v in jobs:
                xs, ys, inf = getattr(params, name)
                n = len(v)
                if not (torch.equal(xs[:n], wx[start:start + n])
                        and torch.equal(ys[:n], wy[start:start + n])
                        and inf[:n].tolist() == [k == 0 for k in v]):
                    raise AssertionError(f"{name} differs from the "
                                         f"double-and-add loop")
                checked[name] = n
                start += n
        return {"scalars_checked": checked,
                "full_width_scalars_checked": len(special),
                "seconds": time.perf_counter() - t}

    def count_aten_ops(fn):
        """Every ATen operator PyTorch dispatches while ``fn`` runs, by
        name: the launches beside the hand-written kernels."""
        from torch.utils._python_dispatch import TorchDispatchMode
        counts = {}

        class Counter(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                key = func.overloadpacket.__name__
                counts[key] = counts.get(key, 0) + 1
                return func(*args, **(kwargs or {}))

        with Counter():
            fn()
        return counts

    # MNT4-753 at 2^10 and 2^16 constraints (a 2^6 rung would run the
    # 2^10 rung's code at a smaller depth; its time goes to the MNT6-753
    # and GM17 paths)
    big, (cs10, compiled10, params10, proof10, dev10, qap10) = rung(
        10, phases=True)
    again, big["prove_steady_s"], _ = prove(params10, compiled10, cs10)
    if again != proof10:
        raise AssertionError("the same inputs gave two different proofs")
    # a proof with another s, its ATen operators counted (the launches
    # beside the hand-written kernels: one proof's worth)
    with_s = {}
    aten = count_aten_ops(lambda: with_s.update(other=prove(
        params10, compiled10, cs10, s=S_BLIND + 1)))
    other, _, other_dev = with_s["other"]
    if other == proof10 or other["a"] != proof10["a"]:
        raise AssertionError("a proof with another s must differ in B and C "
                             "and keep A")
    print("rung " + json.dumps(big), flush=True)
    # setup's GT element against the python-int oracle e(alpha*G1, beta*G2)
    want_gt = host_alpha_beta(TOXIC["alpha"], TOXIC["beta"])
    if fp.fp_to_ints(fq, params10.vk.alpha_g1_beta_g2) != want_gt:
        raise AssertionError("vk.alpha_g1_beta_g2 differs from the "
                             "python-int oracle")
    verify_line["checks"]["alpha_g1_beta_g2 equals the oracle"] = True
    no_launch = {"expand", "view", "_unsafe_view", "slice", "select",
                 "unbind", "unsqueeze", "split", "split_with_sizes", "alias",
                 "detach", "t", "transpose", "permute", "as_strided",
                 "reshape", "empty", "empty_like", "empty_strided"}
    device_ops = {k: v for k, v in aten.items() if k not in no_launch}
    print("aten_ops_per_proof " + json.dumps(
        dict(sorted(device_ops.items(), key=lambda kv: -kv[1]))), flush=True)
    verify_rung(10, cs10, params10, dev10)
    verify_line["path_launches"] = verify_line["rungs"]["2^10"]["launches"]
    serialization(10, cs10, params10, proof10, dev10)
    # the parameters through bytes and back prove the same proof
    t = time.perf_counter()
    raw = serialize.params_to_bytes(eng, params10)
    t1 = time.perf_counter()
    decoded, used = serialize.params_from_bytes(eng, raw)
    to_s, from_s = t1 - t, time.perf_counter() - t1
    if used != len(raw) or serialize.params_to_bytes(eng, decoded) != raw:
        raise AssertionError("2^10: the parameters do not round-trip")
    if prove(decoded, compiled10, cs10)[0] != proof10:
        raise AssertionError("2^10: the decoded parameters prove another "
                             "proof")
    serial_line["params_2p10"] = {
        "bytes": len(raw), "to_bytes_s": to_s, "from_bytes_s": from_s,
        "proves_the_same_proof": True}
    del raw, decoded
    serial_line["queries_against_loop_2p10"] = queries_against_loop(
        cs10, params10, qap10)
    inputs10 = cs10.input_values[1:]
    # the proof with another s is a proof too; a wrong input and a C moved
    # by G1's generator (still a curve point) are refused
    altered = groth16.Proof(a=dev10.a, b=dev10.b, c=g1.to_affine(
        g1.add_mixed(g1.from_affine(*dev10.c), g1.generator_affine)))
    for label, proof_inputs, want in (
            ("2^10 other s", (other_dev, inputs10), True),
            ("2^10 wrong input", (dev10, [inputs10[0] + 1] + inputs10[1:]),
             False),
            ("2^10 altered C", (altered, inputs10), False)):
        if verify(params10, *proof_inputs, label)[0] is not want:
            raise AssertionError(f"verify_proof: {label} must give {want}")
    # one verify by phase: the input accumulation, the host ladders, the
    # prepared Miller loop over the three pairs, the final exponentiation
    with phase_clock(((msm_mod, "msm_naive"), (eng, "prepare_g2"),
                      (eng, "miller_loop_prepared"),
                      (eng, "final_exponentiation"))) as clock:
        ok, total = verify(params10, dev10, inputs10, "2^10 by phase")
    phases = {k: sum(v) for k, v in clock.take().items()}
    phases["other"] = total - sum(phases.values())
    verify_line["phases_2p10_s"] = dict(phases, total=total)
    verify_line["phases_2p10_launches"] = clock.launches
    if not ok:
        raise AssertionError("verify_proof refused the 2^10 proof")
    # GT against the reference: one pairing of its anchor points
    pa, qb, anchor_gt = mnt4753_anchor()
    pa, qb = g1.affine_from_ints(*pa), g2.affine_from_ints(*qb)
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = fp.fp_to_ints(fq, eng.pairing_prepared(pa, eng.prepare_g2(qb)))
    prepared_s = time.perf_counter() - t            # to_ints: the barrier
    if got != anchor_gt:
        raise AssertionError("the anchor pairing differs from the "
                             "reference's GT")
    verify_line["anchor"] = {"equals_reference_gt": True,
                             "prepared_s": prepared_s}

    # 2^16 constraints: every MSM of the prover is above the 2^12-point
    # threshold, so G1 goes through msm_hybrid and the curve kernels and G2
    # through msm_affine
    full, (cs16, compiled16, params16, proof16, dev16, _) = rung(
        16, phases=True)
    # a repeat gives the same proof on this path too (msm_hybrid and the
    # curve kernels; at 2^10 the MSMs run as loops)
    again, full["prove_steady_s"], _ = prove(params16, compiled16, cs16)
    if again != proof16:
        raise AssertionError("2^16: the same inputs gave two different "
                             "proofs")
    print("rung " + json.dumps(full), flush=True)
    if params10.vk.alpha_g1_beta_g2.tolist() != \
            params16.vk.alpha_g1_beta_g2.tolist():
        raise AssertionError("two setups with the same alpha and beta gave "
                             "two GT elements")
    verify_rung(16, cs16, params16, dev16)
    serialization(16, cs16, params16, proof16, dev16)
    nv16, m16 = cs16.num_variables, params16.domain_size
    del params16, dev16, compiled16
    print("verify " + json.dumps(verify_line), flush=True)
    print("serialization " + json.dumps(serial_line), flush=True)
    # every query scalar and single element went through the windowed
    # tables once: G1 a and b_g1 (nv each), l and gamma_abc (nv together),
    # h (m - 1), alpha, beta, delta; G2 b_g2 (nv), beta, gamma, delta
    if full["setup_query_scalars"] != {
            "fixed_base_windowed.g1": 3 * nv16 + m16 - 1 + 3,
            "fixed_base_windowed.g2": nv16 + 3}:
        raise AssertionError("the 2^16 setup's windowed queries took other "
                             "scalar counts than its queries hold")
    errs_setup, rows_setup, timed_setup = field_kernels_at_setup(
        setup_layouts["mnt4753", 16])
    print("field_kernels_at_setup " + json.dumps(rows_setup), flush=True)
    for k in kernels:
        if k["name"] in timed_setup:
            row = timed_setup[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], errs_setup[k["name"]])
            k["at_2p16_shape"] = {key: row[key] for key in (
                "case", "rows", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by")}

    widths16 = full["curve_launches_by_width"]
    print("ec_affine_at_widest " + json.dumps(k5k6_at_widest(widths16)),
          flush=True)
    k6_by_width = inv_tree_by_width(widths16)
    print("inv_tree_by_width " + json.dumps(loss_line(k6_by_width)),
          flush=True)
    k5_by_width = ec_affine_by_width(widths16)
    print("ec_affine_by_width " + json.dumps(loss_line(k5_by_width)),
          flush=True)

    # ------------------------------------------------------------------
    # 4d. MNT6-753: its pairing, Groth16 over it, GM17 over both curves,
    #     and K4-K6 at MNT6-753 G1's curve constant (a = 11)
    # ------------------------------------------------------------------
    eng6 = engines["mnt6753"]
    g1_6, g2_6 = eng6.g1, eng6.g2
    fq_6 = g1_6.fp

    def counted(fn):
        """(fn(), host-clock seconds, launches by kind), counts from 0."""
        fp.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, {
            k: v for k, v in fp.launch_counts.items() if v}

    def pairing_mnt6():
        """The reference anchor's pairing on the card, digit for digit
        against its GT; the seconds and launches of the host ladder, one
        prepared Miller loop and one final exponentiation; the launches
        of one multiply in each tower (Fq2, Fq4, Fq3, Fq6), its product
        against python ints."""
        pa, qb, gt = mnt6753_anchor()
        P, Q = g1_6.affine_from_ints(*pa), g2_6.affine_from_ints(*qb)
        out = {}
        prep, out["prepare_g2_s"], _ = counted(lambda: eng6.prepare_g2(Q))
        f, out["miller_loop_s"], out["miller_loop_launches"] = counted(
            lambda: eng6.miller_loop_prepared(P, prep))
        got, out["final_exponentiation_s"], \
            out["final_exponentiation_launches"] = counted(
                lambda: eng6.final_exponentiation(f))
        if fp.fp_to_ints(fq_6, got) != gt:
            raise AssertionError("the MNT6-753 anchor pairing differs from "
                                 "the reference's GT")
        out["equals_reference_gt"] = True
        rng = random.Random(63)
        out["launches_per_multiply"] = {}
        for engine in (eng, eng6):
            for F in (engine.sub, engine.fqk):
                vals = [[rng.randrange(F.fp.modulus) for _ in range(F.K)]
                        for _ in range(2)]
                x, y = (torch.from_numpy(F.const(v)).to(dev) for v in vals)
                prod, _, launches = counted(lambda: F.mul(x, y))
                H = HE.build_mnt6_host_towers(
                    F.fp.modulus, TG.MNT6753_FQ3["nonresidue"]) \
                    if engine is eng6 else HE.build_mnt4_host_towers(
                        F.fp.modulus, TG.MNT4753_FQ2["nonresidue"])
                if fp.fp_to_ints(F.fp, prod) != HE.host_ext_mul(
                        H[1 if F is engine.sub else 2], *vals):
                    raise AssertionError(f"{F.name}: product differs from "
                                         f"python ints")
                out["launches_per_multiply"][F.name] = launches
        return out

    t_mnt6 = time.perf_counter()
    mnt6_pairing = pairing_mnt6()
    print("pairing_mnt6 " + json.dumps(mnt6_pairing), flush=True)

    # Groth16 over MNT6-753: the largest radix-2 rung, 32,763
    # constraints + 5 inputs = a 2^15 domain (two-adicity 15)
    verify6_line = {"family": "mnt6753", "rungs": {}, "checks": {}}
    serial6_line = {"family": "mnt6753", "rungs": {}}
    mnt6_widths = {}
    mnt6_paths = {}       # the new paths whose launches are checked

    def add_widths(widths):
        for k, by_w in widths.items():
            for w, n in by_w.items():
                mnt6_widths.setdefault(k, {})
                mnt6_widths[k][w] = mnt6_widths[k].get(w, 0) + n

    # (the 2^6 rung, which ran the same code at a smaller depth, and the
    # 2^15 rung's repeat proof are left out to make room for section 4g;
    # the MNT4-753 2^16 rung checks that a repeat gives the same proof on
    # the msm_hybrid path)
    for log2, n_c in ((15, (1 << 15) - NUM_INPUTS - 1),):
        line, (cs_, compiled_, params_, proof_, dev_, _) = rung(
            log2, phases=True, family="mnt6753", constraints=n_c)
        if params_.domain_size != 1 << (n_c + NUM_INPUTS).bit_length():
            raise AssertionError(f"mnt6753 {n_c}: domain "
                                 f"{params_.domain_size}")
        add_widths(line["curve_launches_by_width"])
        print("rung " + json.dumps(line), flush=True)
        verify_rung(log2, cs_, params_, dev_, eng6, verify6_line)
        serialization(log2, cs_, params_, proof_, dev_, eng6, serial6_line)
    mnt6_paths["groth16_mnt6_2p15"] = line
    want_gt = host_alpha_beta(TOXIC["alpha"], TOXIC["beta"], "mnt6753")
    if fp.fp_to_ints(fq_6, params_.vk.alpha_g1_beta_g2) != want_gt:
        raise AssertionError("mnt6753: vk.alpha_g1_beta_g2 differs from the "
                             "python-int oracle")
    verify6_line["checks"]["alpha_g1_beta_g2 equals the oracle"] = True
    inputs_ = cs_.input_values[1:]
    altered = groth16.Proof(a=dev_.a, b=dev_.b, c=g1_6.to_affine(
        g1_6.add_mixed(g1_6.from_affine(*dev_.c), g1_6.generator_affine)))
    for label, proof_inputs in (
            ("2^15 wrong input", (dev_, [inputs_[0] + 1] + inputs_[1:])),
            ("2^15 altered C", (altered, inputs_))):
        if verify(params_, *proof_inputs, label, eng6)[0] is not False:
            raise AssertionError(f"mnt6753 verify_proof: {label} accepted")
        verify6_line["checks"][label] = False
    # one constraint more and the radix-2 domain would pass the
    # two-adicity: refused where the JAX package's Domain refuses it
    too_big, _ = benchmark_circuit(g1_6.scalar_field, NUM_INPUTS, n_c + 1)
    try:
        compile_r1cs(too_big)
    except ValueError:
        verify6_line["checks"]["2^15 + 1 rows refused"] = True
    else:
        raise AssertionError("mnt6753: a 2^16 radix-2 domain was accepted")
    del too_big, params_, dev_, altered
    print("verify " + json.dumps(verify6_line), flush=True)
    print("serialization " + json.dumps(serial6_line), flush=True)
    errs6, rows6, _ = field_kernels_at_setup(setup_layouts["mnt6753", 15])
    print("field_kernels_at_setup_mnt6 " + json.dumps(rows6), flush=True)
    for k in kernels:
        if k["name"] in errs6:
            k["max_abs_err"] = max(k["max_abs_err"], errs6[k["name"]])

    # GM17 over MNT4-753 at 2^10 (SAP domain 4,096, radix 2) and MNT6-753
    # at 2^14 (SAP size 32,777 > 2^15: the mixed radix, 40,960)
    GM17_TOXIC = dict(alpha=123, beta=456, t=314159)
    GM17_RAND = dict(d1=11, d2=22, r=R_BLIND)

    def gm17_rung(family, log2, domain_kind, domain_size):
        engine = engines[family]
        cs, _ = benchmark_circuit(engine.g1.scalar_field, NUM_INPUTS,
                                  1 << log2)
        out = {"family": family, "log2_constraints": log2}
        groth16.setup_table.cache_clear()
        with phase_clock(phase_clock.prover(engine, gm17)) as clock:
            fp.reset_launch_counts()
            ec_kernels.reset_launch_widths()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            compiled = gm17.compile_circuit(cs)
            params = gm17.generate_parameters(engine, cs, **GM17_TOXIC)
            torch.cuda.synchronize()
            out["setup_s"] = time.perf_counter() - t
            out["setup_launches"] = dict(fp.launch_counts)
            out["setup_phases_s"] = clock.take()
            out["setup_phase_launches"], clock.launches = clock.launches, {}
            t = time.perf_counter()
            proof_dev = gm17.create_proof(engine, params, compiled,
                                          cs.assignment(), **GM17_RAND)
            proof = groth16.proof_to_ints(engine, proof_dev)   # a barrier
            out["prove_s"] = time.perf_counter() - t
            out["prove_phases_s"] = clock.take()
            out["prove_phase_launches"] = clock.launches
        out["path_launches"] = dict(fp.launch_counts)
        out["prove_launches"] = {
            k: v - out["setup_launches"][k]
            for k, v in out["path_launches"].items()}
        out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["curve_launches_by_width"] = {
            k: dict(sorted(v.items()))
            for k, v in ec_kernels.launch_widths.items()
            if k not in ec_kernels.RNS_KERNELS}
        dom = gm17.sap_domain(compiled)
        out["domain"] = {"kind": type(dom).__name__, "size": dom.size,
                         "sap_rows": gm17.sap_size(cs.num_constraints,
                                                   cs.num_inputs)}
        if (out["domain"]["kind"], dom.size, params.domain_size) != (
                domain_kind, domain_size, domain_size):
            raise AssertionError(f"gm17 {family}: domain {out['domain']}, "
                                 f"not {domain_kind} {domain_size}")
        t = time.perf_counter()
        want = gm17_host.expected_gm17_proof(family, cs, **GM17_TOXIC,
                                             **GM17_RAND)
        out["oracle_host_s"] = time.perf_counter() - t
        if proof != want:
            raise AssertionError(f"gm17 {family} 2^{log2}: device proof "
                                 f"differs from the closed-form oracle")
        out["equals_oracle"] = True
        inputs = cs.input_values[1:]
        ok, out["verify_s"], out["verify_launches"] = counted(
            lambda: gm17.verify_proof(engine, params.vk, proof_dev, inputs))
        wrong = gm17.verify_proof(engine, params.vk, proof_dev,
                                  [inputs[0] + 1] + inputs[1:])
        if not ok or wrong:
            raise AssertionError(f"gm17 {family}: verify gave {ok}, and "
                                 f"{wrong} on a wrong input")
        out["verify_checks"] = {"accepts": True, "wrong input": False}
        return out

    gm17_lines = {}
    for family, log2, kind, size in (("mnt4753", 10, "Domain", 4096),
                                     ("mnt6753", 14, "MixedRadixDomain",
                                      40960)):
        line = gm17_rung(family, log2, kind, size)
        gm17_lines[f"gm17_{family[:4]}_2p{log2}"] = line
        if family == "mnt6753":
            add_widths(line["curve_launches_by_width"])
        print("gm17 " + json.dumps(line), flush=True)

    def mnt6_curve_kernels(widths):
        """K4, K5 (pre, post) and K6 (up, tail, down) on MNT6-753 G1 (a =
        11) against their plain versions at the widest batch the MNT6
        paths launched each, the special lanes (a doubling, which reads a,
        among them) first, K4 also on one lane's doubling; then calls on
        MNT4-753 G1 (a = 2) and MNT6-753 G1 in turns, each against its
        plain version, so that a constant kept for the field alone, not
        for the curve, would show."""
        out = {"k5k6_at_widest": k5k6_at_widest(widths, g1_6)}
        n = max(widths["ec_proj_add"])
        proj, _, _ = multiples(g1_6, max(n, 16), seed=62)
        P, Q = proj_case(g1_6, proj, n)
        err = compare_all(f"mnt6753 ec_proj_add [{n}]",
                          ec_kernels.proj_add(g1_6, P, Q),
                          ec_kernels.proj_add_plain(g1_6, P, Q))
        one = tuple(c[8:9] for c in proj)
        err = max(err, compare_all(
            "mnt6753 ec_proj_add [1] P+P", ec_kernels.proj_add(
                g1_6, one, one), g1_6.double(one)))
        b_ms, b_by = bound(9 * n * elem_bytes,
                           (2 * 5 + 2 * 17 + (n - N_SPECIAL) * 14) * MUL_OPS)
        out["ec_proj_add"] = {
            "lanes": n, "max_abs_err": err,
            "ms": time_ms(lambda: ec_kernels.proj_add(g1_6, P, Q), 20),
            "device_ms": graph_ms(lambda: ec_kernels.proj_add(g1_6, P, Q),
                                  20),
            "plain_ms": time_ms(
                lambda: ec_kernels.proj_add_plain(g1_6, P, Q), 3),
            "bound_ms": b_ms, "bound_by": b_by}
        del P, Q, proj
        turns = []
        for curve in (g1, g1_6, g1, g1_6):
            proj, aff, _ = multiples(curve, 64, seed=64)
            P, Q = proj_case(curve, proj, 64)
            a_pt, b_pt = affine_case(curve, aff, 64)
            e1 = compare_all(f"{curve.name} ec_proj_add in turns",
                             ec_kernels.proj_add(curve, P, Q),
                             ec_kernels.proj_add_plain(curve, P, Q))
            got, want = (fn(curve, a_pt, b_pt) for fn in (
                ec_kernels.batch_affine_add,
                ec_kernels.batch_affine_add_plain))
            e2 = compare_all(f"{curve.name} batch_affine_add in turns",
                             (*got[0], got[1]), (*want[0], want[1]))
            turns.append({"curve": curve.name, "max_abs_err": max(e1, e2)})
        out["in_turns"] = turns
        return out

    # ------------------------------------------------------------------
    # 4e. one step of recursion (BASELINE config #5): an MNT4-753 Groth16
    #     proof of 7 * 11 = 77 made on the card, verified inside a circuit
    #     over MNT4-753 Fq built by the gadgets on the host, whose GM17
    #     proof over MNT6-753 is made on the card on the mixed domain
    # ------------------------------------------------------------------
    INNER_TOXIC = dict(alpha=1234, beta=5678, gamma=9101, delta=1121,
                       t=31415)
    INNER_BLIND = dict(r=171717, s=282828)
    OUTER_TOXIC = dict(alpha=135, beta=246, t=579111)
    OUTER_RAND = dict(d1=8642, d2=9753, r=2468)

    def since(before):
        """Launches by kind since the counts ``before``."""
        return {k: v - before.get(k, 0) for k, v in fp.launch_counts.items()
                if v > before.get(k, 0)}

    def phase(fn):
        """(fn(), host-clock seconds, launches by kind), counts kept."""
        before = dict(fp.launch_counts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, since(before)

    def recursion():
        """The inner proof on the card, held to ``HostGroth16``'s through
        the bridge to the gadgets' host dicts; the verifier circuit with
        the statement's 753 bits as public inputs, satisfied; the outer
        GM17 setup, prove and verify with phases, launches, curve widths
        and peak memory, the proof against ``expected_gm17_proof``, the
        SAP at t against ``sap_at``, and the refusals."""
        out = {"inner": {}, "circuit": {}, "outer": {}}
        inner, circ, outer = out["inner"], out["circuit"], out["outer"]
        groth16.setup_table.cache_clear()
        fp.reset_launch_counts()
        cs_in = mul_circuit(fr, 7, 11)
        params_in, inner["setup_s"], inner["setup_launches"] = phase(
            lambda: groth16.generate_parameters(eng, cs_in, **INNER_TOXIC))
        proof_in, inner["prove_s"], inner["prove_launches"] = phase(
            lambda: groth16.create_proof(eng, params_in,
                                         compile_r1cs(cs_in),
                                         cs_in.assignment(), **INNER_BLIND))
        ok, inner["verify_s"], inner["verify_launches"] = phase(
            lambda: groth16.verify_proof(eng, params_in.vk, proof_in, [77]))
        if not ok:
            raise AssertionError("recursion: the inner verify refused 77")
        vk_host = convert.groth16_vk_to_host(eng, params_in.vk)
        proof_host = convert.proof_to_host(eng, proof_in)
        t = time.perf_counter()
        H = groth16_host.host_groth16_mnt4753()
        host_params = H.setup(cs_in, **INNER_TOXIC)
        host_proof = H.prove(cs_in, host_params, **INNER_BLIND)
        inner["host_groth16_s"] = time.perf_counter() - t
        if vk_host != {k: host_params.vk[k] for k in vk_host} or \
                proof_host != host_proof:
            raise AssertionError("recursion: the inner vk or proof differs "
                                 "from HostGroth16's")
        inner["checks"] = {"vk and proof equal HostGroth16's": True,
                           "accepts 77": True}

        t = time.perf_counter()
        cs = groth16_verifier_circuit(vk_host, proof_host, [77])
        circ["build_s"] = time.perf_counter() - t
        circ.update(num_constraints=cs.num_constraints,
                    num_variables=cs.num_variables,
                    num_inputs=cs.num_inputs)
        if (cs.num_constraints, cs.num_inputs) != (61407, 754):
            raise AssertionError(f"recursion: the circuit has "
                                 f"{cs.num_constraints} constraints and "
                                 f"{cs.num_inputs} inputs")

        def oracles():
            t0 = time.perf_counter()
            bad = cs.which_is_unsatisfied()
            t1 = time.perf_counter()
            sap = gm17_host.sap_at(cs, OUTER_TOXIC["t"])
            t2 = time.perf_counter()
            want = gm17_host.expected_gm17_proof(
                "mnt6753", cs, **OUTER_TOXIC, **OUTER_RAND, sap=sap)
            return bad, sap, want, (t1 - t0, t2 - t1,
                                    time.perf_counter() - t2)

        # the circuit's check and the outer proof's oracles in python ints,
        # in a forked process while the card sets up and proves
        oracle = HostOracle(oracles)
        groth16.setup_table.cache_clear()
        ec_kernels.reset_launch_widths()
        with phase_clock(phase_clock.prover(eng6, gm17)) as clock:
            torch.cuda.reset_peak_memory_stats()
            with layout_log() as layouts:
                compiled, outer["compile_s"], _ = phase(
                    lambda: gm17.compile_circuit(cs))
                params, outer["setup_s"], outer["setup_launches"] = phase(
                    lambda: gm17.generate_parameters(eng6, cs,
                                                     **OUTER_TOXIC))
            outer["setup_phases_s"] = clock.take()
            outer["setup_phase_launches"], clock.launches = \
                clock.launches, {}
            outer["setup_query_scalars"] = clock.query_scalars
            outer["setup_peak_device_gib"] = \
                torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            before = dict(fp.launch_counts)
            torch.cuda.synchronize()
            t = time.perf_counter()
            proof_dev = gm17.create_proof(eng6, params, compiled,
                                          cs.assignment(), **OUTER_RAND)
            proof = groth16.proof_to_ints(eng6, proof_dev)   # a barrier
            outer["prove_s"] = time.perf_counter() - t
            outer["prove_launches"] = since(before)
            outer["prove_phases_s"] = clock.take()
            outer["prove_phase_launches"] = clock.launches
            outer["prove_peak_device_gib"] = \
                torch.cuda.max_memory_allocated() / 2**30
        outer["curve_launches_by_width"] = {
            k: dict(sorted(v.items()))
            for k, v in ec_kernels.launch_widths.items()
            if k not in ec_kernels.RNS_KERNELS}
        dom = gm17.sap_domain(compiled)
        outer["domain"] = {"kind": type(dom).__name__, "size": dom.size,
                           "sap_rows": gm17.sap_size(cs.num_constraints,
                                                     cs.num_inputs)}
        if (outer["domain"]["kind"], dom.size, params.domain_size,
                outer["domain"]["sap_rows"]) != (
                    "MixedRadixDomain", 163840, 163840, 124321):
            raise AssertionError(f"recursion: domain {outer['domain']}")
        t = time.perf_counter()
        (bad, sap, want, (circ["check_s"], outer["sap_host_oracle_s"],
                          outer["oracle_host_s"])), _ = oracle.get()
        outer["oracle_wait_s"] = time.perf_counter() - t
        circ["which_is_unsatisfied"] = bad
        if bad is not None:
            raise AssertionError(f"recursion: the verifier circuit fails at "
                                 f"{bad}")
        if proof != want:
            raise AssertionError("recursion: the outer proof differs from "
                                 "expected_gm17_proof")
        inputs = cs.input_values[1:]
        ok, outer["verify_s"], outer["verify_launches"] = phase(
            lambda: gm17.verify_proof(eng6, params.vk, proof_dev, inputs))
        # the path ends here: the checks below launch kernels of their own
        out["path_launches"] = dict(fp.launch_counts)
        if groth16.verify_proof(eng, params_in.vk, proof_in, [78]):
            raise AssertionError("recursion: the inner verify accepted 78")
        inner["checks"]["refuses 78"] = True
        # the SAP at t on the device against python ints, every value
        got = gm17.sap_at_device(cs, OUTER_TOXIC["t"])
        if [fp.fp_to_ints(eng6.g1.scalar_field, v) for v in got[:2]] != \
                list(sap[:2]) or (got[2], got[3].size) != (sap[2], sap[4]):
            raise AssertionError("recursion: sap_at_device differs from "
                                 "sap_at")
        del got, sap
        bits78 = [(78 >> i) & 1 for i in range(len(inputs))]
        altered = gm17.GM17Proof(a=proof_dev.a, b=proof_dev.b,
                                 c=g1_6.to_affine(g1_6.add_mixed(
                                     g1_6.from_affine(*proof_dev.c),
                                     g1_6.generator_affine)))
        refusals = {
            "bits of 78": gm17.verify_proof(eng6, params.vk, proof_dev,
                                            bits78),
            "C + G1's generator": gm17.verify_proof(eng6, params.vk,
                                                    altered, inputs)}
        if not ok or any(refusals.values()):
            raise AssertionError(f"recursion: the outer verify gave {ok}, "
                                 f"and {refusals} on the refusals")
        outer["checks"] = {"equals expected_gm17_proof": True,
                           "sap_at_device equals sap_at": True,
                           "accepts the bits of 77": True,
                           **{f"refuses {k}": True for k in refusals}}
        out["setup_layouts"] = layouts.seen
        return out

    t_rec = time.perf_counter()
    recursion_line = recursion()
    rec_layouts = recursion_line.pop("setup_layouts")
    recursion_line["section_s"] = time.perf_counter() - t_rec
    add_widths(recursion_line["outer"]["curve_launches_by_width"])
    mnt6_paths["recursion"] = recursion_line
    print("recursion " + json.dumps(recursion_line), flush=True)
    errs_r, rows_r, _ = field_kernels_at_setup(rec_layouts)
    print("field_kernels_at_setup_recursion " + json.dumps(rows_r),
          flush=True)
    for k in kernels:
        if k["name"] in errs_r:
            k["max_abs_err"] = max(k["max_abs_err"], errs_r[k["name"]])
    del rec_layouts

    mnt6_kernels = mnt6_curve_kernels(mnt6_widths)
    print("mnt6_curve_kernels " + json.dumps(mnt6_kernels), flush=True)
    mnt6_paths.update(gm17_lines)
    # every new path launched K1, K2, add/sub and K4-K6
    for name, line in mnt6_paths.items():
        for k in ("mont_mul", "inv_bea", "fp_add", "fp_sub", "ec_proj_add",
                  "ec_affine_pre", "ec_affine_post", "inv_tree_up",
                  "inv_tree_tail", "inv_tree_down"):
            if line["path_launches"].get(k, 0) <= 0:
                raise AssertionError(f"{name} never launched {k}")
    print(f"mnt6_and_gm17_section_s {time.perf_counter() - t_mnt6:.1f}",
          flush=True)

    # ------------------------------------------------------------------
    # 4f. BLS12-377 and BLS12-381: the pairing on both curves, Groth16
    #     over BLS12-381 at 2^16 constraints, GM17 over both at 2^10, the
    #     BLS12-377 verifier circuit of a proof made on the card, and K1,
    #     K2, add/sub/neg and K4-K6 at 24 digits
    # ------------------------------------------------------------------
    t_bls = time.perf_counter()
    for family in ("bls12_377", "bls12_381"):
        engines[family] = getattr(CI, f"{family}_engine")()
    bls_paths = {}        # the BLS12 paths whose launches are checked
    bls_layouts = {}      # K1 and add/sub/neg layouts by path

    def tower_launches(E, family):
        """Launches of one multiply in Fq2, Fq6 and Fq12, of one Fq12
        cyclotomic square and one f * line, each product against python
        ints."""
        _, h2, h6, h12 = HE.build_bls12_host_towers(
            E.fp.modulus, *(getattr(TG, f"{family.upper()}_FQ{k}")[
                "nonresidue"] for k in (2, 6)))
        rng = random.Random(15)
        out = {}
        for F, H in ((E.sub, h2), (E.fq6, h6), (E.fqk, h12)):
            vals = [[rng.randrange(F.fp.modulus) for _ in range(F.K)]
                    for _ in range(2)]
            x, y = (torch.from_numpy(F.const(v)).to(dev) for v in vals)
            prod, _, out[F.name] = counted(lambda: F.mul(x, y))
            if fp.fp_to_ints(F.fp, prod) != HE.host_ext_mul(H, *vals):
                raise AssertionError(f"{F.name}: product differs from "
                                     f"python ints")
        F, f12 = E.fqk, x                         # the last: Fq12's
        unit = E.final_exponentiation(f12)        # in the cyclotomic group
        sq, _, out["cyclotomic_square"] = counted(
            lambda: F.cyclotomic_square(unit))
        if not torch.equal(sq, F.sqr(unit)):
            raise AssertionError(f"{family}: the cyclotomic square differs")
        c = [y[2 * k:2 * k + 2] for k in range(3)]
        shape = "mul_by_014" if E.twist_type == "M" else "mul_by_034"
        pos = (0, 1, 4) if E.twist_type == "M" else (0, 3, 4)
        dense = torch.zeros_like(f12).unflatten(-2, (6, 2))
        for k, ck in zip(pos, c):
            dense[k] = ck
        got, _, out[shape] = counted(lambda: getattr(F, shape)(f12, *c))
        if not torch.equal(got, F.mul(f12, dense.flatten(-3, -2))):
            raise AssertionError(f"{family}: {shape} differs from the "
                                 f"dense product")
        return out

    def pairing_bls12(family):
        """GT of (G1, G2) and of (2P, 3Q) against ``HostBls12Pairing``;
        e(3P, 5Q) = e(P, Q)^15 and GT^r = 1 on the card; seconds and
        launches of the line coefficients, the Miller loop (its lines
        included) and the final exponentiation; the towers' launches."""
        E = engines[family]
        H = getattr(pairing_host, f"host_{family}_pairing")()
        hg1, hg2, fr_ = groth16_host.host_curves(family)
        P, Q = E.g1.generator_affine, E.g2.generator_affine
        out = {"family": family, "twist": E.twist_type,
               "x_is_negative": E.x_is_neg}
        with layout_log() as layouts:
            _, out["line_coefficients_s"], \
                out["line_coefficients_launches"] = counted(
                    lambda: E._prepare_g2(Q))
            f, out["miller_loop_s"], out["miller_loop_launches"] = counted(
                lambda: E.miller_loop(P, Q))
            gt, out["final_exponentiation_s"], \
                out["final_exponentiation_launches"] = counted(
                    lambda: E.final_exponentiation(f))
        bls_layouts[family, "pairing"] = layouts.seen
        if fp.fp_to_ints(E.fp, gt) != H.pairing(hg1.gen, hg2.gen):
            raise AssertionError(f"{family}: e(G1, G2) differs from "
                                 f"HostBls12Pairing's")

        def on_card(k1, k2):
            p1, q2 = hg1.mul(hg1.gen, k1), hg2.mul(hg2.gen, k2)
            return p1, q2, E.pairing(E.g1.affine_from_ints(*p1),
                                     E.g2.affine_from_ints(*q2))

        p2, q3, gt23 = on_card(2, 3)
        if fp.fp_to_ints(E.fp, gt23) != H.pairing(p2, q3):
            raise AssertionError(f"{family}: e(2P, 3Q) differs from "
                                 f"HostBls12Pairing's")
        F = E.fqk
        _, _, gt35 = on_card(3, 5)
        if not torch.equal(gt35, T.ext_pow_const(
                F, gt, limbs.bits_msb_first(15, 4))):
            raise AssertionError(f"{family}: e(3P, 5Q) != e(P, Q)^15")
        r = fr_.modulus
        if not torch.equal(T.ext_pow_const(
                F, gt, limbs.bits_msb_first(r, r.bit_length())),
                F.tensor("one", dev)) or torch.equal(
                    gt, F.tensor("one", dev)):
            raise AssertionError(f"{family}: GT^r != 1 or GT = 1")
        out["checks"] = {"e(G1, G2) equals HostBls12Pairing's": True,
                         "e(2P, 3Q) equals HostBls12Pairing's": True,
                         "e(3P, 5Q) = e(P, Q)^15": True,
                         "GT^r = 1 and GT != 1": True}
        out["launches_per_operation"] = tower_launches(E, family)
        return out

    for family in ("bls12_377", "bls12_381"):
        line = pairing_bls12(family)
        # the pairing's path: its Miller loop (the lines included) and its
        # final exponentiation
        bls_paths[f"pairing_{family}"] = {"path_launches": {
            k: line["miller_loop_launches"].get(k, 0) +
            line["final_exponentiation_launches"].get(k, 0)
            for k in fp.launch_counts}}
        print("pairing_bls12 " + json.dumps(line), flush=True)

    # Groth16 over BLS12-381 at 2^16 constraints (domain 2^17): the MNT4-753
    # 2^16 rung's circuit and toxic waste
    eng381 = engines["bls12_381"]
    g1_381 = eng381.g1
    line, (cs_, compiled_, params_, proof_, dev_, _) = rung(
        16, phases=True, family="bls12_381")
    bls_paths["groth16_bls12_381_2p16"] = bls381_rung = line
    print("rung " + json.dumps(line), flush=True)
    verify_bls = {"family": "bls12_381", "rungs": {}, "checks": {}}
    verify_rung(16, cs_, params_, dev_, eng381, verify_bls)
    want_gt = host_alpha_beta(TOXIC["alpha"], TOXIC["beta"], "bls12_381")
    if fp.fp_to_ints(g1_381.fp, params_.vk.alpha_g1_beta_g2) != want_gt:
        raise AssertionError("bls12_381: vk.alpha_g1_beta_g2 differs from "
                             "the python-int oracle")
    verify_bls["checks"]["alpha_g1_beta_g2 equals the oracle"] = True
    inputs_ = cs_.input_values[1:]
    altered = groth16.Proof(a=dev_.a, b=dev_.b, c=g1_381.to_affine(
        g1_381.add_mixed(g1_381.from_affine(*dev_.c),
                         g1_381.generator_affine)))
    for label, proof_inputs in (
            ("2^16 wrong input", (dev_, [inputs_[0] + 1] + inputs_[1:])),
            ("2^16 altered C", (altered, inputs_))):
        if verify(params_, *proof_inputs, label, eng381)[0] is not False:
            raise AssertionError(f"bls12_381 verify_proof: {label} "
                                 f"accepted")
        verify_bls["checks"][label] = False
    del params_, dev_, altered, compiled_
    print("verify " + json.dumps(verify_bls), flush=True)

    # GM17 over BLS12-377 and BLS12-381 at 2^10 (SAP domain 4,096)
    for family in ("bls12_377", "bls12_381"):
        line = gm17_rung(family, 10, "Domain", 4096)
        bls_paths[f"gm17_{family}_2p10"] = line
        print("gm17 " + json.dumps(line), flush=True)

    def recursion_bls12():
        """The inner BLS12-377 Groth16 proof of 7 * 11 = 77 made on the
        card, its vk and proof equal to ``HostGroth16``'s through the
        bridge; verify accepts 77 and refuses 78 and an altered C; the
        verifier circuit over BLS12-377 Fq (the statement's 253 bits as
        public inputs) built and checked on the host, satisfied, and
        unsatisfied for 78.  Returns the line and the circuits for 77 and
        78, whose outer proof over SW6 section 4g makes."""
        eng377 = engines["bls12_377"]
        g1_377 = eng377.g1
        out = {"inner": {}, "circuit": {}}
        circuits = {}
        inner, circ = out["inner"], out["circuit"]
        groth16.setup_table.cache_clear()
        fp.reset_launch_counts()
        cs_in = mul_circuit(g1_377.scalar_field, 7, 11)
        params_in, inner["setup_s"], inner["setup_launches"] = phase(
            lambda: groth16.generate_parameters(eng377, cs_in,
                                                **INNER_TOXIC))
        proof_in, inner["prove_s"], inner["prove_launches"] = phase(
            lambda: groth16.create_proof(eng377, params_in,
                                         compile_r1cs(cs_in),
                                         cs_in.assignment(), **INNER_BLIND))
        ok, inner["verify_s"], inner["verify_launches"] = phase(
            lambda: groth16.verify_proof(eng377, params_in.vk, proof_in,
                                         [77]))
        out["path_launches"] = dict(fp.launch_counts)
        altered = groth16.Proof(a=proof_in.a, b=proof_in.b,
                                c=g1_377.to_affine(g1_377.add_mixed(
                                    g1_377.from_affine(*proof_in.c),
                                    g1_377.generator_affine)))
        refusals = {
            "78": groth16.verify_proof(eng377, params_in.vk, proof_in, [78]),
            "altered C": groth16.verify_proof(eng377, params_in.vk, altered,
                                              [77])}
        if not ok or any(refusals.values()):
            raise AssertionError(f"recursion_bls12: verify gave {ok}, and "
                                 f"{refusals} on the refusals")
        vk_host = convert.groth16_vk_to_host(eng377, params_in.vk)
        proof_host = convert.proof_to_host(eng377, proof_in)
        t = time.perf_counter()
        H = groth16_host.host_groth16_bls12_377()
        host_params = H.setup(cs_in, **INNER_TOXIC)
        host_proof = H.prove(cs_in, host_params, **INNER_BLIND)
        inner["host_groth16_s"] = time.perf_counter() - t
        if vk_host != {k: host_params.vk[k] for k in vk_host} or \
                proof_host != host_proof:
            raise AssertionError("recursion_bls12: the inner vk or proof "
                                 "differs from HostGroth16's")
        inner["checks"] = {"vk and proof equal HostGroth16's": True,
                           "accepts 77": True,
                           **{f"refuses {k}": True for k in refusals}}
        for value, want in ((77, None), (78, "unsatisfied")):
            t = time.perf_counter()
            cs = circuits[value] = groth16_verifier_circuit(
                vk_host, proof_host, [value], "bls12_377")
            build_s = time.perf_counter() - t
            t = time.perf_counter()
            bad = cs.which_is_unsatisfied()
            check_s = time.perf_counter() - t
            if (bad is None) != (want is None):
                raise AssertionError(f"recursion_bls12: the circuit for "
                                     f"{value} gave {bad}")
            if value == 77:
                circ.update(build_s=build_s, check_s=check_s,
                            num_constraints=cs.num_constraints,
                            num_variables=cs.num_variables,
                            num_inputs=cs.num_inputs)
            else:
                circ["refuses_78_at"] = bad
        if (circ["num_constraints"], circ["num_inputs"]) != (42006, 254):
            raise AssertionError(f"recursion_bls12: the circuit has "
                                 f"{circ['num_constraints']} constraints "
                                 f"and {circ['num_inputs']} inputs")
        circ["checks"] = {"satisfied for 77": True,
                          "unsatisfied for 78": True}
        return out, circuits

    t = time.perf_counter()
    rec_bls, bls_circuits = recursion_bls12()
    rec_bls["section_s"] = time.perf_counter() - t
    bls_paths["recursion_bls12"] = rec_bls
    # printed in section 4g, with its outer proof over SW6

    def curve_kernel_rows(widths, curve, launches, seen, path, suffix):
        """K1, K2, add/sub/neg, K4, K5 and K6 at the width of ``curve``'s
        field against their plain versions, tolerance 0: K1 and
        add/sub/neg at the widest layout of each class in ``seen`` (as
        ``layout_log`` records them: the path's setup and pairings;
        ``field_kernels_at_setup``), K2 on one element (as the path inverts
        one), K4 at the path's widest batch (the special lanes first, a
        doubling among them), K5 and K6 at their widest batch (the
        windowed query's first level) and the tail at its widest; each
        timed beside its plain version and its bound.  Returns the rows of
        the kernels line, named ``<kernel>_<suffix>`` (``launches``: the
        path's counts at this width), and the field kernels' rows by
        layout."""
        F = curve.fp
        w = F.n_digits
        lw = (w + 1) // 2                      # 32-bit limbs
        eb, mulw = 2 * w, (2 * lw * lw + lw) * 2
        errs, field_rows, timed = field_kernels_at_setup(seen, F.name)
        rows = {}
        for name, row in timed.items():
            rows[name] = dict(max_abs_err=errs[name], case=row["case"],
                              **{k: row[k] for k in (
                                  "ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by")})

        def timed_case(name, fn, plain, err, nbytes, nops, **extra):
            b_ms, b_by = bound(nbytes, nops)
            rows[name] = dict(
                max_abs_err=err, ms=time_ms(fn, 20),
                device_ms=graph_ms(fn, 20), plain_ms=time_ms(plain, 2),
                bound_ms=b_ms, bound_by=b_by, **extra)

        def invw(v):
            return divsteps_model.inverse(v, F.modulus).passes * (
                31 * 12 + 24 * lw)

        # K2 on one element, as the path calls it
        x1 = torch.from_numpy(limbs.to_digits_batch(
            [random.Random(w).randrange(1, F.modulus)], w)).to(dev)
        timed_case("inv_bea", lambda: fp.inv_bea(F, x1),
                   lambda: fp.inv_bea_plain(F, x1),
                   compare(f"inv_bea [1,{w}]", fp.inv_bea(F, x1),
                           fp.inv_bea_plain(F, x1)),
                   2 * eb, invw(limbs.from_digits_batch(x1.cpu())[0]),
                   case=f"[1, {w}]")
        # K4 at the widest batch
        n = max(widths["ec_proj_add"])
        proj, _, _ = multiples(curve, max(n, 16), seed=65)
        P, Q = proj_case(curve, proj, n)
        err = max(compare_all(f"{curve.name} ec_proj_add [{n}]",
                              ec_kernels.proj_add(curve, P, Q),
                              ec_kernels.proj_add_plain(curve, P, Q)),
                  compare_all(f"{curve.name} ec_proj_add [1] P+P",
                              ec_kernels.proj_add(
                                  curve, *(tuple(c[8:9] for c in proj),) * 2),
                              curve.double(tuple(c[8:9] for c in proj))))
        timed_case("ec_proj_add", lambda: ec_kernels.proj_add(curve, P, Q),
                   lambda: ec_kernels.proj_add_plain(curve, P, Q), err,
                   9 * n * eb,
                   (2 * 5 + 2 * 17 + (n - N_SPECIAL) * 14) * mulw, lanes=n)
        del P, Q, proj
        # K5 and K6 at the widest batch
        n = max(widths["ec_affine_pre"])
        _, points, _ = multiples(curve, min(n, 1 << 18), seed=66)
        copies = -(-n // points[0].shape[0])
        a_pt, b_pt = affine_case(curve, tuple(
            torch.cat([c] * copies) for c in points), n)
        del points
        (x1_, y1_), inf1 = a_pt
        (x2_, y2_), inf2 = b_pt
        pre_args = (x1_, y1_, x2_, y2_, inf1, inf2)
        pre = ec_kernels.affine_pre(curve, *pre_args)
        timed_case("ec_affine_pre",
                   lambda: ec_kernels.affine_pre(curve, *pre_args),
                   lambda: ec_kernels.affine_pre_plain(curve, *pre_args),
                   compare_all(f"{curve.name} ec_affine_pre [{n}]", pre,
                               ec_kernels.affine_pre_plain(curve,
                                                           *pre_args)),
                   (6 * eb + 3) * n,
                   n * 2 * 2 * lw + 2 * (mulw + 4 * 2 * lw), lanes=n)
        num, den, inf3 = pre
        den2 = den.reshape(n, w)
        tree, roots = ec_kernels.inv_up_cuda(F, den2)
        want_tree, want_roots = ec_kernels.inv_up_plain(F, den2)
        err = max(compare(f"{curve.name} inv_tree_up [{n}] trees",
                          ec_kernels.unpack_limbs(tree, w), want_tree),
                  compare(f"{curve.name} inv_tree_up [{n}] products", roots,
                          want_roots))
        tiles, muls = roots.shape[0], tile_muls(den2)
        timed_case("inv_tree_up", lambda: ec_kernels.inv_up_cuda(F, den2),
                   lambda: ec_kernels.inv_up_plain(F, den2), err,
                   (n + tiles * 2 * B) * eb, muls * mulw, lanes=n)
        rinv = ec_kernels.batch_inverse(F, roots)
        timed_case("inv_tree_down",
                   lambda: ec_kernels.inv_down_cuda(F, tree, rinv, n),
                   lambda: ec_kernels.inv_down_plain(F, want_tree, rinv, n),
                   compare(f"{curve.name} inv_tree_down [{n}]",
                           ec_kernels.inv_down_cuda(F, tree, rinv, n),
                           ec_kernels.inv_down_plain(F, want_tree, rinv, n)),
                   (tiles * (2 * B - 1) + n) * eb, 2 * muls * mulw, lanes=n)
        del tree, want_tree, want_roots, rinv
        dinv = ec_kernels.batch_inverse(F, den2).reshape(den.shape)
        post_args = (num, dinv, *pre_args, inf3)
        live = int((~(inf1 | inf2 | inf3)).sum())
        timed_case("ec_affine_post",
                   lambda: ec_kernels.affine_post(curve, *post_args),
                   lambda: ec_kernels.affine_post_plain(curve, *post_args),
                   compare_all(f"{curve.name} ec_affine_post [{n}]",
                               ec_kernels.affine_post(curve, *post_args),
                               ec_kernels.affine_post_plain(curve,
                                                            *post_args)),
                   (8 * eb + 3) * n, live * (3 * mulw + 4 * 2 * lw),
                   lanes=n)
        del a_pt, b_pt, pre, num, den, den2, dinv, post_args, pre_args
        # the tail at its widest (the products of up to 512 tiles)
        m = max(widths["inv_tree_tail"])
        rng = random.Random(67)
        xt = torch.from_numpy(limbs.to_digits_batch(
            [rng.randrange(1, F.modulus) for _ in range(m)], w)).to(dev)
        root = limbs.from_digits_batch(
            ec_kernels.inv_up_plain(F, xt)[1].cpu())[0]
        timed_case("inv_tree_tail", lambda: ec_kernels.inv_tail_cuda(F, xt),
                   lambda: ec_kernels.inv_tail_plain(F, xt),
                   compare(f"{curve.name} inv_tree_tail [{m}]",
                           ec_kernels.inv_tail_cuda(F, xt),
                           ec_kernels.inv_tail_plain(F, xt)),
                   2 * m * eb, 3 * tile_muls(xt) * mulw + invw(root),
                   lanes=m)
        meta = {k["name"]: k for k in kernels}
        out = []
        for name, row in rows.items():
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{path} never launched {name} at "
                                     f"{w} digits")
            out.append({
                "name": f"{name}_{suffix}", "route": "cuda",
                "source": meta[name]["source"],
                "replaces": meta[name]["replaces"],
                "launches": launches.get(name, 0), **row,
                # no PyTorch call computes a modular product, a curve
                # addition or an inverse
                "library_ms": None,
                "path": path, "kernel": name, "field": F.name})
        return out, field_rows

    seen381 = dict(setup_layouts["bls12_381", 16])
    for lay in bls_layouts.values():
        for key, n in lay.items():
            seen381[key] = seen381.get(key, 0) + n
    bls_rows, bls_field_rows = curve_kernel_rows(
        bls381_rung["curve_launches_by_width"], g1_381,
        bls381_rung["path_launches"], seen381, "groth16_bls12_381_2p16",
        "d24")
    print("field_kernels_at_bls12 " + json.dumps(bls_field_rows), flush=True)
    print("bls12_curve_kernels " + json.dumps(bls_rows), flush=True)
    # every BLS12 path launched K1, K2 and add/sub; the rung K4-K6 as well
    for name, line in bls_paths.items():
        need = ["mont_mul", "inv_bea", "fp_add", "fp_sub"]
        if name == "groth16_bls12_381_2p16":
            need += ["ec_proj_add", "ec_affine_pre", "ec_affine_post",
                     "inv_tree_up", "inv_tree_tail", "inv_tree_down"]
        for k in need:
            if line["path_launches"].get(k, 0) <= 0:
                raise AssertionError(f"{name} never launched {k}")
    print(f"bls12_section_s {time.perf_counter() - t_bls:.1f}", flush=True)

    # ------------------------------------------------------------------
    # 4g. SW6 and MNT6-298, the fields of an odd digit count (49 and 19
    #     digits): the field kernels and K6 there on their edge values,
    #     both pairings, Groth16 and GM17 over MNT6-298 at 2^10 with its
    #     golden proof bytes, the BLS12-377 recursion's outer Groth16
    #     proof over SW6, and the rows *_d19 and *_d49 of the kernels line
    # ------------------------------------------------------------------
    t_odd = time.perf_counter()
    for family in ("mnt6298", "sw6"):
        engines[family] = getattr(CI, f"{family}_engine")()
    eng298, eng_sw6 = engines["mnt6298"], engines["sw6"]
    odd_paths = {}        # the paths whose launches are checked
    odd_layouts = {}      # K1 and add/sub/neg layouts by path

    def odd_field_edges(F):
        """K1 and add/sub/neg at F's odd width on every pair of 0, 1, 2,
        p - 1, p - 2, (p - 1) / 2 and seeded values, K1 also with one
        operand R - 1 and p; even and odd halves (row stride 2 nd), a
        broadcast row and a constant row; K2 on its host test's inputs
        against python's pow (and on the seeded and edge ones against the
        plain version); K6 at the edges of its tiles (zeros at their ends,
        a whole tile of zeros), its launches checked."""
        p_, w = F.modulus, F.n_digits
        R_ = 1 << (16 * w)
        rng = random.Random(w)
        vals = [0, 1, 2, p_ - 1, p_ - 2, (p_ - 1) // 2] + [
            rng.randrange(p_) for _ in range(26)]

        def dig(vs):
            return torch.from_numpy(limbs.to_digits_batch(vs, w)).to(dev)

        a = dig([u for u in vals for _ in vals])
        b = dig([v for _ in vals for v in vals])
        err = {}
        for name, kern, plain in (
                ("mont_mul", fp.mont_mul, fp.mont_mul_plain),
                ("fp_add", fp.add_mod, fp.add_mod_plain),
                ("fp_sub", fp.sub_mod, fp.sub_mod_plain)):
            err[name] = max(
                compare(f"{name} {F.name} pairs", kern(F, a, b),
                        plain(F, a, b)),
                compare(f"{name} {F.name} halves", kern(F, a[0::2], b[1::2]),
                        plain(F, a[0::2], b[1::2])),
                compare(f"{name} {F.name} a row", kern(F, a, b[37]),
                        plain(F, a, b[37])))
        err["fp_neg"] = max(
            compare(f"fp_neg {F.name}", fp.neg_mod(F, a),
                    fp.neg_mod_plain(F, a)),
            compare(f"fp_neg {F.name} halves", fp.neg_mod(F, a[1::2]),
                    fp.neg_mod_plain(F, a[1::2])))
        wide = dig([R_ - 1, p_, R_ - 2] + [rng.randrange(p_, R_)
                                           for _ in range(29)])
        err["mont_mul"] = max(err["mont_mul"], compare(
            f"mont_mul {F.name} wide operand",
            fp.mont_mul(F, wide, b[:32]), fp.mont_mul_plain(F, wide, b[:32])),
            compare(f"mont_mul {F.name} to_mont", fp.to_mont(F, a),
                    fp.mont_mul_plain(F, a, F.tensor("r2_digits", dev))))
        cases = inv_inputs(p_, F.name)
        xs = dig([v for kind in cases.values() for v in kind])
        got = fp.inv_bea(F, xs)
        if limbs.from_digits_batch(got.cpu()) != [
                pow(v, -1, p_) if v else 0
                for kind in cases.values() for v in kind]:
            raise AssertionError(f"inv_bea {F.name} disagrees with pow")
        few = xs[:len(cases["random"]) + len(cases["edges"])]
        err["inv_bea"] = compare(f"inv_bea {F.name}", fp.inv_bea(F, few),
                                 fp.inv_bea_plain(F, few))
        for n in (1, 2, B - 1, B, B + 1, 2 * B + 3, 3 * B + 5):
            x = dig([rng.randrange(p_) for _ in range(n)])
            x[0] = x[n - 1] = 0
            for i in range(B - 1, n, B):
                x[i:i + 2] = 0
            if n >= 3 * B:
                x[B:2 * B] = 0
            before = dict(fp.launch_counts)
            inv = ec_kernels.batch_inverse(F, x)
            launched = {k: v - before[k] for k, v in fp.launch_counts.items()
                        if v != before[k]}
            want = {"inv_tree_tail": 1} if n <= B else {
                "inv_tree_up": 1, "inv_tree_tail": 1, "inv_tree_down": 1}
            if launched != want:
                raise AssertionError(f"batch_inverse {F.name} [{n}] "
                                     f"launched {launched}, not {want}")
            err["batch_inverse"] = max(err.get("batch_inverse", 0), compare(
                f"batch_inverse {F.name} [{n}]", inv,
                ec_kernels.batch_inverse_plain(F, x)))
            if n > B:
                tree, roots = ec_kernels.inv_up_cuda(F, x)
                want_tree, want_roots = ec_kernels.inv_up_plain(F, x)
                compare(f"inv_tree_up {F.name} [{n}]",
                        ec_kernels.unpack_limbs(tree, w), want_tree)
                compare(f"inv_tree_up {F.name} [{n}] products", roots,
                        want_roots)
            if fp.fp_to_ints(F, inv) != [pow(v, -1, p_) if v else 0
                                         for v in fp.fp_to_ints(F, x)]:
                raise AssertionError(f"batch_inverse {F.name} [{n}] "
                                     f"disagrees with pow")
        return err

    odd_edges = {F.name: odd_field_edges(F)
                 for F in (PP.MNT6298_FQ, PP.SW6_FQ)}
    print("field_kernels_at_odd_widths " + json.dumps(odd_edges), flush=True)

    def pairing_odd(family):
        """GT of (G1, G2) against the python-int oracle (and, on SW6, the
        pinned vector of the reference's 782-bit loop); e(3P, 5Q) =
        e(P, Q)^15 and GT^r = 1 on the card; the seconds and launches of
        the host ladder, the prepared Miller loop and the final
        exponentiation."""
        E = engines[family]
        H = getattr(pairing_host, f"host_{family}_pairing")()
        hg1, hg2, fr_ = groth16_host.host_curves(family)
        P, Q = E.g1.generator_affine, E.g2.generator_affine
        out = {"family": family, "loop_digits": len(E.wnaf)}
        with layout_log() as layouts:
            prep, out["prepare_g2_s"], _ = counted(lambda: E.prepare_g2(Q))
            f, out["miller_loop_s"], out["miller_loop_launches"] = counted(
                lambda: E.miller_loop_prepared(P, prep))
            gt, out["final_exponentiation_s"], \
                out["final_exponentiation_launches"] = counted(
                    lambda: E.final_exponentiation(f))
        odd_layouts[family, "pairing"] = layouts.seen
        want = H.pairing(hg1.gen, hg2.gen)
        if fp.fp_to_ints(E.fp, gt) != want:
            raise AssertionError(f"{family}: e(G1, G2) differs from the "
                                 f"python-int oracle")
        out["checks"] = {"e(G1, G2) equals the python-int oracle": True}
        if family == "sw6":
            if want != SW6_GT_G1G2:
                raise AssertionError("sw6: e(G1, G2) differs from the "
                                     "pinned vector")
            out["checks"]["e(G1, G2) equals the pinned vector"] = True
        p3, q5 = hg1.mul(hg1.gen, 3), hg2.mul(hg2.gen, 5)
        gt35 = E.pairing(E.g1.affine_from_ints(*p3),
                         E.g2.affine_from_ints(*q5))
        F = E.fqk
        if not torch.equal(gt35, T.ext_pow_const(
                F, gt, limbs.bits_msb_first(15, 4))):
            raise AssertionError(f"{family}: e(3P, 5Q) != e(P, Q)^15")
        r = fr_.modulus
        if not torch.equal(T.ext_pow_const(
                F, gt, limbs.bits_msb_first(r, r.bit_length())),
                F.tensor("one", dev)) or torch.equal(
                    gt, F.tensor("one", dev)):
            raise AssertionError(f"{family}: GT^r != 1 or GT = 1")
        out["checks"].update({"e(3P, 5Q) = e(P, Q)^15": True,
                              "GT^r = 1 and GT != 1": True})
        return out

    def refusals(engine, params, proof, inputs, wrong, line):
        """verify_proof refuses the wrong inputs and C + G1's generator."""
        g = engine.g1
        altered = groth16.Proof(a=proof.a, b=proof.b, c=g.to_affine(
            g.add_mixed(g.from_affine(*proof.c), g.generator_affine)))
        for label, args in (("wrong input", (proof, wrong)),
                            ("altered C", (altered, inputs))):
            if verify(params, *args, label, engine, line["checks"])[0] \
                    is not False:
                raise AssertionError(f"{engine.name} verify_proof: {label} "
                                     f"accepted")

    # MNT6-298: the pairing, Groth16 and GM17 at 2^10, the golden bytes
    line = pairing_odd("mnt6298")
    odd_paths["pairing_mnt6298"] = {"path_launches": {
        k: line["miller_loop_launches"].get(k, 0) +
        line["final_exponentiation_launches"].get(k, 0)
        for k in fp.launch_counts}}
    print("pairing_odd " + json.dumps(line), flush=True)
    line, (cs_, compiled_, params_, proof_, dev_, _) = rung(
        10, phases=True, family="mnt6298")
    odd_paths["groth16_mnt6298_2p10"] = r298 = line
    print("rung " + json.dumps(line), flush=True)
    verify298 = {"family": "mnt6298", "rungs": {}, "checks": {}}
    verify_rung(10, cs_, params_, dev_, eng298, verify298)
    if fp.fp_to_ints(eng298.fp, params_.vk.alpha_g1_beta_g2) != \
            host_alpha_beta(TOXIC["alpha"], TOXIC["beta"], "mnt6298"):
        raise AssertionError("mnt6298: vk.alpha_g1_beta_g2 differs from the "
                             "python-int oracle")
    verify298["checks"]["alpha_g1_beta_g2 equals the oracle"] = True
    inputs_ = cs_.input_values[1:]
    refusals(eng298, params_, dev_, inputs_,
             [inputs_[0] + 1] + inputs_[1:], verify298)
    print("verify " + json.dumps(verify298), flush=True)
    serial298 = {"family": "mnt6298", "rungs": {}}
    serialization(10, cs_, params_, proof_, dev_, eng298, serial298)
    # the golden proof A = [2]G1, B = G2, C = G1, written from its points
    ga, gb, gc = mnt6298_golden_points()
    golden = groth16.Proof(a=eng298.g1.affine_from_ints(*ga),
                           b=eng298.g2.affine_from_ints(*gb),
                           c=eng298.g1.affine_from_ints(*gc))
    raw = serialize.proof_to_bytes(eng298, golden)
    back, used = serialize.proof_from_bytes(eng298, raw)
    if raw != bytes.fromhex(GOLDEN_MNT6298_PROOF) or used != len(raw) or \
            groth16.proof_to_ints(eng298, back) != {
                "a": ga, "b": gb, "c": gc}:
        raise AssertionError("mnt6298: the golden proof bytes differ")
    serial298["golden_proof_bytes"] = {"bytes": len(raw), "equal": True,
                                       "round_trip": True}
    print("serialization " + json.dumps(serial298), flush=True)
    del params_, dev_, compiled_
    line = gm17_rung("mnt6298", 10, "Domain", 4096)
    odd_paths["gm17_mnt6298_2p10"] = g298 = line
    print("gm17 " + json.dumps(line), flush=True)

    # SW6: the pairing, then the outer Groth16 proof of the BLS12-377
    # verifier circuit (42,006 constraints, 254 inputs: domain 2^16 over
    # SW6 Fr = BLS12-377 Fq) -- the section's main path
    line = pairing_odd("sw6")
    odd_paths["pairing_sw6"] = {"path_launches": {
        k: line["miller_loop_launches"].get(k, 0) +
        line["final_exponentiation_launches"].get(k, 0)
        for k in fp.launch_counts}}
    print("pairing_odd " + json.dumps(line), flush=True)
    cs77, cs78 = bls_circuits[77], bls_circuits[78]
    t = time.perf_counter()
    line, (cs_, compiled_, params_, proof_, dev_, _) = rung(
        16, phases=True, family="sw6",
        circuit=("bls12_377_groth16_verifier", cs77))
    if (params_.domain_size, cs_.num_constraints, cs_.num_inputs) != (
            1 << 16, 42006, 254):
        raise AssertionError(f"sw6: domain {params_.domain_size} for "
                             f"{cs_.num_constraints} constraints")
    outer_sw6 = line
    odd_paths["groth16_sw6_outer"] = line
    print("rung " + json.dumps(line), flush=True)
    verify_sw6 = {"family": "sw6", "rungs": {}, "checks": {}}
    verify_rung(16, cs_, params_, dev_, eng_sw6, verify_sw6)
    if fp.fp_to_ints(eng_sw6.fp, params_.vk.alpha_g1_beta_g2) != \
            host_alpha_beta(TOXIC["alpha"], TOXIC["beta"], "sw6"):
        raise AssertionError("sw6: vk.alpha_g1_beta_g2 differs from the "
                             "python-int oracle")
    verify_sw6["checks"]["alpha_g1_beta_g2 equals the oracle"] = True
    refusals(eng_sw6, params_, dev_, cs77.input_values[1:],
             cs78.input_values[1:], verify_sw6)
    verify_sw6["checks"]["accepts the bits of 77"] = True
    print("verify " + json.dumps(verify_sw6), flush=True)
    # the BLS12-377 recursion's line with its outer proof: seconds by
    # phase, launches by kind and by digit count, K4-K6 widths, peak memory
    rec_bls["outer_sw6"] = {
        **{k: line[k] for k in (
            "constraints", "inputs", "setup_s", "setup_phases_s",
            "prove_first_s", "prove_phases_s", "path_launches",
            "path_launches_by_digits", "curve_launches_by_lanes",
            "peak_device_gib", "qap_equals_host_oracle")},
        "verify_s": verify_sw6["rungs"]["2^16"],
        "domain_size": params_.domain_size,
        "checks": {"equals expected_proof('sw6', ...)": True,
                   **verify_sw6["checks"]},
        "section_s": time.perf_counter() - t}
    print("recursion_bls12 " + json.dumps(rec_bls), flush=True)
    del params_, dev_, compiled_

    # the launches at 49 digits on the outer proof's path: K1, add/sub, K2
    # and K4-K6 (its scalar field, BLS12-377 Fq, runs at 24)
    at49 = {k: v.get(49, 0)
            for k, v in outer_sw6["path_launches_by_digits"].items()}
    for k in ("mont_mul", "fp_add", "fp_sub", "inv_bea", "ec_proj_add",
              "ec_affine_pre", "ec_affine_post", "inv_tree_up",
              "inv_tree_tail", "inv_tree_down"):
        if at49.get(k, 0) <= 0:
            raise AssertionError(f"the SW6 outer proof never launched {k} "
                                 f"at 49 digits")

    def merged(*layouts):
        out = {}
        for lay in layouts:
            for key, n in lay.items():
                out[key] = out.get(key, 0) + n
        return out

    # the rows at 19 digits: the MNT6-298 paths (K4 runs in GM17's prove),
    # at 49: the SW6 outer proof (its SW6 Fq layouts)
    w19 = {}
    for ln in (r298, g298):
        for k, by_w in ln["curve_launches_by_width"].items():
            for wd, n in by_w.items():
                w19.setdefault(k, {})
                w19[k][wd] = w19[k].get(wd, 0) + n
    l19 = {k: r298["path_launches"].get(k, 0) +
           g298["path_launches"].get(k, 0) for k in fp.launch_counts}
    rows19, field19 = curve_kernel_rows(
        w19, eng298.g1, l19, merged(setup_layouts["mnt6298", 10],
                                    odd_layouts["mnt6298", "pairing"]),
        "groth16_and_gm17_mnt6298_2p10", "d19")
    seen49 = {key: n for key, n in merged(
        setup_layouts["sw6", 16], odd_layouts["sw6", "pairing"]).items()
        if key[1] == PP.SW6_FQ.name}
    rows49, field49 = curve_kernel_rows(
        outer_sw6["curve_launches_by_width"], eng_sw6.g1, at49, seen49,
        "groth16_sw6_outer", "d49")
    for row in rows19 + rows49:
        edge = odd_edges[row["field"]]
        name = row["kernel"]
        key = "batch_inverse" if name.startswith("inv_tree") else name
        row["max_abs_err"] = max(row["max_abs_err"], edge.get(key, 0))
    print("field_kernels_at_odd_widths_layouts " + json.dumps(
        {"d19": field19, "d49": field49}), flush=True)
    print("odd_curve_kernels " + json.dumps(rows19 + rows49), flush=True)
    # every path launched K1, K2 and add/sub; the rungs K5 and K6 too
    for name, line in odd_paths.items():
        need = ["mont_mul", "inv_bea", "fp_add", "fp_sub"]
        if not name.startswith("pairing"):
            need += ["ec_affine_pre", "ec_affine_post", "inv_tree_tail"]
        for k in need:
            if line["path_launches"].get(k, 0) <= 0:
                raise AssertionError(f"{name} never launched {k}")
    print(f"odd_widths_section_s {time.perf_counter() - t_odd:.1f}",
          flush=True)

    # ------------------------------------------------------------------
    # 4a. FFT: 2^20 radix-2 over MNT4-753 Fr, mixed radix over MNT6-753 Fr
    # ------------------------------------------------------------------

    def fft_phase(F, dom, seed):
        """fft and ifft of one seeded input on ``dom``: the tables' build
        on the device beside the same table in python ints, host-clock and
        device seconds, launches, the round trip digit for digit, and
        sampled evaluations against Horner's rule in python ints at w^i."""
        n, q = dom.size, F.modulus
        out = {"field": F.name, "size": n,
               "factors": getattr(dom, "factors", None)}
        table_n = n // 2 if isinstance(dom, fft_mod.Domain) else n
        torch.cuda.synchronize()
        t = time.perf_counter()
        tables = [dom._powers(b, table_n) for b in (dom.gen, dom.gen_inv)]
        torch.cuda.synchronize()
        out["tables_build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        vals, w = [], 1
        for _ in range(table_n):
            vals.append(w)
            w = w * dom.gen % q
        host = torch.from_numpy(fp.fp_from_ints(F, vals)).to(dev)
        torch.cuda.synchronize()
        out["one_table_in_python_ints_s"] = time.perf_counter() - t
        if not torch.equal(host, tables[0]):
            raise AssertionError(f"{F.name}: the device table of powers "
                                 f"differs from python ints")
        del host, vals
        raw = torch.randint(0, 1 << 16, (n, nd), dtype=torch.int64,
                            generator=torch.Generator().manual_seed(seed))
        raw[:, -1] = 0                       # below 2^752 < the modulus
        x = raw.to(dev)
        for name, fn in (("fft", dom.fft), ("ifft", dom.ifft)):
            fp.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = fn(x)
            torch.cuda.synchronize()
            out[f"{name}_s"] = time.perf_counter() - t
            out[f"{name}_launches"] = {k: v for k, v in
                                       fp.launch_counts.items() if v}
            out[f"{name}_device_s"] = event_seconds(lambda: fn(x))[1]
        y = dom.fft(x)
        back = dom.ifft(y)
        if not torch.equal(back, x):
            raise AssertionError(f"{F.name} size {n}: ifft(fft(x)) != x")
        del back
        coeffs = fp.fp_to_ints(F, x)
        # a Horner evaluation at 2^20 is ~3 s of python ints: one forked
        # process a sample, all at once
        idx = sorted(random.Random(seed).sample(range(n), 8))
        got = fp.fp_to_ints(F, y[idx])
        t = time.perf_counter()
        _HORNER.update(coeffs=coeffs, modulus=q)
        with multiprocessing.get_context("fork").Pool(len(idx)) as pool:
            want = pool.map(_horner_at, [pow(dom.gen, i, q) for i in idx])
        _HORNER.clear()
        for i, g, v in zip(idx, got, want):
            if v != g:
                raise AssertionError(f"{F.name} size {n}: fft(x)[{i}] is "
                                     f"not x(w^{i})")
        out["horner_s"] = time.perf_counter() - t
        out.update(roundtrip_exact=True, evaluations_checked=idx)
        return out

    print("fft " + json.dumps(fft_phase(fr, fft_mod.Domain(fr, 1 << 20), 20)),
          flush=True)
    mixed_dom = fft_mod.best_domain(PP.MNT6753_FR, 1 << 17)
    if not isinstance(mixed_dom, fft_mod.MixedRadixDomain):
        raise AssertionError("best_domain took radix 2 beyond 2^15")
    print("fft_mixed " + json.dumps(fft_phase(PP.MNT6753_FR, mixed_dom, 17)),
          flush=True)
    del mixed_dom

    # ------------------------------------------------------------------
    # 4b. the field API: Legendre symbol and square root (K3)
    # ------------------------------------------------------------------

    def field_api_phase():
        """``legendre`` and ``sqrt_mod`` on 2^12 elements of MNT4-753 Fr and
        Fq, half of them squares, one of them zero, held against python
        ints: Euler's criterion, x^2 = a, and the mask."""
        inputs = {}
        for seed, F in enumerate((fr, fq)):
            xs, _ = field_elems(F, POW_N, seed=31 + seed)
            others, _ = field_elems(F, POW_N, seed=41 + seed)
            p_ = F.modulus
            vals = [x * x % p_ for x in xs[:POW_N // 2]] + others[POW_N // 2:]
            vals[0] = 0
            inputs[F.name] = (F, vals, torch.from_numpy(
                fp.fp_from_ints(F, vals)).to(dev))
        out = {"elements": POW_N}
        fp.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        results = {name: (fp.legendre(F, a), *fp.sqrt_mod(F, a))
                   for name, (F, _, a) in inputs.items()}
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t
        out["path_launches"] = {k: v for k, v in fp.launch_counts.items()
                                if v}
        if out["path_launches"].get("pow_const") != 4:
            raise AssertionError(f"field API: {out['path_launches']} K3 "
                                 f"launches, not one a call (4)")
        for name, (F, vals, _) in inputs.items():
            leg, root, ok = results[name]
            p_ = F.modulus
            roots = fp.fp_to_ints(F, root.cpu())
            squares = 0
            for v, sym, r, has in zip(vals, leg.tolist(), roots, ok.tolist()):
                e = pow(v, (p_ - 1) // 2, p_)
                want = 0 if v == 0 else (1 if e == 1 else -1)
                if sym != want or has != (want >= 0):
                    raise AssertionError(f"{name}: legendre or the sqrt "
                                         f"mask disagrees with Euler's "
                                         f"criterion")
                if has and r * r % p_ != v:
                    raise AssertionError(f"{name}: sqrt_mod root squared is "
                                         f"not the input")
                squares += has
            if squares < POW_N // 2:
                raise AssertionError(f"{name}: fewer squares than were made")
            out[f"{name}_squares"] = squares
        return out

    field_api = field_api_phase()
    print("field_api " + json.dumps(field_api), flush=True)

    # ------------------------------------------------------------------
    # 4c. the Poseidon Merkle tree (K9): 2^16 leaves, height 17
    # ------------------------------------------------------------------

    class PlainHash(PoseidonHash):
        """The same sponge over the plain permutation (array code)."""
        def permute(self, state):
            return PK.permute_plain(self.p, state)

    def host_root(leaves, height):
        """Levels and root of the tree by the python-int oracle."""
        levels = [list(leaves)]
        while len(levels[-1]) > 1:
            cur = levels[-1]
            levels.append([host4.evaluate([cur[i], cur[i + 1]])
                           for i in range(0, len(cur), 2)])
        root = levels[-1][0]
        empty = host4.evaluate([1])
        for _ in range(len(levels), height):
            root = host4.evaluate([root, empty])
        return levels, root

    def merkle_rung(log2=16):
        F = P4.field
        h = PoseidonHash(P4)
        n, height = 1 << log2, log2 + 1
        leaf_ints, _ = field_elems(F, n, seed=51)
        leaves = torch.from_numpy(fp.fp_from_ints(F, leaf_ints)).to(dev)
        out = {"leaves": n, "height": height}
        fp.reset_launch_counts()
        PK.launch_widths.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tree = FieldBasedMerkleTree(h, height).build(leaves)
        torch.cuda.synchronize()
        out["build_first_s"] = time.perf_counter() - t
        out["path_launches"] = {k: v for k, v in fp.launch_counts.items()
                                if v}
        out["poseidon_launches_by_width"] = dict(sorted(
            PK.launch_widths.items()))
        # one K9 launch a level (a permutation a launch), two additions a
        # level's sponge
        if out["path_launches"] != {"fp_add": 2 * log2,
                                    "poseidon_permute": log2}:
            raise AssertionError(f"merkle: launches {out['path_launches']}, "
                                 f"not {log2} K9 and {2 * log2} add")
        out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
        hashes = n - 1 + len(tree.padding)
        t = time.perf_counter()
        again = FieldBasedMerkleTree(h, height).build(leaves)
        torch.cuda.synchronize()
        out["build_steady_s"] = time.perf_counter() - t
        out["hashes"] = hashes
        out["hashes_per_s"] = hashes / out["build_steady_s"]
        if not torch.equal(again.root(), tree.root()):
            raise AssertionError("merkle: two builds gave two roots")
        plain, out["plain_build_s"] = event_seconds(
            lambda: FieldBasedMerkleTree(PlainHash(P4), height).build(leaves))
        for lvl, (a, b) in enumerate(zip(tree.levels, plain.levels)):
            compare(f"merkle level {lvl}", a, b)
        compare("merkle root", tree.root(), plain.root())
        # one 2 -> 1 hash at a batch of one and at the largest level's
        for b in (1, n // 2):
            out[f"hash_2_1_ms_batch_{b}"] = time_ms(
                lambda: h.hash_2_1(leaves[0:2 * b:2], leaves[1:2 * b:2]), 3)
        # sampled paths, on the device and by the python-int oracle
        root_int = fp.fp_to_int(F, tree.root().cpu())
        picks = torch.randint(0, n, (16,), generator=torch.Generator()
                              .manual_seed(52)).tolist()
        for i in picks:
            path = tree.generate_proof(i)
            if not tree.verify_proof(tree.root(), leaves[i], path):
                raise AssertionError(f"merkle: the path of leaf {i} does not "
                                     f"verify")
            cur = leaf_ints[i]
            for sib, right in path:
                s_ = fp.fp_to_int(F, sib.cpu())
                cur = host4.evaluate([s_, cur] if right else [cur, s_])
            if cur != root_int:
                raise AssertionError(f"merkle: the path of leaf {i} does not "
                                     f"hash to the root in python ints")
        wrong = fp.add_mod(F, leaves[picks[0]], fp.to_mont(
            F, torch.from_numpy(limbs.to_digits(1, nd)).to(dev)))
        if tree.verify_proof(tree.root(), wrong,
                             tree.generate_proof(picks[0])):
            raise AssertionError("merkle: a wrong leaf verified")
        out["paths_verified"] = len(picks)
        # 2^10 leaves at height 12 (one padding hash): every node against the
        # python-int oracle
        small = FieldBasedMerkleTree(h, 12).build(leaves[:1 << 10])
        want_levels, want_root = host_root(leaf_ints[:1 << 10], 12)
        for lvl, (got, want) in enumerate(zip(small.levels, want_levels)):
            if fp.fp_to_ints(F, got.cpu()) != want:
                raise AssertionError(f"merkle 2^10: level {lvl} differs from "
                                     f"the python-int tree")
        if len(small.padding) != 1 or \
                fp.fp_to_int(F, small.root().cpu()) != want_root:
            raise AssertionError("merkle 2^10: root differs from the "
                                 "python-int tree")
        # the phantom root (field_based_mht/mod.rs:300-315)
        magic = (b"This represents an empty Merkle Root for a "
                 b"MNT4753PoseidonHash based Merkle Tree.")
        x = int.from_bytes(magic + b"\x00" * ((753 + 15) // 8 - len(magic)),
                           "little")
        if h.evaluate_ints([[x]])[0] != MNT4753_PHANTOM_MERKLE_ROOT:
            raise AssertionError("merkle: the phantom root does not hold")
        return out

    merkle = merkle_rung()
    print("merkle " + json.dumps(merkle), flush=True)

    def poseidon_by_width(widths):
        """K9 at each width the Merkle rung launched it (its levels, 2^15
        sponges down to one), on seeded states: held to the plain version,
        the launcher's S, device time, the bound (the function's own work
        at that width: one shared inversion a round) and the loss, the
        launches x (device time - bound)."""
        F = P4.field
        _, flat = field_elems(F, 3 * max(widths), seed=24)
        states = fp.to_mont(F, flat).reshape(-1, 3, nd)
        rows = []
        for n, launches in sorted(widths.items()):
            x = states[:n]
            want, roots = plain_permute_roots(P4, x)
            compare(f"poseidon by width [{n},3,48]", PK.permute(P4, x),
                    want)
            b_ms, b_by = bound(*permute_work(P4, n, roots))
            row = {"kernel": "poseidon_permute", "width": n,
                   "launches": launches, "S": block_s(n),
                   "device_ms": graph_ms(lambda: PK.permute(P4, x),
                                         2 if n > 1 << 12 else 3),
                   "bound_ms": b_ms, "bound_by": b_by}
            row["loss_ms"] = launches * (row["device_ms"] - b_ms)
            rows.append(row)
        return {"rows": rows, "loss_ms": sum(r["loss_ms"] for r in rows),
                "device_ms": sum(r["launches"] * r["device_ms"]
                                 for r in rows)}

    k9_by_width = poseidon_by_width(merkle["poseidon_launches_by_width"])
    print("poseidon_by_width " + json.dumps(k9_by_width), flush=True)

    # ------------------------------------------------------------------
    # 4g. the twisted-Edwards curves, Pedersen and the signatures: the TE
    #     group laws on all three curves, Pedersen over Edwards-BLS12 at
    #     the reference benches' window, Schnorr and the VRF over MNT6-753
    #     G1, and two Groth16 proofs of circuits built from their gadgets
    # ------------------------------------------------------------------
    t_te = time.perf_counter()
    te_paths = {}         # the new paths whose launches are checked
    te_launches16 = {}    # the 16-digit lines' launches, by kernel

    def add_launches(into, launches):
        for k, v in launches.items():
            into[k] = into.get(k, 0) + v

    def host_te_mul(gg, P, k):
        """[k] P in python ints through the TE gadget's ``_host_add`` and
        ``_host_double``."""
        acc = (0, 1)
        for bit in bin(k)[2:]:
            acc = gg._host_double(acc)
            if bit == "1":
                acc = gg._host_add(acc, P)
        return acc

    def te_pairs(curve, P):
        return list(zip(*affine_ints(curve, P)))

    def twisted_edwards_line(name, seed):
        """The generator on the curve; the group laws on 2^10 seeded
        points ([k_i] G, one loop of 2^10 lanes), four of them against
        python ints; one scalar multiply [k] G of a full-width k, timed,
        launches counted, against python ints; [r] G = 0."""
        te = getattr(CI, name)()
        gg = TEGroupGadget.for_curve(te)
        rng = random.Random(seed)
        r = te.scalar_field.modulus
        out = {"curve": name, "field": te.fp.name,
               "field_digits": te.fp.n_digits, "lanes": 1 << 10}
        fp.reset_launch_counts()
        G = te.generator(())
        checks = {"generator on the curve": bool(te.on_curve(
            *te.generator_affine))}
        ks = [rng.randrange(1, r) for _ in range(1 << 10)]
        P, out["points_2p10_s"], _ = phase(lambda: mul_ints(te, G, ks))
        Q = tuple(c.roll(1, 0) for c in P)
        R = tuple(c.roll(2, 0) for c in P)
        checks["2^10 points on the curve"] = bool(te.on_curve(
            *te.to_affine(P)).all())
        checks["four points equal python ints"] = \
            te_pairs(te, tuple(c[:4] for c in P)) == [
                host_te_mul(gg, te.generator_host, k) for k in ks[:4]]
        laws, out["laws_s"], _ = phase(lambda: {
            "dbl = add": te.eq(te.double(P), te.add(P, P)),
            "associativity": te.eq(te.add(te.add(P, Q), R),
                                   te.add(P, te.add(Q, R))),
            "P + (-P) = 0": te.is_zero(te.add(P, te.neg(P))),
            "P + 0 = P": te.eq(te.add(P, te.zero((1 << 10,))), P)})
        checks.update({k: bool(v.all()) for k, v in laws.items()})
        k = rng.randrange(1 << (r.bit_length() - 1), r)   # full width
        kG, out["mul_s"], out["mul_launches"] = phase(
            lambda: mul_ints(te, G, [k]))
        out["mul_scalar_bits"] = k.bit_length()
        checks["[k]G equals python ints"] = te_pairs(te, kG) == [
            host_te_mul(gg, te.generator_host, k)]
        rG, out["mul_r_s"], _ = phase(lambda: mul_ints(te, G, [r]))
        checks["[r]G = 0"] = bool(te.is_zero(rG).all())
        out["path_launches"] = dict(fp.launch_counts)
        out["checks"] = checks
        if not all(checks.values()):
            raise AssertionError(f"twisted_edwards {name}: {checks}")
        return out

    def pedersen_line():
        """Pedersen over Edwards-BLS12 at window 250 x 8 (2,000 bits, 250
        input bytes): the commitment's setup (the CRH's 8 generators and
        the randomness generator as lanes of one loop, their chains side
        by side), timed with launches, its generators against python ints;
        a seeded 250-byte evaluate, a commit with a seeded randomness of
        Fr and the compressor's x, each against python ints; then the
        Bowe-Hopwood group hash over MNT6-753 G1 (the VRF's: 64 x 4,
        ``random.Random(9174123)``) set up on the card and on the host,
        its generators and a short input's hash equal."""
        te = CI.edwards_bls12()
        gg = TEGroupGadget.for_curve(te)
        window = PedersenWindow(250, 8)
        r = te.scalar_field.modulus
        out = {"curve": "edwards_bls12", "window_size": 250,
               "num_windows": 8, "input_bytes": 250}
        fp.reset_launch_counts()
        comm, out["setup_s"], out["setup_launches"] = phase(
            lambda: PedersenCommitment(te, window).setup(
                random.Random(2000)))
        draw = random.Random(2000)
        gens = [host_te_mul(gg, te.generator_host, draw.randrange(1, r))
                for _ in range(9)]
        checks = {"generators equal python ints":
                  comm.crh.generators_host == gens[:8]
                  and comm.rand_base_host == gens[8]}
        rng = random.Random(250)
        data = bytes(rng.randrange(256) for _ in range(250))
        rnd = rng.randrange(r)
        pt, out["evaluate_s"], out["evaluate_launches"] = phase(
            lambda: comm.crh.evaluate(data))
        bits = ped_mod._bytes_to_bits(data)
        want = (0, 1)
        for w in range(8):
            chunk = bits[250 * w:250 * w + 250]
            m = sum(b << i for i, b in enumerate(chunk))
            want = gg._host_add(want, host_te_mul(gg, gens[w], m))
        checks["evaluate equals python ints"] = te_pairs(te, pt) == [want]
        cpt, out["commit_s"], out["commit_launches"] = phase(
            lambda: comm.commit(data, rnd))
        commitment = gg._host_add(want, host_te_mul(gg, gens[8], rnd))
        checks["commit equals python ints"] = \
            te_pairs(te, cpt) == [commitment]
        comp = PedersenCRHCompressor(te, window)
        comp.crh = comm.crh
        x, out["compressor_s"], out["compressor_launches"] = phase(
            lambda: comp.evaluate(data))
        checks["compressor x equals python ints"] = \
            fp.fp_to_int(te.fp, x[0].cpu()) == want[0]
        out["path_launches"] = dict(fp.launch_counts)
        # the Bowe-Hopwood group hash over MNT6-753 G1
        g6 = CI.mnt6753_g1()
        bh = {"curve": "mnt6753_g1", "window_size": 64, "num_windows": 4}
        rng_h, rng_d = random.Random(9174123), random.Random(9174123)
        fp.reset_launch_counts()
        gh_host = mnt6753_g1_group_hash(64, 4).setup(rng_h)
        gh_dev, bh["setup_s"], bh["setup_launches"] = phase(
            lambda: BoweHopwoodCRH(g6, PedersenWindow(64, 4)).setup(rng_d))
        checks["group hash generators equal the host's"] = \
            list(zip(*affine_ints(g6, gh_dev.params))) == [
                (x[0], y[0]) for row in gh_host.generators
                for x, y in row]
        short = bytes(rng.randrange(256) for _ in range(20))
        hpt, bh["short_input_s"], bh["short_input_launches"] = phase(
            lambda: gh_dev.evaluate(short))
        bh["short_input_bytes"] = len(short)
        want_h = gh_host.evaluate(short)
        checks["Bowe-Hopwood of a short input equals BoweHopwoodHost"] = \
            te_pairs(g6, hpt) == [(want_h[0][0], want_h[1][0])]
        bh["path_launches"] = dict(fp.launch_counts)
        out["bowe_hopwood"] = bh
        out["checks"] = checks
        if not all(checks.values()):
            raise AssertionError(f"pedersen: {checks}")
        return out, (comm, data, rnd, commitment, gens[:8]), \
            (gh_host, gh_dev, rng_h, rng_d)

    class CountingRandom(random.Random):
        """random.Random that counts its draws: one a try of a rejection
        loop.  Its state carries the count, so the draws that a loop gives
        back (``schnorr._tries``) are not counted."""
        draws = 0

        def randrange(self, *a, **k):
            self.draws += 1
            return super().randrange(*a, **k)

        def getstate(self):
            return super().getstate(), self.draws

        def setstate(self, state):
            super().setstate(state[0])
            self.draws = state[1]

    def signatures_line(gh_host, gh_dev, rng_h, rng_d):
        """Field-based Schnorr and the VRF over MNT6-753 G1 with
        MNT4-753-Fr Poseidon on the card, every call timed with its
        launches and the rejection loops' tries, against ``HostSchnorr``
        and ``HostVrf`` on the JAX tests' seeds."""
        g6 = CI.mnt6753_g1()
        h = PoseidonHash(PoseidonParams.mnt4753())
        out = {"curve": "mnt6753_g1", "hash": "poseidon_mnt4753",
               "schnorr": {}, "vrf": {}}
        sch_line, vrf_line = out["schnorr"], out["vrf"]
        msg = [424242]
        hs = HostSchnorr()
        t = time.perf_counter()
        rng = random.Random(1231275789)
        pk_h, sk_h = hs.keygen(rng)
        sig_h = hs.sign(pk_h, sk_h, msg, rng)
        sch_line["host_oracle_s"] = time.perf_counter() - t
        sch = FieldBasedSchnorr(g6, h)
        rng = CountingRandom(1231275789)
        fp.reset_launch_counts()
        (pk, sk), *calls = phase(lambda: sch.keygen(rng))
        sch_line["keygen"] = dict(zip(("s", "launches"), calls))
        before = rng.draws
        sig, *calls = phase(lambda: sch.sign(pk, sk, msg, rng))
        sch_line["sign"] = dict(zip(("s", "launches"), calls),
                                tries=rng.draws - before)
        ok, *calls = phase(lambda: sch.verify(pk, msg, sig))
        sch_line["verify"] = dict(zip(("s", "launches"), calls))
        bad, *calls = phase(lambda: sch.verify(pk, [msg[0] + 1], sig))
        sch_line["verify_message_plus_one"] = dict(zip(("s", "launches"),
                                                       calls))
        kv, *calls = phase(lambda: sch.keyverify(pk))
        sch_line["keyverify"] = dict(zip(("s", "launches"), calls))
        sch_line["path_launches"] = dict(fp.launch_counts)
        checks = {"schnorr (pk, e, s) equal HostSchnorr's":
                  te_pairs(g6, pk) == [(pk_h[0][0], pk_h[1][0])]
                  and (sig.e, sig.s) == sig_h and sk == sk_h,
                  "verify accepts": ok, "verify refuses message + 1":
                  not bad, "keyverify accepts": kv}
        # the VRF: the group hash of the pedersen line, its rng's draws
        # continued on both sides
        vmsg = [987654321]
        hv = HostVrf(gh_host)
        t = time.perf_counter()
        vpk_h, vsk_h = hv.keygen(rng_h)
        proof_h = hv.prove(vpk_h, vsk_h, vmsg, rng_h)
        out_h = hv.proof_to_hash(vpk_h, vmsg, proof_h)
        vrf_line["host_oracle_s"] = time.perf_counter() - t
        vrf = FieldBasedEcVrf(g6, h, gh_dev)
        rng = CountingRandom()
        rng.setstate((rng_d.getstate(), 0))
        fp.reset_launch_counts()
        (vpk, vsk), *calls = phase(lambda: vrf.keygen(rng))
        vrf_line["keygen"] = dict(zip(("s", "launches"), calls))
        before = rng.draws
        proof, *calls = phase(lambda: vrf.prove(vpk, vsk, vmsg, rng))
        vrf_line["prove"] = dict(zip(("s", "launches"), calls),
                                 tries=rng.draws - before)
        output, *calls = phase(lambda: vrf.proof_to_hash(vpk, vmsg, proof))
        vrf_line["proof_to_hash"] = dict(zip(("s", "launches"), calls))
        vrf_line["path_launches"] = dict(fp.launch_counts)
        try:
            vrf.proof_to_hash(vpk, [vmsg[0] + 1], proof)
        except ValueError:
            refused = True
        else:
            refused = False
        checks.update({
            "vrf (gamma, c, s) equal HostVrf's":
                te_pairs(g6, vpk) == [(vpk_h[0][0], vpk_h[1][0])]
                and ((proof.gamma[0],), (proof.gamma[1],), proof.c,
                     proof.s) == (tuple(proof_h[0][0]),
                                  tuple(proof_h[0][1]), proof_h[1],
                                  proof_h[2]),
            "vrf output equals HostVrf's": output == out_h,
            "vrf refuses a wrong message": refused})
        out["checks"] = checks
        if not all(checks.values()):
            raise AssertionError(f"signatures: {checks}")
        return out, (pk, sig, msg)

    def circuit_rung(family, name, cs, wrong_inputs):
        """A rung on a circuit of the gadgets: setup and prove with
        phases (``rung``: the proof against ``expected_proof``, the QAP
        against ``qap_at``), one verify by phase with its launches, and
        the refusals of a wrong public input and of C + G1's generator."""
        engine = engines[family]
        log2 = (cs.num_constraints - 1).bit_length()
        line, (cs_, _, params_, _, dev_, _) = rung(
            log2, phases=True, family=family, circuit=(name, cs))
        # the engines' common entry points: the Miller loops (with the
        # G2 side and the product of the Miller values) are the product
        # of pairings less its final exponentiation
        targets = ((groth16, "accumulate_inputs"),
                   (engine, "product_of_pairings"),
                   (engine, "final_exponentiation"))
        inputs = cs_.input_values[1:]
        checks = line["verify_checks"] = {}
        fp.reset_launch_counts()
        with phase_clock(targets) as clock:
            ok, total = verify(params_, dev_, inputs, "accepts", engine,
                               checks)
        phases = {k: sum(v) for k, v in clock.take().items()}
        phases["miller_loop"] = phases.pop("product_of_pairings") - \
            phases["final_exponentiation"]
        phases["other"] = total - sum(phases.values())
        line["verify_s"] = total
        line["verify_phases_s"] = phases
        line["verify_launches"] = dict(fp.launch_counts)
        g1_ = engine.g1
        altered = groth16.Proof(a=dev_.a, b=dev_.b, c=g1_.to_affine(
            g1_.add_mixed(g1_.from_affine(*dev_.c), g1_.generator_affine)))
        for label, proof_inputs in (("wrong public input",
                                     (dev_, wrong_inputs)),
                                    ("altered C", (altered, inputs))):
            checks[f"refuses {label}"] = not verify(
                params_, *proof_inputs, label, engine, {})[0]
        if not all(checks.values()):
            raise AssertionError(f"{name}: verify checks {checks}")
        del params_, dev_, altered
        return line

    with layout_log() as te_layouts:
        for name, seed in (("jubjub", 161), ("edwards_bls12", 162),
                           ("edwards_sw6", 163)):
            line = twisted_edwards_line(name, seed)
            te_paths[f"twisted_edwards_{name}"] = line
            if line["field_digits"] == 16:
                add_launches(te_launches16, line["path_launches"])
            print("twisted_edwards " + json.dumps(line), flush=True)
        ped_line, ped_case, gh_case = pedersen_line()
    te_paths["pedersen"] = ped_line
    te_paths["bowe_hopwood"] = ped_line["bowe_hopwood"]
    add_launches(te_launches16, ped_line["path_launches"])
    print("pedersen " + json.dumps(ped_line), flush=True)
    sig_line, (s_pk, s_sig, s_msg) = signatures_line(*gh_case)
    te_paths["schnorr"] = sig_line["schnorr"]
    te_paths["vrf"] = sig_line["vrf"]
    print("signatures " + json.dumps(sig_line), flush=True)

    # the two Groth16 rungs on the gadgets' circuits
    pk_xy = affine_ints(CI.mnt6753_g1(), s_pk)
    s_cs = schnorr_verification_circuit(
        (pk_xy[0], pk_xy[1]), (s_sig.e, s_sig.s), s_msg)
    # (``rung`` checks that each circuit is satisfied)
    if (s_cs.num_constraints, s_cs.num_inputs) != (19292, 4):
        raise AssertionError(f"schnorr circuit: {s_cs.num_constraints} "
                             f"constraints, {s_cs.num_inputs} inputs")
    wrong = [s_msg[0] + 1, pk_xy[0][0], pk_xy[1][0]]
    line = circuit_rung("mnt4753", "schnorr_verification", s_cs, wrong)
    te_paths["groth16_schnorr_verification"] = line
    print("rung " + json.dumps(line), flush=True)
    del s_cs
    comm, data, rnd, commitment, _ = ped_case
    p_cs = pedersen_commitment_circuit(comm, data, rnd, commitment)
    te_g = TEGroupGadget.for_curve(comm.g)
    moved = te_g._host_add(commitment, comm.g.generator_host)
    line = circuit_rung("bls12_377", "pedersen_commitment", p_cs,
                        list(moved))
    te_paths["groth16_pedersen_commitment"] = line
    print("rung " + json.dumps(line), flush=True)
    del p_cs, comm, ped_case

    def te_kernel_rows(seen, launches):
        """K1, add/sub/neg and K2 at 16 digits against their plain
        versions, tolerance 0: K1 and add/sub/neg at the widest layout of
        each class the 16-digit twisted_edwards and pedersen lines
        launched (``field_kernels_at_setup``), K2 on one element of both
        16-digit fields (as every ``to_affine`` calls it), each timed
        beside its plain version and its bound.  Returns the kernels
        line's ``*_d16`` rows and the field kernels' rows by layout."""
        seen16 = {key: n for key, n in seen.items()
                  if key[1] in ("jubjub_fq", "bls12_377_fr")}
        errs, field_rows, timed = field_kernels_at_setup(seen16)
        rows = {}
        for name, row in timed.items():
            rows[name] = dict(max_abs_err=errs[name], case=row["case"],
                              **{k: row[k] for k in (
                                  "ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by")})
        err = 0
        for F in (PP.JUBJUB_FQ, PP.EDWARDS_BLS12_FQ):
            x1 = torch.from_numpy(limbs.to_digits_batch(
                [random.Random(16).randrange(1, F.modulus)],
                F.n_digits)).to(dev)
            err = max(err, compare(f"inv_bea [1,16] {F.name}",
                                   fp.inv_bea(F, x1),
                                   fp.inv_bea_plain(F, x1)))
        passes = divsteps_model.inverse(
            limbs.from_digits_batch(x1.cpu())[0], F.modulus).passes
        b_ms, b_by = bound(2 * 2 * F.n_digits,
                           passes * (31 * 12 + 24 * ((F.n_digits + 1) // 2)))
        rows["inv_bea"] = dict(
            max_abs_err=err, case=f"[1, 16] {F.name}",
            ms=time_ms(lambda: fp.inv_bea(F, x1), 20),
            device_ms=graph_ms(lambda: fp.inv_bea(F, x1), 20),
            plain_ms=time_ms(lambda: fp.inv_bea_plain(F, x1), 2),
            bound_ms=b_ms, bound_by=b_by)
        meta = {k["name"]: k for k in kernels}
        out = []
        for name, row in rows.items():
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"the 16-digit lines never launched "
                                     f"{name}")
            out.append({
                "name": f"{name}_d16", "route": "cuda",
                "source": meta[name]["source"],
                "replaces": meta[name]["replaces"],
                "launches": launches[name], **row,
                # no PyTorch call computes a modular product or inverse
                "library_ms": None,
                "path": "twisted_edwards_and_pedersen_16_digits",
                "kernel": name})
        return out, field_rows

    te_rows, te_field_rows = te_kernel_rows(te_layouts.seen, te_launches16)
    print("field_kernels_at_te " + json.dumps(te_field_rows), flush=True)
    # every new path launched K1, add/sub and K2; the TE and Pedersen
    # lines neg too (a = -1), the signatures K9, the rungs K4-K6
    for name, line in te_paths.items():
        need = ["mont_mul", "fp_add", "fp_sub", "inv_bea"]
        if name.startswith(("twisted_edwards", "pedersen")):
            need.append("fp_neg")
        if name in ("schnorr", "vrf"):
            need.append("poseidon_permute")
        if name.startswith("groth16"):
            need += ["ec_proj_add", "ec_affine_pre", "ec_affine_post",
                     "inv_tree_up", "inv_tree_tail", "inv_tree_down"]
        for k in need:
            if line["path_launches"].get(k, 0) <= 0:
                raise AssertionError(f"{name} never launched {k}")
    print(f"te_and_signatures_section_s {time.perf_counter() - t_te:.1f}",
          flush=True)

    if args.time_plain_addsub:
        cs6, _ = benchmark_circuit(fr, NUM_INPUTS, 1 << 6)
        compiled6 = compile_r1cs(cs6)
        proof6 = groth16_host.expected_proof("mnt4753", cs6, **TOXIC,
                                             r=R_BLIND, s=S_BLIND)

        def setup_and_prove():
            torch.cuda.synchronize()
            t = time.perf_counter()
            params = groth16.generate_parameters(eng, cs6, **TOXIC)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t
            ints, prove_s, _ = prove(params, compiled6, cs6)
            if ints != proof6:
                raise AssertionError("2^6: proof differs from the oracle")
            return {"setup_s": setup_s, "prove_s": prove_s}

        out = {"log2_constraints": 6, "kernels_before": setup_and_prove()}
        saved = fp.add_mod, fp.sub_mod, fp.neg_mod
        fp.add_mod, fp.sub_mod, fp.neg_mod = (
            fp.add_mod_plain, fp.sub_mod_plain, fp.neg_mod_plain)
        try:
            out["plain"] = setup_and_prove()
        finally:
            fp.add_mod, fp.sub_mod, fp.neg_mod = saved
        out["kernels_after"] = setup_and_prove()
        print("plain_addsub " + json.dumps(out), flush=True)

    # launches, each kernel on the path that reaches it: the field kernels
    # on the 2^10 path, the curve kernels on the 2^16 path, K3 on the field
    # API, K9 on the Merkle rung; the 2^16 counts of the Groth16 kernels
    # beside them
    paths = {"groth16_2p10": big, "groth16_2p16": full,
             "field_api": field_api, "merkle_2p16": merkle,
             "ec_rns_2p16": ec_path}
    # the verifier's own path: K1, K2 and add/sub/neg, counted on one
    # verify of the 2^10 proof
    for name in ("mont_mul", "inv_bea"):
        if verify_line["path_launches"][name] <= 0:
            raise AssertionError(f"verify_proof never launched {name}")
    path_of = dict.fromkeys(curve_meta, "groth16_2p16")
    path_of.update(pow_const="field_api", poseidon_permute="merkle_2p16",
                   rns_mont="ec_rns_2p16", ecr_pre="ec_rns_2p16",
                   ecr_post="ec_rns_2p16")
    for k in kernels:
        name = k["name"]
        k["path"] = path_of.get(name, "groth16_2p10")
        k["launches"] = paths[k["path"]]["path_launches"].get(name, 0)
        if k["path"].startswith("groth16"):
            k["launches_verify_2p10"] = \
                verify_line["path_launches"][name]
            k["launches_mnt6_and_gm17_paths"] = {
                path: line["path_launches"].get(name, 0)
                for path, line in mnt6_paths.items()}
            k["launches_bls12_paths"] = {
                path: line["path_launches"].get(name, 0)
                for path, line in bls_paths.items()}
            k["launches_2p16_path"] = full["path_launches"][name]
            if k["launches_2p16_path"] <= 0:
                raise AssertionError(f"the 2^16 path never launched {name}")
        curve = name in ec_kernels.launch_widths and \
            name not in ec_kernels.RNS_KERNELS
        if curve:
            k["launches_by_lanes"] = full["curve_launches_by_lanes"][name]
        if curve and name != "ec_proj_add":
            k["by_width"] = [
                {key: r[key] for key in ("class", "launches", "timed_width",
                                         "ms", "device_ms", "bound_ms",
                                         "loss_ms")}
                for r in k6_by_width + k5_by_width if r["kernel"] == name]
        if name == "poseidon_permute":
            k["by_width"] = k9_by_width["rows"]
        if k["launches"] <= 0:
            raise AssertionError(f"the main path never launched {name}")

    # the 24-digit rows, made on the BLS12-381 rung (their launches are
    # that rung's, checked where they were made), and the 16-digit rows of
    # the twisted-Edwards and Pedersen lines
    kernels.extend(bls_rows)
    kernels.extend(te_rows)
    kernels.extend(rows19 + rows49)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
