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
   the 2^16 rung's (2^17-row FFT passes, the setup loops' 327,697 G1 lanes
   and 65,544 Fq2 lanes), the inverse also on 2^15 elements and, against
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
   MNT4-753 on the chained-multiplication benchmark circuit at 2^6, 2^10 and
   2^16 constraints (4 inputs): ``compile_r1cs`` -> ``generate_parameters``
   -> ``create_proof`` with pinned toxic waste and blinding (below 2^12
   points an MSM is a double-and-add loop; the 2^16 rung goes through the
   Pippenger paths and the curve kernels); ``legendre`` and ``sqrt_mod`` on
   2^12 elements of MNT4-753 Fr and Fq; and a 2^16-leaf MNT4-753 Poseidon
   Merkle tree of height 17 (``merkle`` line: one K9 launch a level, 16,
   and 32 additions, asserted), then K9 at each of the tree's level widths
   (``poseidon_by_width`` line: S, device time, bound and loss a width);
   after the 2^16 rung, the
   inversion tree's three kernels and the affine addition's two at the
   widths that rung launched them (``inv_tree_by_width`` and
   ``ec_affine_by_width`` lines: time and loss by class of widths);
5. checks the results: each device proof equals the closed-form python-int
   oracle coordinate for coordinate, a repeat gives the same proof, a proof
   with another ``s`` differs; the Legendre symbols, roots and masks agree
   with python ints; the tree equals the one the plain permutation builds on
   the device, sixteen sampled paths verify and hash to its root in python
   ints, a wrong leaf is refused, a 2^10-leaf tree equals the python-int tree
   node for node, and the phantom root holds; the field API launches K3
   once a call (4); and the launch counters, set to
   zero before each path, show that every kernel was launched on the path
   that reaches it (K7 and K8 on the RNS path);
6. prints the kernel table as one JSON line, and as the last line
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
import os
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
    from gingerlib_tpu_torch.circuits import benchmark_circuit
    from gingerlib_tpu_torch.curves import instances as CI
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import cuda_lib, ec_kernels, limbs, rns
    from gingerlib_tpu_torch.ops import ec_rns as ER
    from gingerlib_tpu_torch.ops import rns_kernels as RK
    from gingerlib_tpu_torch.ops import msm as msm_mod
    from gingerlib_tpu_torch.ops import poseidon_kernels as PK
    from gingerlib_tpu_torch.params._gen import poseidon_gen
    from gingerlib_tpu_torch.params._gen.merkle_gen import \
        MNT4753_PHANTOM_MERKLE_ROOT
    from gingerlib_tpu_torch.primitives.merkle import FieldBasedMerkleTree
    from gingerlib_tpu_torch.primitives.poseidon import (PoseidonHash,
                                                         PoseidonParams)
    from gingerlib_tpu_torch.primitives.poseidon_host import PoseidonHost
    from gingerlib_tpu_torch.proofs import groth16, groth16_host
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
    from gingerlib_tpu_torch.utils.timing import graph_ms
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.join(root, "tests"), os.path.join(root, "tools")]
    import divsteps_model
    from test_torch_cases import inv_inputs

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
    nd, L = fq.n_digits, fq.n_digits // 2
    p, R = fq.modulus, 1 << (16 * fq.n_digits)
    gen = torch.Generator().manual_seed(2024)
    eng = CI.mnt4753_engine()
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
    # kernels are built for (MNT4-753 Fq, BLS12-377 Fq and Fr): 0, 1, 2,
    # p - 1, (p - 1)/2, 2^k for every k, runs of ones, seeded values, and
    # those that take the most passes or make a pass negate a row
    inv_checked = {}
    for F in (fq, PP.BLS12_377_FQ, PP.BLS12_377_FR):
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

    # The same five at the shapes the 2^16-constraint rung gives them: its
    # setup runs one double-and-add loop over 327,697 G1 lanes and one over
    # 65,544 Fq2 lanes, its witness map FFT passes over 2^17 rows.  (The
    # inverse is only ever called on one element, on either path.)
    G1_LOOP_LANES, G2_LOOP_LANES = 327697, 65544
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

    def field_kernels_at_2p16_shapes():
        """Returns ({kernel: max error over the cases}, the timed cases as
        rows, {kernel: its row at the G1 loop's shape}).  A function so that
        its gigabytes die with it."""
        def elems(rows):
            """Uniform digits with the top one zero: below 2^752 < p."""
            raw = torch.randint(0, 1 << 16, (rows, nd), generator=gen,
                                dtype=torch.int64)
            raw[:, -1] = 0
            out = raw.to(dev)
            out[:3] = digits(edge)
            return out

        def plain_by_chunks(plain, a, b, rows=1 << 15):
            """The plain version over chunks of rows: it is elementwise, and
            its temporaries are a hundred times its operands."""
            if b is None:
                shape, fa = a.shape, a.reshape(-1, nd)
                fb = fa
            else:
                a_e, b_e = torch.broadcast_tensors(a, b)
                shape = a_e.shape
                fa, fb = a_e.reshape(-1, nd), b_e.reshape(-1, nd)
            return torch.cat([plain(fa[i:i + rows], fb[i:i + rows])
                              for i in range(0, fa.shape[0], rows)]
                             ).reshape(shape)

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
        a1 = elems(G1_LOOP_LANES).reshape(-1, 1, nd)
        b1 = elems(G1_LOOP_LANES).reshape(-1, 1, nd)
        cases += [(f"g1 loop [{G1_LOOP_LANES},1,48]", name, a1,
                   None if name == "fp_neg" else b1, True)
                  for name in field_ops]
        cases.append((f"g1 loop [{G1_LOOP_LANES},1,48] x the curve's a",
                      "mont_mul", a1, g1.a, True))
        q = elems(G2_LOOP_LANES * 3).reshape(-1, 3, nd)
        r = elems(G2_LOOP_LANES * 3).reshape(-1, 3, nd)
        fq2 = f"fq2 loop [{G2_LOOP_LANES},"
        cases += [
            (fq2 + "3,48] stacked Karatsuba products", "mont_mul", q, r, True),
            (fq2 + "1,48] component views a0 + a1", "fp_add", q[:, 0:1],
             q[:, 1:2], True),
            (fq2 + "1,48] component views t - v0", "fp_sub", q[:, 2:3],
             r[:, 0:1], True),
            (fq2 + "1,48] component view x the non-residue", "mont_mul",
             q[:, 1:2], g2.F.tensor("nonresidue", dev), False),
            (fq2 + "2,48] two components of three", "fp_add", q[:, :2],
             r[:, 1:], False),
            (fq2 + "2,48] two components of three", "fp_sub", q[:, :2],
             r[:, 1:], False),
            (fq2 + "1,48] component view", "fp_neg", q[:, 1:2], None, True)]

        errs16 = dict.fromkeys(field_ops, 0)
        rows, at_g1 = [], {}
        for label, name, a, b, timed_case in cases:
            kern, plain, ops_each = field_ops[name]
            got = kern(a, b)
            err = compare(f"{name} {label}", got,
                          plain_by_chunks(plain, a, b))
            errs16[name] = max(errs16[name], err)
            if not timed_case:
                continue
            n_in = a.numel() + (0 if b is None else b.numel())
            n_out = got.numel() // nd
            b_ms, b_by = bound((n_in // nd + n_out) * elem_bytes,
                               n_out * ops_each)
            row = {"name": name, "case": label, "rows": n_out,
                   "max_abs_err": err, "ms": time_ms(lambda: kern(a, b), 20),
                   "device_ms": graph_ms(lambda: kern(a, b), 20),
                   "plain_ms": time_ms(
                       lambda: plain_by_chunks(plain, a, b), 1),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            if label == f"g1 loop [{G1_LOOP_LANES},1,48]":
                at_g1[name] = row
        return errs16, rows, at_g1

    errs16, field_rows, at_g1 = field_kernels_at_2p16_shapes()
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
    # element for the inverse); at_2p16_shape: the same three at the 2^16
    # path's G1-loop shape; max_abs_err: over every shape of both paths
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
        at16 = at_g1.get(name) or dict(row, case="[1,48], as on the 2^10 path",
                                       rows=1)
        row["at_2p16_shape"] = {k: at16[k] for k in (
            "case", "rows", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by")}
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
            "[2^17,48] dense", "[2^20,48] dense",
            f"g1 loop [{G1_LOOP_LANES},1,48]")]), flush=True)

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

    def prove(params, compiled, cs, s=S_BLIND):
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = groth16.create_proof(eng, params, compiled, cs.assignment(),
                                     r=R_BLIND, s=s)
        ints = groth16.proof_to_ints(eng, proof)   # fetch: completion barrier
        return ints, time.perf_counter() - t

    class phase_clock:
        """While active, times the calls that make up setup and prove --
        the host's QAP evaluation, each fixed-base loop, each kind of MSM --
        with a device synchronise on either side of each call (a dozen calls
        a rung, so the synchronises cost nothing that shows)."""
        targets = ((groth16_host, "qap_at"), (msm_mod, "fixed_base_msm"),
                   (msm_mod, "_msm_lanes"), (msm_mod, "msm_hybrid"),
                   (msm_mod, "msm_affine"), (groth16, "_witness_map_core"))

        def __init__(self):
            self.calls = []
            self.loop_lanes = {}    # lanes of each fixed-base loop

        def __enter__(self):
            self.saved = [(m, n, getattr(m, n)) for m, n in self.targets]
            for mod, name, real in self.saved:
                setattr(mod, name, self.timed(name, real))
            return self

        def __exit__(self, *exc):
            for mod, name, real in self.saved:
                setattr(mod, name, real)

        def timed(self, name, real):
            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = real(*a, **k)
                torch.cuda.synchronize()
                what = name.lstrip("_")
                if a and hasattr(a[0], "F"):          # a curve comes first
                    what += ".g1" if a[0].F.K == 1 else ".g2"
                self.calls.append((what, time.perf_counter() - t))
                if name == "fixed_base_msm":
                    self.loop_lanes[what] = a[2].shape[0]
                return out
            return call

        def take(self):
            """{phase: [seconds of each call]} since the last take."""
            out = {}
            for what, secs in self.calls:
                out.setdefault(what, []).append(secs)
            self.calls = []
            return out

    def rung(log2, phases=None):
        """Setup and prove at 2^log2 constraints; ``phases``: True to time
        the calls inside with a ``phase_clock``."""
        if phases is True:
            with phase_clock() as clock:
                return rung(log2, clock)
        cs, _ = benchmark_circuit(fr, NUM_INPUTS, 1 << log2)
        if not cs.is_satisfied():
            raise AssertionError("benchmark circuit is not satisfied")
        out = {"log2_constraints": log2}
        fp.reset_launch_counts()
        ec_kernels.reset_launch_widths()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        compiled = compile_r1cs(cs)
        params = groth16.generate_parameters(eng, cs, **TOXIC)
        torch.cuda.synchronize()
        out["setup_s"] = time.perf_counter() - t
        out["setup_launches"] = dict(fp.launch_counts)
        if phases:
            out["setup_phases_s"] = phases.take()
            out["setup_loop_lanes"] = dict(phases.loop_lanes)
        proof, out["prove_first_s"] = prove(params, compiled, cs)
        if phases:
            out["prove_phases_s"] = phases.take()
        out["path_launches"] = dict(fp.launch_counts)
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
        t = time.perf_counter()
        want = groth16_host.expected_proof("mnt4753", cs, **TOXIC,
                                           r=R_BLIND, s=S_BLIND)
        out["oracle_host_s"] = time.perf_counter() - t
        if proof != want:
            raise AssertionError(f"2^{log2}: device proof differs from the "
                                 f"closed-form oracle")
        return out, (cs, compiled, params, proof)

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

    small, (cs6, compiled6, params6, proof6) = rung(6)
    print("rung " + json.dumps(small), flush=True)
    aten = count_aten_ops(lambda: prove(params6, compiled6, cs6))
    no_launch = {"expand", "view", "_unsafe_view", "slice", "select",
                 "unbind", "unsqueeze", "split", "split_with_sizes", "alias",
                 "detach", "t", "transpose", "permute", "as_strided",
                 "reshape", "empty", "empty_like", "empty_strided"}
    device_ops = {k: v for k, v in aten.items() if k not in no_launch}
    print("aten_ops_per_proof " + json.dumps(
        dict(sorted(device_ops.items(), key=lambda kv: -kv[1]))), flush=True)

    big, (cs10, compiled10, params10, proof10) = rung(10)
    again, big["prove_steady_s"] = prove(params10, compiled10, cs10)
    if again != proof10:
        raise AssertionError("the same inputs gave two different proofs")
    other, _ = prove(params10, compiled10, cs10, s=S_BLIND + 1)
    if other == proof10 or other["a"] != proof10["a"]:
        raise AssertionError("a proof with another s must differ in B and C "
                             "and keep A")
    print("rung " + json.dumps(big), flush=True)

    # 2^16 constraints: every MSM of the prover is above the 2^12-point
    # threshold, so G1 goes through msm_hybrid and the curve kernels and G2
    # through msm_affine
    full, _ = rung(16, phases=True)
    print("rung " + json.dumps(full), flush=True)
    if full["setup_loop_lanes"] != {"fixed_base_msm.g1": G1_LOOP_LANES,
                                    "fixed_base_msm.g2": G2_LOOP_LANES}:
        raise AssertionError("the field kernels were not held at the lane "
                             "counts of this rung's setup loops")

    widths16 = full["curve_launches_by_width"]
    k6_by_width = inv_tree_by_width(widths16)
    print("inv_tree_by_width " + json.dumps(loss_line(k6_by_width)),
          flush=True)
    k5_by_width = ec_affine_by_width(widths16)
    print("ec_affine_by_width " + json.dumps(loss_line(k5_by_width)),
          flush=True)

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

    if args.time_plain_addsub:
        def setup_and_prove():
            torch.cuda.synchronize()
            t = time.perf_counter()
            params = groth16.generate_parameters(eng, cs6, **TOXIC)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t
            ints, prove_s = prove(params, compiled6, cs6)
            if ints != proof6:
                raise AssertionError("2^6: proof differs from the first one")
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
    path_of = dict.fromkeys(curve_meta, "groth16_2p16")
    path_of.update(pow_const="field_api", poseidon_permute="merkle_2p16",
                   rns_mont="ec_rns_2p16", ecr_pre="ec_rns_2p16",
                   ecr_post="ec_rns_2p16")
    for k in kernels:
        name = k["name"]
        k["path"] = path_of.get(name, "groth16_2p10")
        k["launches"] = paths[k["path"]]["path_launches"].get(name, 0)
        if k["path"].startswith("groth16"):
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

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
