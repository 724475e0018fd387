#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--time-plain-addsub]

What it does, in order (any failure raises, so the exit code is non-zero):

1. requires a CUDA device, prints its name and power limit, and builds the
   CUDA kernels of ``gingerlib_tpu_torch/csrc`` from source;
2. holds every kernel against its plain PyTorch version on the device, at the
   shapes the proving path gives it, with exact equality (integer arithmetic:
   tolerance 0), and times both with CUDA events;
3. drives the port's main path through its public entry points: Groth16 over
   MNT4-753 on the chained-multiplication benchmark circuit, first a small
   rung (2^6 constraints), then the headline size (2^10 constraints, 4
   inputs): ``compile_r1cs`` -> ``generate_parameters`` -> ``create_proof``
   with pinned toxic waste and blinding;
4. checks the result: the device proof equals the closed-form python-int
   oracle coordinate for coordinate, a repeat gives the same proof, a proof
   with another ``s`` differs, and the launch counters show that the path
   went through every kernel;
5. prints the kernel table as one JSON line, and as the last line
   ``{"ok": true, "device": {...}}``.

Nothing here runs on the CPU except the python-int oracle.

``--time-plain-addsub`` adds one measurement (minutes long) before the last
lines: setup and prove at 2^6 constraints with the modular add, subtract and
negate kernels swapped for their plain PyTorch versions, beside the same
with the kernels, and a check that both give the same proof.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

TOXIC = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)
R_BLIND, S_BLIND = 31337, 71717
NUM_INPUTS = 4

# Peak rates of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM, and
# 67 TFLOP/s float32 outside the tensor cores, i.e. 33.5e12 fused
# multiply-adds a second.  32-bit integer multiply-adds run at half the
# float32 rate, and one 32x32->64-bit multiply-add is two of them (low and
# high word), so integer work is counted in 32-bit integer operations
# against 16.75e12 a second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 2 / 2


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
    from gingerlib_tpu_torch.ops import cuda_lib, limbs
    from gingerlib_tpu_torch.proofs import groth16, groth16_host
    from gingerlib_tpu_torch.relations.r1cs import compile_r1cs

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

    # ------------------------------------------------------------------
    # 2. kernels against their plain versions, on the device
    # ------------------------------------------------------------------
    fq = PP.MNT4753_FQ
    nd, L = fq.n_digits, fq.n_digits // 2
    p, R = fq.modulus, 1 << (16 * fq.n_digits)
    gen = torch.Generator().manual_seed(2024)

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
    inv_batch = torch.cat([a_big[:4], a_big[100:104]])      # holds 0, 1, p-1
    errs["inv_bea"] = max(
        compare("inv_bea [1,48]", fp.inv_bea(fq, inv_one),
                fp.inv_bea_plain(fq, inv_one)),
        compare("inv_bea [8,48] with 0", fp.inv_bea(fq, inv_batch),
                fp.inv_bea_plain(fq, inv_batch)))
    want = [pow(v, -1, p) if v else 0
            for v in limbs.from_digits_batch(inv_batch)]
    if limbs.from_digits_batch(fp.inv_bea(fq, inv_batch)) != want:
        raise AssertionError("inv_bea disagrees with python's pow(v, -1, p)")
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
        compare(f"inv_bea {small.name}", fp.inv_bea(small, xs),
                fp.inv_bea_plain(small, xs))

    def bea_steps(v):
        """(halvings, subtractions) the binary Euclid loop needs for v."""
        if v == 0:
            return 0, 0
        u, w, halv, subs = v, p, 0, 0
        while u != 1 and w != 1:
            while u % 2 == 0:
                u //= 2
                halv += 1
            while w % 2 == 0:
                w //= 2
                halv += 1
            if u >= w:
                u -= w
            else:
                w -= u
            subs += 1
        return halv, subs

    # Bytes the function must move: a field element is nd 16-bit digits.
    # The int64 boundary layout spends 8 bytes on each digit; that is the
    # port's choice, not the function's need, and is kept as a separate
    # figure where it matters (the large-batch line below).
    elem_bytes = nd * 2
    layout_bytes = nd * 8
    halv, subs = bea_steps(limbs.from_digits(inv_one[0]))
    work = {
        # name: (bytes moved, 32-bit integer operations)
        "mont_mul": (3 * N * elem_bytes, N * (2 * L * L + L) * 2),
        "fp_add": (3 * N * elem_bytes, N * 2 * L),
        "fp_sub": (3 * N * elem_bytes, N * 2 * L),
        "fp_neg": (2 * N * elem_bytes, N * L),
        # a halving shifts u (or v) and halves b (or c) mod p: 3L; a
        # subtraction compares, subtracts, and subtracts mod p: 4L
        "inv_bea": (2 * elem_bytes, halv * 3 * L + subs * 4 * L),
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
    kernels = []
    for name, (kern, plain, reps, plain_reps) in timed.items():
        nbytes, nops = work[name]
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        by_ops = nops / PEAK_INT32_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": 0,
            "max_abs_err": errs[name],
            "ms": time_ms(kern, reps), "plain_ms": time_ms(plain, plain_reps),
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            # no single PyTorch call computes a 753-bit modular operation
            "library_ms": None,
        })
    print("kernels agree with their plain versions on the device "
          "(tolerance 0)", flush=True)

    # Beside the path's shapes, where a launch costs more than the work:
    # the multiply at a batch that fills the card, against the same bound.
    big_n = 1 << 17
    big_a, big_b = rand_elems(big_n), rand_elems(big_n)
    big_ms = time_ms(lambda: fp.mont_mul(fq, big_a, big_b), 20)
    big_bytes_ms = 3 * big_n * elem_bytes / PEAK_BYTES_PER_S * 1e3
    big_ops_ms = big_n * (2 * L * L + L) * 2 / PEAK_INT32_OPS_PER_S * 1e3
    big_bound = max(big_bytes_ms, big_ops_ms)
    print("mont_mul_large_batch " + json.dumps(
        {"rows": big_n, "ms": big_ms, "bound_ms": big_bound,
         "bound_by": "bytes" if big_bytes_ms >= big_ops_ms else "operations",
         "share_of_bound": big_bound / big_ms,
         "int64_layout_bytes_ms":
             3 * big_n * layout_bytes / PEAK_BYTES_PER_S * 1e3}), flush=True)
    del big_a, big_b

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
    # 3./4. the main path
    # ------------------------------------------------------------------
    eng = CI.mnt4753_engine()
    fr = eng.g1.scalar_field

    def prove(params, compiled, cs, s=S_BLIND):
        torch.cuda.synchronize()
        t = time.perf_counter()
        proof = groth16.create_proof(eng, params, compiled, cs.assignment(),
                                     r=R_BLIND, s=s)
        ints = groth16.proof_to_ints(eng, proof)   # fetch: completion barrier
        return ints, time.perf_counter() - t

    def rung(log2):
        cs, _ = benchmark_circuit(fr, NUM_INPUTS, 1 << log2)
        if not cs.is_satisfied():
            raise AssertionError("benchmark circuit is not satisfied")
        out = {"log2_constraints": log2}
        fp.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        compiled = compile_r1cs(cs)
        params = groth16.generate_parameters(eng, cs, **TOXIC)
        torch.cuda.synchronize()
        out["setup_s"] = time.perf_counter() - t
        out["setup_launches"] = dict(fp.launch_counts)
        proof, out["prove_first_s"] = prove(params, compiled, cs)
        out["path_launches"] = dict(fp.launch_counts)
        out["prove_launches"] = {
            k: v - out["setup_launches"][k]
            for k, v in out["path_launches"].items()}
        want = groth16_host.expected_proof("mnt4753", cs, **TOXIC,
                                           r=R_BLIND, s=S_BLIND)
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

    for k in kernels:
        k["launches"] = big["path_launches"][k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"the main path never launched {k['name']}")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
