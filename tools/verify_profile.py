#!/usr/bin/env python3
"""Trace Groth16 verification over MNT4-753 on one NVIDIA GPU with
``torch.profiler``: device time by kernel and the device's busy and idle
share.

    python3 tools/verify_profile.py [--log2 6]

Sets up and proves at 2^log2 constraints of ``benchmark_circuit`` (4
inputs), verifies once to warm up, then times three more calls of
``verify_proof`` by the host's clock without the profiler and traces one
with it.  The busy time is the union of the traced kernels'
intervals on the device (CUPTI's timestamps, which the profiler's host
overhead does not stretch); the idle share is one minus busy time over the
median unprofiled wall time.  Prints one JSON line, with the card's
name and power limit and the device time of the dozen costliest kernels
(a trace of one verify holds ~10^5 kernels and is not written out).  Fails
without a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from gingerlib_tpu_torch.circuits import benchmark_circuit  # noqa: E402
from gingerlib_tpu_torch.curves import instances as CI  # noqa: E402
from gingerlib_tpu_torch.fields import fp  # noqa: E402
from gingerlib_tpu_torch.ops import cuda_lib  # noqa: E402
from gingerlib_tpu_torch.proofs import groth16  # noqa: E402
from gingerlib_tpu_torch.relations.r1cs import compile_r1cs  # noqa: E402

TOXIC = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)


def device_events(prof):
    """(name, start, end), times in us, of every kernel the trace saw on
    the device."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def union_us(intervals):
    total, end = 0.0, None
    for a, b in intervals:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def traced(label, fn, reps=3):
    fn()                                          # warm-up
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    from torch.profiler import ProfilerActivity, profile
    fp.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t
    launches = {k: v for k, v in fp.launch_counts.items() if v}
    kernels = device_events(prof)
    spans = sorted((a, b) for _, a, b in kernels)
    busy_s = union_us(spans) / 1e6
    by_name = {}
    for name, a, b in kernels:
        c, us = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, us + b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    wall = statistics.median(walls)
    return {"phase": label, "wall_s": walls, "traced_wall_s": traced_wall,
            "device_kernels": len(spans), "field_launches": launches,
            "device_busy_s": busy_s,
            "idle_share": None if not spans else 1 - busy_s / wall,
            "device_ms_by_kernel": {k[:120]: {"count": c, "ms": us / 1e3}
                                    for k, (c, us) in top}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("verify_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cuda_lib.build()
    eng = CI.mnt4753_engine()
    cs, _ = benchmark_circuit(eng.g1.scalar_field, 4, 1 << args.log2)
    params = groth16.generate_parameters(eng, cs, **TOXIC)
    proof = groth16.create_proof(eng, params, compile_r1cs(cs),
                                 cs.assignment(), r=31337, s=71717)
    inputs = cs.input_values[1:]

    def verify():
        if not groth16.verify_proof(eng, params.vk, proof, inputs):
            raise AssertionError("verify_proof refused the proof")

    row = traced("verify_proof", verify)
    row.update(card=card, log2_constraints=args.log2)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
