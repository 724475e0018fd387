#!/usr/bin/env python3
"""Time the first-use build of the CUDA kernels: every ``.cu`` of a ``csrc``
directory compiled by nvcc into a library of its own, all processes started
together as ``ops/cuda_lib.build`` starts them, into an empty directory.

    python3 tools/build_times.py [--csrc DIR] [--extra FLAGS ...]

``--csrc`` defaults to this tree's ``gingerlib_tpu_torch/csrc`` (another
checkout's may be given, e.g. one unpacked with ``git archive``).  Each
``--extra`` is one build: its flags, split on spaces, are appended to
``cuda_lib.NVCC_FLAGS`` (``--extra ''`` builds with those alone, the
default).  Prints the nvcc version, then one JSON line a build: the wall
seconds of the whole build, the second at which each library was done, and
each failed library's exit code and the end of what nvcc printed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gingerlib_tpu_torch.ops import cuda_lib  # noqa: E402


def build_once(csrc: str, extra: list, out: str) -> dict:
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    names = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    t0 = time.perf_counter()
    logs = {n: open(os.path.join(out, n + ".log"), "w+") for n in names}
    procs = {n: subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *extra, "-Xptxas", "-v",
         "-I", csrc, "-o", os.path.join(out, f"lib{n}.so"),
         os.path.join(csrc, n + ".cu")],
        stdout=logs[n], stderr=subprocess.STDOUT) for n in names}
    done, failed = {}, {}
    while len(done) < len(procs):
        for n, p in procs.items():
            if n not in done and p.poll() is not None:
                done[n] = round(time.perf_counter() - t0, 2)
                logs[n].seek(0)
                text = logs[n].read()
                logs[n].close()
                if p.returncode != 0:
                    failed[n] = {"rc": p.returncode, "tail": text[-600:]}
        time.sleep(0.05)
    return {"csrc": csrc, "extra": " ".join(extra),
            "wall_s": round(time.perf_counter() - t0, 2),
            "done_s": dict(sorted(done.items(), key=lambda kv: kv[1])),
            "failed": failed}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=cuda_lib.CSRC)
    ap.add_argument("--extra", action="append")
    args = ap.parse_args()
    print(subprocess.run([cuda_lib._nvcc(), "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1],
          flush=True)
    out = os.path.join(cuda_lib.BUILD, "times")
    for extra in args.extra or [""]:
        print(json.dumps(build_once(os.path.abspath(args.csrc), extra.split(),
                                    out)), flush=True)
    shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    main()
