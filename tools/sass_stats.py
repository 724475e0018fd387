#!/usr/bin/env python3
"""Instruction counts of the port's CUDA kernels, from their SASS.

    python3 tools/sass_stats.py [LIB,LIB...] [--top N] [--out DIR]

Builds the named libraries of ``gingerlib_tpu_torch/csrc`` (default: the
RNS kernels, ``rns_mont,ec_rns``) with ``cuda_lib.build``, disassembles
each with ``cuobjdump -sass`` and prints one JSON line a kernel: its
instruction count and the counts of its most frequent opcodes (the part
before the first dot: ``IMMA`` for the tensor cores' integer products,
``LDS``/``LDL``/``LD`` for shared, local and generic loads), plus every
full opcode that names a tensor-core product (``IMMA.16832.U8.U8``...).
With ``--out`` the whole disassembly is kept as ``DIR/<lib>.sass``.
Needs the CUDA toolkit (nvcc, cuobjdump), not a card.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("libs", nargs="?", default="rns_mont,ec_rns")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None,
                    help="directory to keep the disassembly in")
    args = ap.parse_args()
    from gingerlib_tpu_torch.ops import cuda_lib
    names = args.libs.split(",")
    libs = cuda_lib.build(names=names)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    op = re.compile(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)")
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass", libs[name]],
                              capture_output=True, text=True,
                              check=True).stdout
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, name + ".sass"), "w") as f:
                f.write(sass)
        kernel, counts, full = None, {}, {}
        for line in sass.splitlines():
            m = re.match(r"\s+Function : (\S+)", line)
            if m:
                kernel = m.group(1)
                counts[kernel] = collections.Counter()
                full[kernel] = collections.Counter()
                continue
            m = op.match(line)
            if m and kernel:
                counts[kernel][m.group(1).split(".")[0]] += 1
                if m.group(1).startswith(("IMMA", "HMMA", "HGMMA", "IGMMA")):
                    full[kernel][m.group(1)] += 1
        for kernel, c in counts.items():
            print(json.dumps({"library": name, "kernel": kernel,
                              "instructions": sum(c.values()),
                              "tensor_core": dict(full[kernel]),
                              "top": c.most_common(args.top)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
