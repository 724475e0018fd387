#!/usr/bin/env python3
"""Time the Poseidon kernel (``csrc/poseidon.cu``) against variants of its
own design choices, on one NVIDIA GPU, side by side.

    python3 tools/poseidon_variants.py [--other DIR]

Each variant is a copy of this tree's ``csrc`` with ``poseidon.cu`` patched
by a few text replacements (``VARIANTS``), built with nvcc into
``gingerlib_tpu_torch/build/variants/<name>`` and swapped into the wrapper
(``fp.use_kernels``), so all run the same Python:

* ``min4``: S leaves every SM 4 blocks, not 1 (``kMinBlocksPerSM``);
* ``smax16``, ``smax32``: S at most 16 or 32, not 64 (``kMaxSponges``);
* ``solo1``: one group a sponge at S = 1, not three (the mix's rows in one
  group);
* ``regs64``: 64 registers a thread at every S, not only at S = 64;
* ``regsfree``: as many registers as the kernel wants at every S;
* ``gconst``: the round constants and the MDS matrix read from global
  memory (through L1), not staged in shared memory;
* ``mul3``: the mix as three multiplies and two additions a row, not
  ``grp_mont_sum3``;
* ``noinv`` (a diagnostic; its digits are wrong): the root's inversion
  left out, to see its share of the time.

With ``--other DIR`` (a checkout of another commit) that tree's
``poseidon.cu`` runs beside them.  Every variant but ``noinv`` (and the
other tree) must give this tree's digits.  It prints one JSON line a width
(1 to 2^15 MNT4-753 sponges): device ms from a CUDA graph
(``utils/timing.graph_ms``) for this tree (twice, first and last), each
variant and the other tree; then the card's name and power limit.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MIX = ("        gl::grp_mont_sum3<L, G>(g, m0, s[0], m1, s[1], m2, s[2], P, "
       "inv,\n                                acc);\n")
MIX3 = ("        uint32_t u[M];\n"
        "        gl::grp_mont_mul<L, G>(g, m0, s[0], P, inv, acc);\n"
        "        gl::grp_mont_mul<L, G>(g, m1, s[1], P, inv, u);\n"
        "        gl::grp_add_mod<L, G>(g, acc, u, P, acc);\n"
        "        gl::grp_mont_mul<L, G>(g, m2, s[2], P, inv, u);\n"
        "        gl::grp_add_mod<L, G>(g, acc, u, P, acc);\n")
SOLO = "    return launch_h<ND, T, 1>("
VARIANTS = {
    "min4": [("kMinBlocksPerSM = 1;", "kMinBlocksPerSM = 4;")],
    "smax16": [("kMaxSponges = 64;", "kMaxSponges = 16;")],
    "smax32": [("kMaxSponges = 64;", "kMaxSponges = 32;")],
    "solo1": [(SOLO, "    return launch_h<ND, 1, 1>(")],
    "regs64": [(SOLO, "    return launch_h<ND, T, kWideBlocks>("),
               ("kWideSponges = 64;", "kWideSponges = 2;")],
    "regsfree": [("kWideSponges = 64;", "kWideSponges = 128;")],
    "gconst": [
        ("  for (int k = threadIdx.x; k < words; k += blockDim.x) "
         "C[k] = consts[k];\n", ""),
        ("  uint32_t* X = C + words;", "  uint32_t* X = C;"),
        ("gl::grp_ld_sh<L, G>(g, C, ", "gl::grp_ld_sh<L, G>(g, consts, "),
        ("  const int bytes = (words + 2 * tree_nodes(T * S) * L +",
         "  const int bytes = (2 * tree_nodes(T * S) * L +")],
    "mul3": [(MIX, MIX3)],
    "noinv": [("    gl::grp_inv<L, G>(g, a, P, inv, a);\n", "")],
}
DIAGNOSTIC = ("noinv",)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=None,
                    help="checkout of another commit to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("poseidon_variants: no CUDA device", file=sys.stderr)
        return 1
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import cuda_lib, limbs
    from gingerlib_tpu_torch.ops import poseidon_kernels as PK
    from gingerlib_tpu_torch.primitives.poseidon import PoseidonParams
    from gingerlib_tpu_torch.utils.timing import graph_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    root = os.path.join(cuda_lib.BUILD, "variants")
    shutil.rmtree(root, ignore_errors=True)
    with open(os.path.join(cuda_lib.CSRC, "poseidon.cu")) as f:
        source = f.read()
    trees = {}
    for name, patches in VARIANTS.items():
        csrc = os.path.join(root, name, "csrc")
        shutil.copytree(cuda_lib.CSRC, csrc)
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in "
                                   f"poseidon.cu")
            text = text.replace(old, new)
        with open(os.path.join(csrc, "poseidon.cu"), "w") as f:
            f.write(text)
        trees[name] = csrc
    if args.other:
        trees["other"] = os.path.join(args.other, "gingerlib_tpu_torch",
                                      "csrc")
    libs, errors = {}, {}

    def build(name, csrc):
        try:
            libs[name] = cuda_lib.build(csrc, os.path.join(root, name,
                                                           "build"),
                                        ["poseidon"])["poseidon"]
        except RuntimeError as e:
            errors[name] = str(e)

    threads = [threading.Thread(target=build, args=kv)
               for kv in trees.items()]
    cuda_lib.build()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"builds failed: {errors}")
    fns = {"this": {"gl_poseidon_permute":
                    cuda_lib.function("gl_poseidon_permute")}}
    for name, lib in libs.items():
        fns[name] = cuda_lib.load(lib, ("gl_poseidon_permute",))

    P = PoseidonParams.mnt4753()
    F, nd = P.field, P.field.n_digits
    gen = torch.Generator().manual_seed(5)
    order = ["this"] + sorted(libs) + ["this"]
    for n in (1, 64, 1 << 10, 1 << 11, 1 << 12, 1 << 13, 1 << 14, 1 << 15):
        raw = torch.randint(0, 1 << 16, (3 * n, nd + 4), generator=gen,
                            dtype=torch.int64)
        vals = [v % F.modulus for v in limbs.from_digits_batch(raw)]
        state = fp.to_mont(F, torch.from_numpy(limbs.to_digits_batch(
            vals, nd)).cuda()).reshape(n, 3, nd)
        fp.use_kernels(fns["this"])
        want = PK.permute(P, state)
        row = {"sponges": n, "S": PK.block_sponges_cuda(n)}
        for name in order:
            fp.use_kernels(fns[name])
            got = PK.permute(P, state)
            torch.cuda.synchronize()
            if name not in DIAGNOSTIC and not torch.equal(got, want):
                raise AssertionError(f"{name} at {n} sponges: other digits")
            row.setdefault(name, []).append(graph_ms(
                lambda: PK.permute(P, state), 2 if n > 1 << 12 else 3))
        fp.use_kernels(fns["this"])
        print(json.dumps(row), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
