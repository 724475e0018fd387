#!/usr/bin/env python3
"""Hold this tree's field, curve, inverse, Poseidon and pow kernels against
another checkout's, on one NVIDIA GPU, in turns.

    python3 tools/kernel_ab.py --other DIR \
        [--sections k1,k4,k2,k5k6,k7k8,k9k3,end_to_end]

DIR is a checkout of another commit (e.g. ``git archive <commit> | tar -x -C
DIR``); only its ``gingerlib_tpu_torch/csrc`` is read.  Its ``mont_mul.cu``,
``fp_addsub.cu``, ``ec_add.cu``, ``inv_bea.cu``, ``poseidon.cu`` and
``pow_const.cu`` (and for
``k5k6`` its ``ec_affine.cu`` and ``inv_tree.cu``) are built with nvcc
beside this tree's libraries and swapped into this tree's wrappers
(``fields/fp.py`` looks its C entry points up by name), so both run the
same Python.  The kernels' C interface is the same in both, except that an
inverse kernel from before the divsteps inverse takes no -p^-1 mod 2^32 (it
is dropped for it) and the inversion kernels from before the tiled tree
(driven as described under ``k5k6``).  It prints one JSON line a section:

* ``exact``: the two trees' outputs at every shape below are equal (integer
  arithmetic: tolerance 0), and the same for a one-lane doubling;
* ``k1``: device time (a CUDA graph of the launches, replayed between CUDA
  events) of the multiply, add and sub kernels, called through their C entry
  points, at 1 row (the prover's one-lane loops), 2^11, 327,697 (the 2^16
  setup's G1 loop) and 2^20 rows, dense
  and with both operands one constant row (no operand traffic: the compute
  and the stores alone);
* ``k4``: device time of the projective addition on MNT4-753 G1 at 1 lane
  (a doubling, as the window fold runs it), 2^10, 16,376 and 2^15 lanes, on
  distinct points (``generic``) and on the special lanes of
  tests/test_torch_cases.py first (``special_lanes``, as chip_smoke.py
  times it);
* ``k2``: device time of the inverse kernel at 1 row (as the proving path
  calls it) and at 2^15 rows, of the Poseidon kernel on 2^15 MNT4-753
  sponges, and host-clock seconds of a 2^16-leaf MNT4-753 Poseidon Merkle
  tree (both trees' roots must be equal);
* ``k5k6``: device time of the shared inversion (``batch_inverse``), of
  the batched affine addition (pre, inversion, post) and of its pre and
  post kernels alone, on MNT4-753 G1 at 8, 64, 4096, 2^15, 2^18 and 2^19
  lanes, every 97th element zero and every 61st lane at infinity; the
  other tree's affine kernels and inversion kernels (in a tree from before
  the tiled inversion, its runs of 8 driven as its wrapper drove them);
* ``k7k8``: device time of the RNS multiply (K7) at 1, 64, 2^10, 2^16 and
  2^20 elements and of the RNS addition's pre and post kernels (K8) on
  MNT4-753 G1 at 2^10 .. 2^19 lanes (every 61st lane at infinity), the
  other tree's kernels and constant blocks swapped into this tree's
  wrappers (a tree from before the tensor-core core: its own C interface
  and block layout, through adapters); then, for this tree, the RNS
  addition against the positional one (``ec_kernels.batch_affine_add``) at
  2^10 .. 2^18 lanes, host-paced (back-to-back calls between CUDA events)
  and from a CUDA graph, with equal digits; and host-clock seconds of a
  2^16-point RNS ``msm_affine`` over MNT4-753 G1 in each tree, each tree
  in a process of its own (median of three after a warm-up; both points
  must be equal);
* ``k9k3``: device time of the Poseidon kernel (K9) on MNT4-753 sponges
  at 1, 2^10, 2^13 and 2^15 (with the sponges a block, S, that this tree's
  launcher takes), and of the pow kernel (K3) on MNT4-753 Fq at 1 and 4096
  elements with the Legendre and square-root exponents (with this tree's
  window); host-clock seconds of a 2^16-leaf MNT4-753 Poseidon Merkle tree
  and of the field API (``legendre`` and ``sqrt_mod`` on 2^12 elements of
  MNT4-753 Fr and Fq); both trees' outputs must be equal;
* ``end_to_end``: host-clock seconds of a 2^10-
  constraint MNT4-753 Groth16 setup and prove (checked against the
  python-int oracle), of the 2^16 rung's G1 fixed-base loop (768 steps over
  327,697 lanes; both trees' points must be equal) and of a 2^16-point G1
  ``msm_hybrid``.

Every timing runs in the order other, this, this, other, on the same card;
the last line names the card and its power limit.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

KERNELS = (("gl_mont_mul", "mont_mul"), ("gl_fp_addsub", "fp_addsub"),
           ("gl_ec_proj_add", "ec_add"), ("gl_inv_bea", "inv_bea"),
           ("gl_poseidon_permute", "poseidon"), ("gl_pow_const", "pow_const"))
ORDER = ("other", "this", "this", "other")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="checkout of the commit to compare with")
    ap.add_argument("--sections",
                    default="k1,k4,k2,k5k6,k7k8,k9k3,end_to_end",
                    help="comma-separated subset of k1, k4, k2, k5k6, k7k8, "
                         "k9k3, end_to_end")
    args = ap.parse_args()
    sections = set(args.sections.split(","))
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1

    from gingerlib_tpu_torch import params as PP
    from gingerlib_tpu_torch.curves import instances as CI
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import cuda_lib, ec_kernels
    from gingerlib_tpu_torch.ops import msm as msm_mod
    from gingerlib_tpu_torch.utils.timing import graph_ms

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # ---- build both ----
    cuda_lib.build()
    other_csrc = os.path.join(args.other, "gingerlib_tpu_torch", "csrc")
    other = cuda_lib.build(other_csrc, os.path.join(cuda_lib.BUILD, "other"),
                           [lib for _, lib in KERNELS])
    fns = {"this": {name: cuda_lib.function(name) for name, _ in KERNELS},
           "other": {}}
    for name, lib in KERNELS:
        fns["other"].update(cuda_lib.load(other[lib], (name,)))
    with open(os.path.join(other_csrc, "inv_bea.cu")) as f:
        if not re.search(r"gl_inv_bea\([^)]*uint32_t inv", f.read()):
            old = ctypes.CDLL(other["inv_bea"]).gl_inv_bea
            vp, i = ctypes.c_void_p, ctypes.c_int
            old.argtypes, old.restype = [i, vp, vp, i, vp, vp], i
            fns["other"]["gl_inv_bea"] = (
                lambda nd, a, out, n, p, inv, stream:
                old(nd, a, out, n, p, stream))

    def use(tree):
        fp.use_kernels(fns[tree])

    def in_turns(fn):
        """{tree: [value, value]} of fn(tree) run in ORDER, each with its
        tree's kernels in the wrappers."""
        out = {}
        for tree in ORDER:
            use(tree)
            out.setdefault(tree, []).append(fn(tree))
        use("this")
        return out

    def same(name, tree_outputs):
        a, b = tree_outputs["other"], tree_outputs["this"]
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{name}: the two trees differ")

    def outputs(fn):
        res = {}
        for tree in ("other", "this"):
            use(tree)
            res[tree] = fn()
        use("this")
        return res

    fq = PP.MNT4753_FQ
    nd = fq.n_digits
    gen = torch.Generator().manual_seed(2024)

    def elems(rows):
        raw = torch.randint(0, 1 << 16, (rows, nd), generator=gen,
                            dtype=torch.int64)
        raw[:, -1] = 0                 # below 2^752 < p
        return raw.to(dev)

    def raw(tree, op, a, a_rows, b, b_rows, out, n):
        """One launch of a field kernel of `tree` (op: None for the
        multiply, else 0 add, 1 sub), rows as in fields/fp.py."""
        stream = torch.cuda.current_stream().cuda_stream
        if op is None:
            rc = fns[tree]["gl_mont_mul"](
                nd, a.data_ptr(), a_rows, nd, b.data_ptr(), b_rows, nd,
                out.data_ptr(), n, fq.limbs_ptr, fq.inv32, stream)
        else:
            rc = fns[tree]["gl_fp_addsub"](
                nd, op, a.data_ptr(), a_rows, nd, b.data_ptr(), b_rows, nd,
                out.data_ptr(), n, fq.limbs_ptr, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    checked = []
    k1 = {}
    if "k1" in sections:
        for label, rows, reps in (("[1,48]", 1, 500),
                                  ("[2^11,48]", 1 << 11, 200),
                                  ("[327697,1,48]", 327697, 30),
                                  ("[2^20,48]", 1 << 20, 10)):
            a, b = elems(rows), elems(rows)
            outs = {tree: torch.empty_like(a) for tree in ("this", "other")}
            row = {}
            for name, op in (("mont_mul", None), ("fp_add", 0), ("fp_sub", 1)):
                # dense, or both one constant row (the same at one row)
                for a_rows in dict.fromkeys((rows, 1)):
                    case = name if a_rows == rows else name + "_constant_rows"
                    for tree in outs:
                        raw(tree, op, a, a_rows, b, a_rows, outs[tree], rows)
                    same(f"{case} {label}", outs)
                    checked.append(f"{case} {label}")
                    row[case] = in_turns(lambda tree: graph_ms(
                        lambda: raw(tree, op, a, a_rows, b, a_rows,
                                    outs[tree], rows), reps))
            k1[label] = row
            del a, b, outs
    g1 = CI.mnt4753_g1()

    def multiples(n, seed):
        ks = torch.randint(1, 1 << 32, (n,), dtype=torch.int64,
                           generator=torch.Generator().manual_seed(seed))
        sd = torch.stack([ks & 0xFFFF, ks >> 16], dim=1).to(dev)
        return msm_mod.fixed_base_msm(g1, g1.generator_affine, sd)

    k4 = {}
    if "k4" in sections:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests"))
        from test_torch_cases import proj_pairs
        pts = multiples(1 << 15, 7)
        inputs = {"generic": (pts, tuple(c.roll(1, 0) for c in pts)),
                  "special_lanes": proj_pairs(g1, pts)}
        for kind, (P_all, Q_all) in inputs.items():
            for lanes, reps in ((1, 200), (1 << 10, 50), (8 * 2047, 20),
                                (1 << 15, 20)):
                P = tuple(c[:lanes] for c in P_all)
                Q = P if lanes == 1 else tuple(c[:lanes] for c in Q_all)
                same(f"ec_proj_add {kind} [{lanes}]",
                     outputs(lambda: ec_kernels.proj_add(g1, P, Q)))
                checked.append(f"ec_proj_add {kind} [{lanes}]")
                k4.setdefault(kind, {})[lanes] = in_turns(
                    lambda tree: graph_ms(
                        lambda: ec_kernels.proj_add(g1, P, Q), reps))

    def seconds(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    k2 = {}
    if "k2" in sections:
        from gingerlib_tpu_torch.ops import limbs
        from gingerlib_tpu_torch.ops import poseidon_kernels as PK
        from gingerlib_tpu_torch.primitives.merkle import \
            FieldBasedMerkleTree
        from gingerlib_tpu_torch.primitives.poseidon import (PoseidonHash,
                                                             PoseidonParams)
        for label, rows, reps in (("[1,48]", 1, 200),
                                  ("[2^15,48]", 1 << 15, 10)):
            a = elems(rows)
            res = outputs(lambda: fp.inv_bea(fq, a))
            same(f"inv_bea {label}", res)
            head = limbs.from_digits_batch(a[:64].cpu())
            if limbs.from_digits_batch(res["this"][:64].cpu()) != [
                    pow(v, -1, fq.modulus) if v else 0 for v in head]:
                raise AssertionError("inv_bea disagrees with pow")
            checked.append(f"inv_bea {label}")
            k2[f"inv_bea {label}"] = in_turns(lambda tree: graph_ms(
                lambda: fp.inv_bea(fq, a), reps))
        P = PoseidonParams.mnt4753()
        state = fp.to_mont(P.field, elems(3 << 15)).reshape(1 << 15, 3, nd)
        same("poseidon [2^15,3,48]", outputs(lambda: PK.permute(P, state)))
        checked.append("poseidon [2^15,3,48]")
        k2["poseidon_2p15_sponges"] = in_turns(lambda tree: graph_ms(
            lambda: PK.permute(P, state), 3))
        leaves = fp.to_mont(P.field, elems(1 << 16))
        h = PoseidonHash(P)
        roots = {}

        def merkle(tree):
            secs, built = seconds(
                lambda: FieldBasedMerkleTree(h, 17).build(leaves))
            roots[tree] = built.root()
            return secs

        k2["merkle_2p16_build_s"] = in_turns(merkle)
        if not torch.equal(roots["this"], roots["other"]):
            raise AssertionError("the Merkle roots differ")
        checked.append("merkle 2^16 root")
    k5k6 = {}
    if "k5k6" in sections:
        # K5 keeps its C interface; K6's is this tree's three kernels, or,
        # in a tree from before them, the run-of-8 up and down kernels with
        # the last root through the inverse kernel, driven here as that
        # tree's wrapper drove them
        k56 = {"this": {}, "other": {}}
        other56 = cuda_lib.build(other_csrc, os.path.join(cuda_lib.BUILD,
                                                          "other"),
                                 ["ec_affine", "inv_tree"])
        for name in ("gl_ec_affine_pre", "gl_ec_affine_post"):
            k56["this"][name] = cuda_lib.function(name)
            k56["other"].update(cuda_lib.load(other56["ec_affine"], (name,)))
        with open(os.path.join(other_csrc, "inv_tree.cu")) as f:
            tiled = "gl_inv_tree_tail" in f.read()
        tree_fns = ("gl_inv_tree_up", "gl_inv_tree_tail", "gl_inv_tree_down")
        for name in tree_fns:
            k56["this"][name] = cuda_lib.function(name)
        if tiled:
            k56["other"].update(cuda_lib.load(other56["inv_tree"], tree_fns))
        else:
            lib = ctypes.CDLL(other56["inv_tree"])
            vp, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
            run_up, run_down = lib.gl_inv_tree_up, lib.gl_inv_tree_down
            run_up.argtypes = [i, vp, vp, vp, i, i, vp, u32, vp]
            run_down.argtypes = [i, vp, vp, vp, vp, i, i, vp, u32, vp]
            run_up.restype = run_down.restype = i

        def run_inverse(x):
            """The shared inversion of a tree from before the tiles: runs of
            8 up, recursion, runs of 8 down, one root through fp.inv_mod."""
            n = x.shape[0]
            if n == 1:
                return fp.inv_mod(fq, x)
            stream = torch.cuda.current_stream().cuda_stream
            consts = fq.kernel_consts.ctypes.data
            pre = torch.empty((n, (nd + 1) // 2), dtype=torch.int32,
                              device=dev)
            roots = torch.empty((-(-n // 8), nd), dtype=torch.int64,
                                device=dev)
            out = torch.empty_like(x)
            if run_up(nd, x.data_ptr(), pre.data_ptr(), roots.data_ptr(), n,
                      8, consts, fq.inv32, stream):
                raise RuntimeError("launch failed")
            rinv = run_inverse(roots)
            if run_down(nd, x.data_ptr(), pre.data_ptr(), rinv.data_ptr(),
                        out.data_ptr(), n, 8, consts, fq.inv32, stream):
                raise RuntimeError("launch failed")
            return out

        def inverse(tree, x):
            fp.use_kernels(k56[tree])
            if tree == "other" and not tiled:
                return run_inverse(x)
            return ec_kernels.batch_inverse_cuda(fq, x)

        def affine_add(tree, a_pt, b_pt):
            fp.use_kernels(k56[tree])
            (x1, y1), inf1 = a_pt
            (x2, y2), inf2 = b_pt
            num, den, inf3 = ec_kernels.affine_pre_cuda(g1, x1, y1, x2, y2,
                                                        inf1, inf2)
            dinv = inverse(tree, den.reshape(-1, nd)).reshape(den.shape)
            return (*ec_kernels.affine_post_cuda(
                g1, num, dinv, x1, y1, x2, y2, inf1, inf2, inf3), inf3)

        def both(fn):
            res = {tree: fn(tree) for tree in ("other", "this")}
            fp.use_kernels(k56["this"])
            return res

        pts = g1.to_affine(multiples(1 << 18, 7))
        for lanes in (8, 64, 4096, 1 << 15, 1 << 18, 1 << 19):
            reps = 50 if lanes <= 4096 else 10
            x = elems(lanes)
            x[::97] = 0
            same(f"batch_inverse [{lanes}]",
                 both(lambda tree: inverse(tree, x)))
            copies = -(-lanes // (1 << 18))
            ax, ay = (torch.cat([c] * copies)[:lanes] for c in pts)
            inf = torch.zeros(lanes, dtype=torch.bool, device=dev)
            inf[1::61] = True
            a_pt = ((ax, ay), inf)
            b_pt = ((ax.roll(1, 0), ay.roll(1, 0)), inf.roll(3, 0))
            same(f"batch_affine_add [{lanes}]",
                 both(lambda tree: affine_add(tree, a_pt, b_pt)))
            checked += [f"batch_inverse [{lanes}]",
                        f"batch_affine_add [{lanes}]"]
            (x1, y1), inf1 = a_pt
            (x2, y2), inf2 = b_pt
            num, den, inf3 = ec_kernels.affine_pre_cuda(g1, x1, y1, x2, y2,
                                                        inf1, inf2)
            dinv = ec_kernels.batch_inverse_cuda(
                fq, den.reshape(-1, nd)).reshape(den.shape)
            post_args = (num, dinv, x1, y1, x2, y2, inf1, inf2, inf3)

            def kernel_ms(tree, fn):
                fp.use_kernels(k56[tree])
                return graph_ms(fn, reps)

            k5k6[lanes] = {
                "batch_inverse": in_turns(lambda tree: graph_ms(
                    lambda: inverse(tree, x), reps)),
                "batch_affine_add": in_turns(lambda tree: graph_ms(
                    lambda: affine_add(tree, a_pt, b_pt), reps)),
                "affine_pre": in_turns(lambda tree: kernel_ms(
                    tree, lambda: ec_kernels.affine_pre_cuda(
                        g1, x1, y1, x2, y2, inf1, inf2))),
                "affine_post": in_turns(lambda tree: kernel_ms(
                    tree, lambda: ec_kernels.affine_post_cuda(
                        g1, *post_args)))}
            del x, ax, ay, a_pt, b_pt, x1, y1, x2, y2, num, den, dinv, \
                post_args
        fp.use_kernels(k56["this"])
    k7k8 = {}
    if "k7k8" in sections:
        k7k8 = rns_section(args.other, other_csrc, dev, checked, in_turns)
    k9k3 = {}
    if "k9k3" in sections:
        k9k3 = k9k3_section(dev, checked, in_turns, outputs, same, seconds)
    print("exact " + json.dumps(checked), flush=True)
    print("k1 " + json.dumps(k1), flush=True)
    print("k4 " + json.dumps(k4), flush=True)
    print("k2 " + json.dumps(k2), flush=True)
    print("k5k6 " + json.dumps(k5k6), flush=True)
    print("k7k8 " + json.dumps(k7k8), flush=True)
    print("k9k3 " + json.dumps(k9k3), flush=True)

    if "end_to_end" in sections:
        from gingerlib_tpu_torch.circuits import benchmark_circuit
        from gingerlib_tpu_torch.proofs import groth16, groth16_host
        from gingerlib_tpu_torch.relations.r1cs import compile_r1cs
        toxic = dict(alpha=123, beta=456, gamma=789, delta=1011, t=314159)
        eng = CI.mnt4753_engine()
        fr = eng.g1.scalar_field
        cs, _ = benchmark_circuit(fr, 4, 1 << 10)
        compiled = compile_r1cs(cs)
        want = groth16_host.expected_proof("mnt4753", cs, **toxic, r=31337,
                                           s=71717)

        def rung(tree):
            setup, params = seconds(
                lambda: groth16.generate_parameters(eng, cs, **toxic))
            prove, proof = seconds(lambda: groth16.proof_to_ints(
                eng, groth16.create_proof(eng, params, compiled,
                                          cs.assignment(), r=31337,
                                          s=71717)))
            if proof != want:
                raise AssertionError("2^10 proof differs from the oracle")
            return {"setup_s": setup, "prove_s": prove}

        loop_raw = torch.randint(0, 1 << 16, (327697, fr.n_digits),
                            generator=gen, dtype=torch.int64)
        loop_raw[:, -1] = 0
        loop_scalars = loop_raw.to(dev)
        loops = {}

        def g1_loop(tree):
            secs, loops[tree] = seconds(lambda: msm_mod.fixed_base_msm(
                g1, g1.generator_affine, loop_scalars))
            return secs

        aff = g1.to_affine(multiples(1 << 16, 13))
        sc = torch.randint(0, 1 << 16, (1 << 16, fr.n_digits),
                           generator=gen, dtype=torch.int64)
        sc[:, -1] = 0
        sc = sc.to(dev)

        def hybrid(tree):
            msm_mod.msm_hybrid(g1, aff[0], aff[1], sc)    # warm-up
            return sorted(seconds(lambda: msm_mod.msm_hybrid(
                g1, aff[0], aff[1], sc))[0] for _ in range(3))[1]

        e2e = {"groth16_2p10": in_turns(rung),
               "g1_fixed_base_327697_lanes_s": in_turns(g1_loop),
               "msm_hybrid_g1_2p16_median_of_3_s": in_turns(hybrid)}
        if not all(torch.equal(x, y) for x, y in zip(loops["this"],
                                                     loops["other"])):
            raise AssertionError("the G1 loop's points differ")
        print("end_to_end " + json.dumps(e2e), flush=True)
    print(card)
    return 0


# A 2^16-point RNS msm_affine over MNT4-753 G1, timed in the tree of the
# working directory: the JSON of (median seconds of three, the point's x).
RNS_MSM = r"""
import json, sys, time, torch
sys.path.insert(0, ".")
from gingerlib_tpu_torch.curves import instances as CI
from gingerlib_tpu_torch.ops import limbs, msm
g1, g1r = CI.mnt4753_g1(), CI.mnt4753_g1(ec_rns=True)
n, fr = 1 << 16, g1.scalar_field
ks = torch.randint(1, 1 << 32, (n,), dtype=torch.int64,
                   generator=torch.Generator().manual_seed(13))
sd = torch.stack([ks & 0xFFFF, ks >> 16], 1).cuda()
ax, ay = g1.to_affine(msm.fixed_base_msm(g1, g1.generator_affine, sd))
sc = torch.randint(0, 1 << 16, (n, fr.n_digits), dtype=torch.int64,
                   generator=torch.Generator().manual_seed(11))
sc[:, -1] = 0
sc = sc.cuda()

def run():
    r = msm.msm_affine(g1r, ax, ay, sc)
    torch.cuda.synchronize()
    return r

run()
ts = []
for _ in range(3):
    t = time.perf_counter()
    r = run()
    ts.append(time.perf_counter() - t)
x, _ = g1.to_affine(tuple(c[None] for c in r))
print(json.dumps({"seconds": sorted(ts)[1], "runs": ts,
                  "x": hex(limbs.from_digits_batch(x.reshape(1, -1).cpu())[0])}))
"""


def k9k3_section(dev, checked, in_turns, outputs, same, seconds):
    """The ``k9k3`` section: returns its dict."""
    from gingerlib_tpu_torch import params as PP
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import limbs
    from gingerlib_tpu_torch.ops import poseidon_kernels as PK
    from gingerlib_tpu_torch.primitives.merkle import FieldBasedMerkleTree
    from gingerlib_tpu_torch.primitives.poseidon import (PoseidonHash,
                                                         PoseidonParams)
    from gingerlib_tpu_torch.utils.timing import graph_ms

    gen = torch.Generator().manual_seed(2025)

    def elems(F, n):
        raw = torch.randint(0, 1 << 16, (n, F.n_digits + 4), generator=gen,
                            dtype=torch.int64)
        vals = [v % F.modulus for v in limbs.from_digits_batch(raw)]
        return torch.from_numpy(limbs.to_digits_batch(
            vals, F.n_digits)).to(dev)

    out = {"poseidon": {}, "pow_const": {}}
    P = PoseidonParams.mnt4753()
    F = P.field
    for n, reps in ((1, 3), (1 << 10, 3), (1 << 13, 3), (1 << 15, 3)):
        state = fp.to_mont(F, elems(F, 3 * n)).reshape(n, 3, F.n_digits)
        same(f"poseidon [{n},3,48]", outputs(lambda: PK.permute(P, state)))
        checked.append(f"poseidon [{n},3,48]")
        out["poseidon"][n] = {"S": PK.block_sponges_cuda(n),
                              "device_ms": in_turns(lambda tree: graph_ms(
                                  lambda: PK.permute(P, state), reps))}
        del state
    fq = PP.MNT4753_FQ
    x = elems(fq, 4096)
    for label, bits in (("legendre", fq.legendre_exp_bits),
                        ("sqrt", fq.sqrt_exp_bits)):
        for n in (1, 4096):
            a = x[:n]
            same(f"pow_const {label} [{n},48]",
                 outputs(lambda: fp.pow_const(fq, a, bits)))
            checked.append(f"pow_const {label} [{n},48]")
            out["pow_const"][f"{label} [{n},48]"] = {
                "window": fp.pow_window(bits)[0],
                "device_ms": in_turns(lambda tree: graph_ms(
                    lambda: fp.pow_const(fq, a, bits), 5))}
    leaves = fp.to_mont(F, elems(F, 1 << 16))
    h = PoseidonHash(P)
    roots = {}

    def merkle(tree):
        secs, built = seconds(
            lambda: FieldBasedMerkleTree(h, 17).build(leaves))
        roots[tree] = built.root()
        return secs

    out["merkle_2p16_build_s"] = in_turns(merkle)
    if not torch.equal(roots["this"], roots["other"]):
        raise AssertionError("the Merkle roots differ")
    checked.append("merkle 2^16 root")
    fr = PP.MNT4753_FR
    api_in = {F_.name: fp.to_mont(F_, elems(F_, 1 << 12)) for F_ in (fr, fq)}
    api_out = {}

    def field_api(tree):
        secs, res = seconds(lambda: [
            (fp.legendre(F_, api_in[F_.name]), *fp.sqrt_mod(
                F_, api_in[F_.name])) for F_ in (fr, fq)])
        api_out[tree] = res
        return secs

    out["field_api_2p12_s"] = in_turns(field_api)
    for a, b in zip(api_out["this"], api_out["other"]):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError("the field API's results differ")
    checked.append("field API 2^12")
    return out


def rns_section(other_root, other_csrc, dev, checked, in_turns):
    """The ``k7k8`` section: returns its dict."""
    import numpy as np
    from gingerlib_tpu_torch.curves import instances as CI
    from gingerlib_tpu_torch.fields import fp
    from gingerlib_tpu_torch.ops import cuda_lib, ec_kernels, limbs, rns
    from gingerlib_tpu_torch.ops import ec_rns as ER
    from gingerlib_tpu_torch.ops import msm as msm_mod
    from gingerlib_tpu_torch.ops import rns_kernels as RK
    from gingerlib_tpu_torch.utils.timing import graph_ms

    g1, g1r = CI.mnt4753_g1(), CI.mnt4753_g1(ec_rns=True)
    C = ER.consts(g1r)
    ctx, p, nd, k = C.ctx, C.p, C.nd, C.ctx.k
    names = ("gl_rns_mont", "gl_ecr_pre", "gl_ecr_post")
    libs = cuda_lib.build(other_csrc, os.path.join(cuda_lib.BUILD, "other"),
                          ["rns_mont", "ec_rns"])
    fns = {"this": {n: cuda_lib.function(n) for n in names}}
    with open(os.path.join(other_csrc, "rns_core.cuh")) as f:
        tiled = "mma" in f.read()
    if tiled:
        fns["other"] = {**cuda_lib.load(libs["rns_mont"], names[:1]),
                        **cuda_lib.load(libs["ec_rns"], names[1:])}
    else:
        # the warp-an-element kernels: their constant blocks (ten rows,
        # with -p^-1 and the corrections |M_A|, |M_B| where this tree folds
        # and negates them; the extension matrices [k, 64]; the curve's
        # rows, the digits of p and M_A, |2^16j|_m [nd, 128], the digits of
        # M_A/m_i [k, 64]) and their multiply's C interface, without the
        # row selection
        new = RK.kernel_consts(p)[:RK.N_ROWS * RK.LANES].astype(
            np.int64).reshape(RK.N_ROWS, RK.LANES)
        rows = np.zeros((10, RK.LANES), np.int64)
        rows[[0, 1, 2, 3, 5, 6, 9]] = new[[0, 1, 2, 3, 5, 6, 10]]
        rows[4, :k] = ctx.negpinv_A                 # -p^-1, A words
        rows[7, RK.B_ROW:RK.B_ROW + k] = ctx.MA_modB  # |M_A|, B words
        rows[8, :k] = ctx.MB_modA                   # |M_B|, A words
        ext = np.zeros((2, k, 64), np.int64)
        ext[0, :, :k], ext[1, :, :k] = ctx.extAB, ctx.extBA
        rc = np.concatenate([rows.reshape(-1), ext.reshape(-1)])
        D, MD = rns.crt_digit_matrices(ctx)
        pd, md = np.zeros(64, np.int64), np.zeros(64, np.int64)
        pd[:nd], md[:C.wdt] = limbs.to_digits(p, nd), MD
        P2 = rns.pos_rns_matrix(ctx, nd)
        p2 = np.zeros((nd, RK.LANES), np.int64)
        p2[:, :k], p2[:, RK.B_ROW:RK.B_ROW + k] = P2[:, :k], P2[:, k:]
        d = np.zeros((k, 64), np.int64)
        d[:, :C.wdt] = D
        ec = np.concatenate([C.rows[r].astype(np.int64) for r in ER._EC_ROWS]
                            + [pd, md, p2.reshape(-1), d.reshape(-1)])
        old_rc, old_ec = (torch.from_numpy(b.astype(np.uint32).view(
            np.int32)).to(dev) for b in (rc, ec))
        lib = ctypes.CDLL(libs["rns_mont"])
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        old_mont = lib.gl_rns_mont
        old_mont.argtypes = [i, vp, ll, vp, ll, vp, i, vp, vp]
        old_mont.restype = i
        old = cuda_lib.load(libs["ec_rns"], names[1:])

        def mont(kk, x, xs, x_shift, y, ys, y_xor, out, n, consts, stream):
            if x_shift or y_xor or kk != k:
                raise ValueError("the other tree's K7 has no row selection")
            return old_mont(kk, x, xs, y, ys, out, n, old_rc.data_ptr(),
                            stream)

        def pre(*a):
            return old["gl_ecr_pre"](*a[:-3], old_rc.data_ptr(),
                                     old_ec.data_ptr(), a[-1])

        def post(*a):
            return old["gl_ecr_post"](*a[:-3], old_rc.data_ptr(),
                                      old_ec.data_ptr(), a[-1])

        fns["other"] = {"gl_rns_mont": mont, "gl_ecr_pre": pre,
                        "gl_ecr_post": post}

    def both(fn):
        res = {}
        for tree in ("other", "this"):
            fp.use_kernels(fns[tree])
            res[tree] = fn()
        fp.use_kernels(fns["this"])
        torch.cuda.synchronize()
        return res

    def same(name, res):
        a, b = res["other"], res["this"]
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{name}: the two trees differ")
        checked.append(name)

    def turns(fn, reps):
        def one(tree):
            fp.use_kernels(fns[tree])
            return graph_ms(fn, reps)
        out = in_turns(one)
        fp.use_kernels(fns["this"])
        return out

    out = {"k7": {}, "k8": {}, "rns_against_positional": {}}
    raw = torch.randint(0, 1 << 16, (1 << 16, nd), dtype=torch.int64,
                        generator=torch.Generator().manual_seed(5))
    raw[:, -1] = 0
    x16 = RK.pack_rns(ctx, *rns.to_rns_digits(ctx, raw.to(dev)))
    for n in (1, 64, 1 << 10, 1 << 16, 1 << 20):
        x = x16.repeat(-(-n // x16.shape[0]), 1)[:n]
        y = x.roll(1, 0)
        same(f"rns_mont [{n}]", both(lambda: RK.mont_mul_rns(p, x, y)))
        out["k7"][n] = turns(lambda: RK.mont_mul_rns(p, x, y),
                             200 if n <= 1 << 10 else 20 if n <= 1 << 16
                             else 5)
        del x, y
    ks = torch.randint(1, 1 << 32, (1 << 18,), dtype=torch.int64,
                       generator=torch.Generator().manual_seed(7))
    sd = torch.stack([ks & 0xFFFF, ks >> 16], 1).to(dev)
    pts = g1.to_affine(msm_mod.fixed_base_msm(g1, g1.generator_affine, sd))
    for e in range(10, 20):
        n = 1 << e
        copies = -(-n // (1 << 18))
        ax, ay = (torch.cat([c] * copies)[:n] for c in pts)
        inf = torch.zeros(n, dtype=torch.bool, device=dev)
        inf[1::61] = True
        a_pt = ((ax, ay), inf)
        b_pt = ((ax.roll(1, 0), ay.roll(1, 0)), inf.roll(3, 0))
        (x1, y1), inf1 = a_pt
        (x2, y2), inf2 = b_pt
        pre = both(lambda: ER.ecr_pre(g1r, x1, y1, x2, y2, inf1, inf2))
        same(f"ecr_pre [{n}]", pre)
        num, den, x1r, y1r, x2r, inf3, dead = pre["this"]
        dinv = ER.tree_inverse_rns(g1r, den, dead)
        args = (num, dinv, x1r, y1r, x2r, x1, y1, x2, y2, inf1, inf2, inf3)
        same(f"ecr_post [{n}]", both(lambda: ER.ecr_post(g1r, *args)))
        reps = 20 if n <= 1 << 16 else 5
        out["k8"][n] = {
            "pre": turns(lambda: ER.ecr_pre(g1r, x1, y1, x2, y2, inf1,
                                            inf2), reps),
            "post": turns(lambda: ER.ecr_post(g1r, *args), reps)}
        if n <= 1 << 18:
            got = g1r.batch_affine_add(a_pt, b_pt)
            want = ec_kernels.batch_affine_add(g1, a_pt, b_pt)
            if not (torch.equal(got[0][0], want[0][0])
                    and torch.equal(got[0][1], want[0][1])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"RNS and positional additions differ "
                                     f"at {n} lanes")
            checked.append(f"batch_affine_add rns = positional [{n}]")
            rns_add = lambda: g1r.batch_affine_add(a_pt, b_pt)
            pos_add = lambda: ec_kernels.batch_affine_add(g1, a_pt, b_pt)
            reps = 10 if n <= 1 << 16 else 3
            row = {}
            for label, fn in (("rns", rns_add), ("positional", pos_add),
                              ("rns_again", rns_add),
                              ("positional_again", pos_add)):
                row[label + "_ms"] = event_ms(fn, reps)
                row[label + "_device_ms"] = graph_ms(fn, reps)
            out["rns_against_positional"][n] = row
        del ax, ay, a_pt, b_pt, x1, y1, x2, y2, pre, num, den, dinv, args
    runs = {}
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for tree in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, "-c", RNS_MSM],
                             cwd=other_root if tree == "other" else here,
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"RNS msm_affine in {tree}: {res.stderr}")
        runs.setdefault(tree, []).append(json.loads(
            res.stdout.strip().splitlines()[-1]))
    if len({r["x"] for v in runs.values() for r in v}) != 1:
        raise AssertionError("the trees' RNS msm_affine points differ")
    checked.append("msm_affine rns 2^16 point")
    out["msm_affine_rns_2p16_s"] = {
        tree: [r["seconds"] for r in v] for tree, v in runs.items()}
    return out


def event_ms(fn, reps):
    """Milliseconds a call of back-to-back calls between CUDA events, after
    a warm-up: the host's pace included."""
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


if __name__ == "__main__":
    sys.exit(main())
