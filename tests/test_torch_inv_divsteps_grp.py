"""The inverse over a group of threads (``gl::inv_divsteps_grp`` in
``gingerlib_tpu_torch/csrc/fp_inv.cuh``, run by the Poseidon kernel K9 on
each block's shared root), compiled for the host with g++:

    python -m pytest tests/test_torch_inv_divsteps_grp.py -q

The group's ranks talk only through a communicator; on the card it is the
group's warp shuffles and ballots (``GrpComm`` of ``fp_group.cuh``), here
the host program below runs the G ranks in a loop, each per-rank step for every
rank before the exchange that follows it.  So the source that nvcc builds
for the card runs here, at 16, 24 and 48 digits (8, 12 and 24 limbs), with
the group sizes the kernels use (8 threads at 48 digits, 4 below) and
others that divide the limbs.  Each input's inverse must be python's
``pow(a, -1, p)``, and its pass count the per-thread form's
(``gl::inv_divsteps``, run by the same program) and the python model's
(tools/divsteps_model.py), on the model's hardest inputs (``INV_LONGEST``:
the bound of passes; ``INV_NEGATIVE_ROWS``: a pass negates a row), on 0, 1,
2, p - 1, (p - 1)/2, every 2^k, runs of ones and seeded values.  Integer
arithmetic: tolerance 0.  Skips only where g++ is missing.
"""

import os
import shutil
import subprocess
import sys

import pytest

from gingerlib_tpu_torch import params as PP
from gingerlib_tpu_torch.ops import cuda_lib
from test_torch_cases import INV_LONGEST, inv_inputs

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import divsteps_model  # noqa: E402

FIELDS = {F.name: F for F in (PP.BLS12_377_FR, PP.BLS12_377_FQ,
                              PP.MNT4753_FQ, PP.MNT4753_FR)}
# (limbs, group size) pairs the host program is built for; the kernels' own are
# (24, 8), (12, 4) and (8, 4)
GROUPS = {8: (2, 4, 8), 12: (2, 4), 24: (4, 8)}

# Reads "inv L G n", L limbs of p and -p^-1 mod 2^32, then n inputs of L limbs
# (hex words, low first), and prints for each input the group form's
# passes, the per-thread form's passes and the L limbs of the group form's
# inverse.
HOST_MAIN = r"""
#include <stdio.h>
#include "fp_inv.cuh"

// The ranks of one group, run in a loop: every per-rank step runs for each
// rank before the exchange after it.
template <int G>
struct LoopComm {
  static constexpr int N = G;
  template <class F>
  void each(F f) const {
    for (int r = 0; r < G; r++) f(r);
  }
  gl::Lanes<uint32_t, G> shfl(const gl::Lanes<uint32_t, G>& v,
                              int src) const {
    gl::Lanes<uint32_t, G> o;
    for (int r = 0; r < G; r++) o.v[r] = v.v[src];
    return o;
  }
  gl::Lanes<uint32_t, G> from_above(const gl::Lanes<uint32_t, G>& v) const {
    gl::Lanes<uint32_t, G> o;
    for (int r = 0; r < G; r++) o.v[r] = r == G - 1 ? 0u : v.v[r + 1];
    return o;
  }
  gl::Lanes<uint32_t, G> from_below(const gl::Lanes<uint32_t, G>& v) const {
    gl::Lanes<uint32_t, G> o;
    for (int r = 0; r < G; r++) o.v[r] = r == 0 ? 0u : v.v[r - 1];
    return o;
  }
  uint32_t bits(const gl::Lanes<bool, G>& p) const {
    uint32_t b = 0;
    for (int r = 0; r < G; r++) b |= (uint32_t)p.v[r] << r;
    return b;
  }
};

template <int L, int G>
static int run(unsigned long long n) {
  constexpr int M = L / G;
  uint32_t p[L], a[L], r[L];
  unsigned pinv;
  for (int i = 0; i < L; i++)
    if (scanf("%x", &p[i]) != 1) return 1;
  if (scanf("%x", &pinv) != 1) return 1;
  gl::Lanes<gl::Part<M>, G> la, lp, lr;
  for (int i = 0; i < L; i++) lp.v[i / M].w[i % M] = p[i];
  for (unsigned long long k = 0; k < n; k++) {
    for (int i = 0; i < L; i++)
      if (scanf("%x", &a[i]) != 1) return 1;
    for (int i = 0; i < L; i++) la.v[i / M].w[i % M] = a[i];
    const int passes = gl::inv_divsteps_grp<L, G>(LoopComm<G>(), la, lp,
                                                  pinv, lr);
    printf("%d %d", passes, gl::inv_divsteps<L>(a, p, pinv, r));
    for (int i = 0; i < L; i++) printf(" %x", lr.v[i / M].w[i % M]);
    printf("\n");
  }
  return 0;
}

// "neg": the group negation alone, on n values of L limbs: prints -x mod
// 2^(32 L).
template <int L, int G>
static int negate(unsigned long long n) {
  constexpr int M = L / G;
  gl::Lanes<gl::Part<M>, G> x;
  for (unsigned long long k = 0; k < n; k++) {
    for (int i = 0; i < L; i++)
      if (scanf("%x", &x.v[i / M].w[i % M]) != 1) return 1;
    gl::divsteps_grp::negate<M, G>(LoopComm<G>(), x);
    for (int i = 0; i < L; i++) printf("%x ", x.v[i / M].w[i % M]);
    printf("\n");
  }
  return 0;
}

template <int L, int G>
static int dispatch(bool neg, unsigned long long n) {
  return neg ? negate<L, G>(n) : run<L, G>(n);
}

int main() {
  char what[8];
  int L, G;
  unsigned long long n;
  while (scanf("%7s %d %d %llu", what, &L, &G, &n) == 4) {
    const bool neg = what[0] == 'n';
    int rc = L == 8 && G == 2 ? dispatch<8, 2>(neg, n)
           : L == 8 && G == 4 ? dispatch<8, 4>(neg, n)
           : L == 8 && G == 8 ? dispatch<8, 8>(neg, n)
           : L == 12 && G == 2 ? dispatch<12, 2>(neg, n)
           : L == 12 && G == 4 ? dispatch<12, 4>(neg, n)
           : L == 24 && G == 4 ? dispatch<24, 4>(neg, n)
           : L == 24 && G == 8 ? dispatch<24, 8>(neg, n) : 2;
    if (rc) return rc;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_exe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/fp_inv.cuh for the host")
    d = tmp_path_factory.mktemp("fp_inv_grp")
    (d / "main.cpp").write_text(HOST_MAIN)
    exe = d / "main"
    subprocess.run([gxx, "-O2", "-std=c++17", "-I", cuda_lib.CSRC,
                    str(d / "main.cpp"), "-o", str(exe)], check=True,
                   capture_output=True, text=True)
    return str(exe)


def inverses(exe, F, group, values) -> list:
    """[(inverse, group passes, per-thread passes)] of the compiled
    functions on ``values``."""
    limbs = F.n_digits // 2
    p = F.modulus

    def words(v):
        return " ".join(f"{(v >> 32 * i) & 0xFFFFFFFF:x}"
                        for i in range(limbs))
    lines = [f"inv {limbs} {group} {len(values)} {words(p)} {F.inv32:x}"]
    lines += [words(v) for v in values]
    out = subprocess.run([exe], input="\n".join(lines) + "\n",
                         capture_output=True, text=True, check=True).stdout
    res = []
    for line in out.splitlines():
        passes, thread_passes, *ws = line.split()
        res.append((sum(int(w, 16) << 32 * i for i, w in enumerate(ws)),
                    int(passes), int(thread_passes)))
    assert len(res) == len(values)
    return res


CASES = [(name, g) for name, F in FIELDS.items()
         for g in GROUPS[F.n_digits // 2]]


@pytest.mark.parametrize("kind", ["random", "edges", "powers_of_two",
                                  "ones_runs", "longest", "negative_rows"])
@pytest.mark.parametrize("name,group", CASES)
def test_group_inverse_matches_pow_and_the_per_thread_form(host_exe, name,
                                                           group, kind):
    F = FIELDS[name]
    p = F.modulus
    values = inv_inputs(p, name)[kind]
    for a, (inv, passes, thread_passes) in zip(
            values, inverses(host_exe, F, group, values)):
        assert inv == (pow(a, -1, p) if a else 0), f"{a:#x}"
        assert passes == thread_passes == divsteps_model.inverse(
            a, p).passes, f"{a:#x}"


@pytest.mark.parametrize("name,group", CASES)
def test_group_inverse_takes_the_bound_on_the_longest(host_exe, name, group):
    """0 stops at once; the recorded longest inputs run the field's bound
    of passes in the group form too."""
    F = FIELDS[name]
    p = F.modulus
    bound = divsteps_model.pass_bound(p.bit_length())
    got = inverses(host_exe, F, group, [0, 1, p - 1] +
                   [a for a, _, _ in INV_LONGEST[name]])
    assert got[0] == (0, 0, 0)
    assert got[1][0] == 1 and got[2][0] == p - 1
    assert all(passes == bound for _, passes, _ in got[3:])


@pytest.mark.parametrize("limbs,group", [(L, g) for L in GROUPS
                                         for g in GROUPS[L]])
def test_group_negation_carries_across_ranks(host_exe, limbs, group):
    """The negation of a row that came out negative (rare on real inputs:
    ~1 pass in 10^5) on values whose low parts are zero, so that its +1
    carries through one rank or more, and on 0, 1 and all ones."""
    bits = 32 * limbs
    values = [0, 1, (1 << bits) - 1] + [
        v << 32 * k for k in range(limbs) for v in (1, 0xFFFFFFFF, 3 << 30)]
    values = [v % (1 << bits) for v in values]

    def words(v):
        return " ".join(f"{(v >> 32 * i) & 0xFFFFFFFF:x}"
                        for i in range(limbs))
    lines = [f"neg {limbs} {group} {len(values)}"] + [words(v)
                                                      for v in values]
    out = subprocess.run([host_exe], input="\n".join(lines) + "\n",
                         capture_output=True, text=True,
                         check=True).stdout.splitlines()
    got = [sum(int(w, 16) << 32 * i for i, w in enumerate(line.split()))
           for line in out]
    assert got == [-v % (1 << bits) for v in values]
