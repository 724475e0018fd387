"""The per-thread inverse of the port's kernels (``gl::inv_divsteps`` in
``gingerlib_tpu_torch/csrc/fp_inv.cuh``, run by the inverse kernel K2 and the
inversion tree's tail K6; K9 runs its group form, which
tests/test_torch_inv_divsteps_grp.py holds), compiled for the host with g++
and held to python's ``pow(a, -1, p)``, at 8, 12 and 24 limbs (BLS12-377 Fr
and Fq, MNT4-753 Fq and Fr) and at the odd digit counts' 10 and 25
(MNT6-298 Fq, 19 digits; SW6 Fq, 49: the top limb half full):

    python -m pytest tests/test_torch_inv_divsteps.py -q

The header holds no PTX and needs no CUDA header, so the same source that
nvcc builds for the card runs here.  Besides the inverse, every input's
pass count must be the one of the python model of the algorithm
(tools/divsteps_model.py), and the inputs that the model's seeded search
found must still do what it recorded: take the field's bound of passes
(``INV_LONGEST``), or negate an x row or a y row (``INV_NEGATIVE_ROWS``).
Integer arithmetic: tolerance 0.  Skips only where g++ is missing.
"""

import os
import shutil
import subprocess
import sys

import pytest

from gingerlib_tpu_torch import params as PP
from gingerlib_tpu_torch.ops import cuda_lib
from test_torch_cases import INV_LONGEST, INV_NEGATIVE_ROWS, inv_inputs

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import divsteps_model  # noqa: E402

FIELDS = {F.name: F for F in (PP.BLS12_377_FR, PP.BLS12_377_FQ,
                              PP.MNT4753_FQ, PP.MNT4753_FR, PP.MNT6298_FQ,
                              PP.SW6_FQ)}

# Reads "L n", L limbs of p and -p^-1 mod 2^32, then n inputs of L limbs
# (hex words, low first), and prints for each input the passes run and the
# L limbs of the inverse.
DRIVER = r"""
#include <stdio.h>
#include "fp_inv.cuh"

template <int L>
static int run(unsigned long long n) {
  uint32_t p[L], a[L], r[L];
  unsigned pinv;
  for (int i = 0; i < L; i++)
    if (scanf("%x", &p[i]) != 1) return 1;
  if (scanf("%x", &pinv) != 1) return 1;
  for (unsigned long long k = 0; k < n; k++) {
    for (int i = 0; i < L; i++)
      if (scanf("%x", &a[i]) != 1) return 1;
    printf("%d", gl::inv_divsteps<L>(a, p, pinv, r));
    for (int i = 0; i < L; i++) printf(" %x", r[i]);
    printf("\n");
  }
  return 0;
}

int main() {
  int L;
  unsigned long long n;
  while (scanf("%d %llu", &L, &n) == 2) {
    int rc = L == 8 ? run<8>(n) : L == 10 ? run<10>(n)
           : L == 12 ? run<12>(n) : L == 24 ? run<24>(n)
           : L == 25 ? run<25>(n) : 2;
    if (rc) return rc;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/fp_inv.cuh for the host")
    d = tmp_path_factory.mktemp("fp_inv")
    (d / "driver.cpp").write_text(DRIVER)
    exe = d / "driver"
    subprocess.run([gxx, "-O2", "-std=c++17", "-I", cuda_lib.CSRC,
                    str(d / "driver.cpp"), "-o", str(exe)], check=True,
                   capture_output=True, text=True)
    return str(exe)


def inverses(exe, F, values) -> list:
    """[(inverse, passes)] of the compiled function on ``values``."""
    limbs = (F.n_digits + 1) // 2
    p = F.modulus

    def words(v):
        return " ".join(f"{(v >> 32 * i) & 0xFFFFFFFF:x}"
                        for i in range(limbs))
    lines = [f"{limbs} {len(values)} {words(p)} {F.inv32:x}"]
    lines += [words(v) for v in values]
    out = subprocess.run([exe], input="\n".join(lines) + "\n",
                         capture_output=True, text=True, check=True).stdout
    res = []
    for line in out.splitlines():
        passes, *ws = line.split()
        res.append((sum(int(w, 16) << 32 * i for i, w in enumerate(ws)),
                    int(passes)))
    assert len(res) == len(values)
    return res


@pytest.mark.parametrize("kind", ["random", "edges", "powers_of_two",
                                  "ones_runs", "longest", "negative_rows"])
@pytest.mark.parametrize("name", list(FIELDS))
def test_inverse_matches_pow_and_the_model(driver, name, kind):
    F = FIELDS[name]
    p = F.modulus
    values = inv_inputs(p, name)[kind]
    for a, (inv, passes) in zip(values, inverses(driver, F, values)):
        assert inv == (pow(a, -1, p) if a else 0), f"{a:#x}"
        want = divsteps_model.inverse(a, p)
        assert inv == want.inverse and passes == want.passes, f"{a:#x}"


@pytest.mark.parametrize("name", list(FIELDS))
def test_longest_inputs_take_the_bound(driver, name):
    """The recorded longest inputs, and the 2^k that take the most passes,
    run the field's bound of passes: the loop's cap is reached, not
    passed."""
    F = FIELDS[name]
    p = F.modulus
    bound = divsteps_model.pass_bound(p.bit_length())
    cases = INV_LONGEST[name]
    got = inverses(driver, F, [a for a, _, _ in cases])
    for (a, passes, steps), (inv, ran) in zip(cases, got):
        assert divsteps_model.inverse(a, p)[1:3] == (passes, steps)
        assert ran == passes == bound and inv == pow(a, -1, p)
    powers = inverses(driver, F, [1 << k for k in range(p.bit_length())])
    assert max(ran for _, ran in powers) == bound


@pytest.mark.parametrize("name", list(FIELDS))
def test_negative_rows_are_negated_back(name):
    """The recorded inputs still make the model negate what it recorded,
    both rows among them (the kernel's outputs on them are held to pow
    above)."""
    p = FIELDS[name].modulus
    negated = set()
    for a, neg_x, neg_y in INV_NEGATIVE_ROWS[name]:
        r = divsteps_model.inverse(a, p)
        assert (r.negative_x, r.negative_y) == (neg_x, neg_y)
        negated |= {row for row, n in (("x", neg_x), ("y", neg_y)) if n}
    assert negated == {"x", "y"}
