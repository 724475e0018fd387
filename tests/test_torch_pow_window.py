"""The window schedule of the pow kernel K3 (``csrc/pow_const.cu``), on the
host:

    python -m pytest tests/test_torch_pow_window.py -q

``fields/fp.pow_window`` says which window w the kernel's launcher takes
for an exponent and the w-bit digits it runs; ``pow_window_muls`` counts
the chain's multiplies.  The launcher's own choice (``csrc/pow_window.h``,
host code with no CUDA header) is compiled here with g++ and must agree
with both.  The schedule, run on python ints as the kernel runs it (the
table a^1 .. a^(2^w - 1), then w squarings a digit and a table multiply a
non-zero digit), must give ``pow(a, e, p)`` on MNT4-753's Legendre and
square-root exponents (Fq and Fr), a short exponent and the edge ones
(0, 1, 2^w - 1, 2^w, all ones, a single set bit, the longest exponent the
kernel takes), and its multiplies at w = 5 must be 927, 911, 923 and 892
on the four field exponents, where the binary ladder takes bits +
popcount.  Integer arithmetic: tolerance 0.
"""

import shutil
import subprocess

import numpy as np
import pytest

from gingerlib_tpu_torch import params as PP
from gingerlib_tpu_torch.fields import fp
from gingerlib_tpu_torch.ops import cuda_lib, limbs
from test_torch_cases import pow_edge_exponents, rand_below

F4, F6 = PP.MNT4753_FQ, PP.MNT4753_FR      # MNT4-753's Fq and Fr
FIELD_EXPONENTS = {
    # (field, exponent): (window multiplies, binary-ladder multiplies)
    ("mnt4753_fq", "legendre"): (927, 1127),
    ("mnt4753_fq", "sqrt"): (911, 1111),
    ("mnt4753_fr", "legendre"): (923, 1124),
    ("mnt4753_fr", "sqrt"): (892, 1093),
}


def field_bits(field, kind):
    F = {"mnt4753_fq": F4, "mnt4753_fr": F6}[field]
    return F, getattr(F, f"{kind}_exp_bits")


def value(bits) -> int:
    return int("".join(str(int(b)) for b in bits) or "0", 2)


def run_schedule(a: int, bits, p: int):
    """a^e mod p by the kernel's schedule on python ints, with the
    multiplies it counts."""
    w, digits = fp.pow_window(bits)
    nz = [k for k, d in enumerate(digits) if d]
    if not nz:
        return 1, 0
    table = [a % p]
    for _ in range((1 << w) - 2):
        table.append(table[-1] * a % p)
    muls = (1 << w) - 2
    r = table[digits[nz[0]] - 1]
    for d in digits[nz[0] + 1:]:
        for _ in range(w):
            r = r * r % p
            muls += 1
        if d:
            r = r * table[d - 1] % p
            muls += 1
    return r, muls


# Reads lines "nbits b0 b1 ...", prints "w muls d0 d1 ..." for each.
HOST_MAIN = r"""
#include <stdio.h>
#include "pow_window.h"

int main() {
  int nbits;
  while (scanf("%d", &nbits) == 1) {
    unsigned char bits[1024], d[1024];
    for (int k = 0; k < nbits; k++) {
      int b;
      if (scanf("%d", &b) != 1) return 1;
      bits[k] = (unsigned char)b;
    }
    const int w = gl::pick_window(bits, nbits);
    const int n = gl::window_digits(bits, nbits, w, d);
    printf("%d %d", w, gl::window_muls(bits, nbits, w));
    for (int k = 0; k < n; k++) printf(" %d", d[k]);
    printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def launcher(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/pow_window.h for the host")
    d = tmp_path_factory.mktemp("pow_window")
    (d / "main.cpp").write_text(HOST_MAIN)
    exe = d / "main"
    subprocess.run([gxx, "-O2", "-std=c++17", "-I", cuda_lib.CSRC,
                    str(d / "main.cpp"), "-o", str(exe)], check=True,
                   capture_output=True, text=True)

    def choose(exponents):
        lines = [" ".join([str(len(b))] + [str(int(x)) for x in b])
                 for b in exponents]
        out = subprocess.run([str(exe)], input="\n".join(lines) + "\n",
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
        return [tuple(int(x) for x in line.split()) for line in out]
    return choose


ALL = [("field", k) for k in FIELD_EXPONENTS] + [
    ("edge", k) for k in pow_edge_exponents()]


def exponent(case):
    kind, key = case
    if kind == "field":
        return field_bits(*key)
    return F4, pow_edge_exponents()[key]


@pytest.mark.parametrize("case", ALL, ids=lambda c: "-".join(
    c[1]) if c[0] == "field" else c[1])
def test_schedule_gives_pow(case, launcher):
    """The schedule gives pow(a, e, p) and counts its multiplies as
    pow_window_muls does; the launcher compiled from its source picks the
    same w, digits and count."""
    F, bits = exponent(case)
    p, e = F.modulus, value(bits)
    w, digits = fp.pow_window(bits)
    muls = fp.pow_window_muls(bits, w)
    assert launcher([bits]) == [(w, muls, *digits)]
    assert int("".join(format(d, f"0{w}b") for d in digits) or "0",
               2) == e
    assert all(muls <= fp.pow_window_muls(bits, k)
               for k in range(1, fp.POW_MAX_WINDOW + 1))
    for a in [0, 1, 2, p - 1] + rand_below(p, 3, seed=81):
        r, counted = run_schedule(a, bits, p)
        assert r == pow(a, e, p), f"a = {a:#x}"
        assert counted == muls


@pytest.mark.parametrize("key", list(FIELD_EXPONENTS),
                         ids=lambda k: "-".join(k))
def test_field_exponents_take_a_window_of_five(key):
    """w = 5 on MNT4-753's Legendre and square-root exponents, with the
    counts the kernel's source note gives; the binary ladder's count is
    bits + popcount."""
    _, bits = field_bits(*key)
    window, ladder = FIELD_EXPONENTS[key]
    w, _ = fp.pow_window(bits)
    assert (w, fp.pow_window_muls(bits, w)) == (5, window)
    assert len(bits) + int(np.sum(bits)) == ladder
