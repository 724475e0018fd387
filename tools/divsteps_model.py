#!/usr/bin/env python3
"""A python model of the per-thread inverse of ``csrc/fp_inv.cuh``, pass by
pass, and a seeded search for the inputs that test it hardest.

    python3 tools/divsteps_model.py [--seed 7] [--evals 6000]

``inverse(a, p)`` runs the kernel's algorithm on python ints -- Pornin's
optimized binary GCD: 64-bit approximations (the low 31 bits and the top
33 at the common length), 31 divsteps on them, their 2x2 matrix applied to
x, y and to the Bezout coefficients u, v mod p -- and returns a ``Run``:
the inverse, the passes it ran, the divsteps it needed (31 for each pass
but the last, and those of the last before x reached 0: the last pass works
on x and y exactly, since it ends with x = 0 only where both are below
2^64), and how many passes gave a negative x row and a negative y row (an
inexact comparison of the approximations picked the wrong operand; the
kernel negates such a row).  The host test of the kernel
(tests/test_torch_inv_divsteps.py) holds the compiled header's pass counts
to it.

The search prints, for each field the kernels are built for, two lists that
``tests/test_torch_cases.py`` keeps: ``INV_LONGEST``, the inputs that take
the most passes and then the most divsteps (a hill climb by bit flips from
seeded random inputs, powers of two and all-ones runs), and
``INV_NEGATIVE_ROWS``, inputs that negate an x row and a y row (seeded
values just below p, where the two share their top bits; random inputs
negate an x row once in ~10^5 passes).
"""

import argparse
import os
import random
import sys
from typing import NamedTuple

K = 31                  # divsteps a pass
LOW = (1 << K) - 1      # the approximations' exact low bits


class Run(NamedTuple):
    inverse: int        # a^-1 mod p, 0 for a = 0
    passes: int
    divsteps: int
    negative_x: int     # passes whose x row came out negative
    negative_y: int


def pass_bound(bits: int) -> int:
    """Passes that suffice below a modulus of ``bits`` bits:
    ceil((2 bits - 1) / 31)."""
    return -(-(2 * bits - 1) // K)


def _approximation(x: int, y: int):
    n = max(x.bit_length(), y.bit_length())
    if n <= 64:
        return x, y
    s = n - 33
    return ((x >> s) << K) | (x & LOW), ((y >> s) << K) | (y & LOW)


def inverse(a: int, p: int) -> Run:
    """The kernel's inverse of a < p, pass by pass; raises if its bound of
    passes does not reach x = 0."""
    x, y, u, v = a, p, 1, 0
    half = pow(1 << K, -1, p)
    bound = pass_bound(p.bit_length())
    passes = last = neg_x = neg_y = 0
    while x and passes < bound:
        xa, ya = _approximation(x, y)
        f0, g0, f1, g1 = 1, 0, 0, 1
        last = 0                      # divsteps of this pass before x = 0
        for _ in range(K):
            last += xa != 0
            if xa & 1:
                if xa < ya:
                    xa, ya, f0, g0, f1, g1 = ya, xa, f1, g1, f0, g0
                xa, f0, g0 = xa - ya, f0 - f1, g0 - g1
            xa, f1, g1 = xa >> 1, 2 * f1, 2 * g1
        x, y = x * f0 + y * g0, x * f1 + y * g1
        if x & LOW or y & LOW:
            raise AssertionError("a pass's division by 2^31 is not exact")
        x, y = x >> K, y >> K
        if x < 0:
            x, f0, g0, neg_x = -x, -f0, -g0, neg_x + 1
        if y < 0:
            y, f1, g1, neg_y = -y, -f1, -g1, neg_y + 1
        u, v = (u * f0 + v * g0) * half % p, (u * f1 + v * g1) * half % p
        passes += 1
    if x or (a and y != 1):
        raise AssertionError(f"{passes} passes did not reach x = 0 for {a:#x}")
    return Run(v, passes, K * (passes - 1) + last if passes else 0, neg_x,
               neg_y)


def longest(p: int, seed: int, evals: int, keep: int = 4) -> list:
    """The ``keep`` inputs below p with the most (passes, divsteps) that a
    seeded hill climb of ``evals`` evaluations met, most first, as (a,
    passes, divsteps); powers of two are left out (every test runs them)."""
    rng = random.Random(seed)
    bits = p.bit_length()
    score = {}

    def run(a):
        a %= p
        if a and a not in score:
            score[a] = inverse(a, p)[1:3]
        return a

    starts = [rng.randrange(1, p) for _ in range(8)]
    starts += [1 << rng.randrange(bits - 24, bits) for _ in range(4)]
    starts += [((1 << rng.randrange(bits // 2, bits)) - 1) for _ in range(4)]
    per = max(1, evals // len(starts))
    for a in starts:
        cur = run(a) or 1
        for _ in range(per):
            b = cur
            for _ in range(rng.randrange(1, 4)):
                b ^= 1 << rng.randrange(bits)
            b = run(b)
            if b and score[b] >= score[cur]:
                cur = b
    ranked = sorted((s, a) for a, s in score.items() if a & (a - 1))
    return [(a, *s) for s, a in reversed(ranked[-keep:])]


def negative_rows(p: int, seed: int, keep: int = 2) -> list:
    """``keep`` inputs that negate an x row and ``keep`` that negate a y
    row, from seeded values p - d (d of a random bit length), as (a,
    passes with a negative x row, with a negative y row)."""
    rng = random.Random(seed)
    found = {"x": [], "y": []}
    while min(len(v) for v in found.values()) < keep:
        a = p - rng.randrange(1, 1 << rng.randrange(1, p.bit_length()))
        r = inverse(a, p)
        for row, n in (("x", r.negative_x), ("y", r.negative_y)):
            if n and len(found[row]) < keep:
                found[row].append((a, r.negative_x, r.negative_y))
    return found["x"] + found["y"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--evals", type=int, default=6000,
                    help="model runs a field in the search for the longest")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from gingerlib_tpu_torch import params as PP
    fields = (PP.BLS12_377_FR, PP.BLS12_377_FQ, PP.MNT4753_FQ,
              PP.MNT4753_FR, PP.MNT6298_FQ, PP.SW6_FQ)
    for title, search, what in (
            ("INV_LONGEST", lambda p: longest(p, args.seed, args.evals),
             "passes, divsteps"),
            ("INV_NEGATIVE_ROWS", lambda p: negative_rows(p, args.seed),
             "passes with a negative x row, with a negative y row")):
        print(f"{title} = {{")
        for F in fields:
            p = F.modulus
            print(f"    # {p.bit_length()} bits, bound "
                  f"{pass_bound(p.bit_length())} passes; (a, {what})")
            print(f'    "{F.name}": [')
            for a, m, n in search(p):
                print(f"        ({a:#x},\n         {m}, {n}),")
            print("    ],")
        print("}")


if __name__ == "__main__":
    main()
