"""Host-side exact extension-field constants (python ints).

Only what the ported towers need: the Frobenius coefficients of a quadratic
extension, derived at build time instead of transcribed.
"""

from __future__ import annotations


def frob_table_fp2(p, nr):
    """c1[i] = nr^((p^i-1)/2) for i in 0..1."""
    return [pow(nr, (pow(p, i) - 1) // 2, p) for i in range(2)]
