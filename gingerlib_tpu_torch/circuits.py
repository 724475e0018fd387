"""Synthetic circuits for driving the prover.

``benchmark_circuit`` is the chained-multiplication circuit of ginger-lib's
snark-scalability example, the circuit of the package's headline
configuration (Groth16 over MNT4-753 at about 2^10 constraints).
"""

from __future__ import annotations

import random

from .relations.r1cs import ConstraintSystem, LinearCombination


def benchmark_circuit(fr, num_inputs: int, num_constraints: int,
                      with_values: bool = True, seed: int = 12345):
    """Inputs x_1..x_k, then constraints c_i = c_{i-1} * x_{(i mod k)+1}.
    Returns (constraint system, the public input values)."""
    p = fr.modulus
    rng = random.Random(seed)
    xs = [rng.randrange(1, p) for _ in range(num_inputs)]
    cs = ConstraintSystem(fr)
    in_vars = [cs.alloc_input(f"x{i}", xs[i] if with_values else None)
               for i in range(num_inputs)]
    prev_val = xs[0]
    prev = in_vars[0]
    for i in range(num_constraints):
        j = i % num_inputs
        new_val = prev_val * xs[j] % p
        new = cs.alloc(f"c{i}", new_val if with_values else None)
        cs.enforce(LinearCombination.of(prev),
                   LinearCombination.of(in_vars[j]),
                   LinearCombination.of(new), f"mul{i}")
        prev, prev_val = new, new_val
    return cs, xs
