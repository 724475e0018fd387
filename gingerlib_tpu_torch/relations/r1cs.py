"""R1CS constraint system: host-side construction and device compilation.

Counterpart of ``gingerlib_tpu/relations/r1cs.py``.

* Trace time (host): circuits are plain Python that allocates variables and
  enforces a*b = c over ``LinearCombination``s with python-int coefficients.
  Variable 0 is the constant ONE input and inputs come before aux variables;
  the QAP depends on that order.
* Compile time: the constraint matrices become COO tensors (rows, cols,
  Montgomery coefficient digits) on the device; witness evaluation is then
  gather -> Montgomery multiply -> ``index_add_`` of raw digit columns ->
  one lazy modular reduction per row.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..device import resolve_device
from ..fields import fp as fpmod
from ..fields.fp import FpParams
from ..ops.limbs import DTYPE


class SynthesisError(Exception):
    pass


ONE = 0  # variable index of the constant one input


class LinearCombination:
    """Sparse sum of coeff_i * var_i with python-int coefficients."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms or {})  # var -> coeff (int)

    @staticmethod
    def of(var: int, coeff: int = 1) -> "LinearCombination":
        return LinearCombination({var: coeff})

    def __add__(self, other):
        t = dict(self.terms)
        for v, c in other.terms.items():
            t[v] = t.get(v, 0) + c
        return LinearCombination(t)

    def __sub__(self, other):
        t = dict(self.terms)
        for v, c in other.terms.items():
            t[v] = t.get(v, 0) - c
        return LinearCombination(t)

    def __mul__(self, k: int):
        return LinearCombination({v: c * k for v, c in self.terms.items()})

    __rmul__ = __mul__

    def __neg__(self):
        return self * -1


def lc(*terms) -> LinearCombination:
    """lc((var, coeff), ...) or lc(var) for coefficient 1."""
    out = LinearCombination()
    for t in terms:
        v, c = t if isinstance(t, tuple) else (t, 1)
        out.terms[v] = out.terms.get(v, 0) + c
    return out


class ConstraintSystem:
    """Records constraints and (optionally) the witness assignment: the
    key-generation assembly when no values are given, the proving assignment
    when they are."""

    def __init__(self, field: FpParams):
        self.field = field
        self.num_inputs = 0
        self.num_aux = 0
        self.at: list[list[tuple[int, int]]] = []  # per-constraint (var, coeff)
        self.bt: list[list[tuple[int, int]]] = []
        self.ct: list[list[tuple[int, int]]] = []
        self.input_values: list[int] = []
        self.aux_values: list[int] = []
        self.names: list[str] = []
        self.alloc_input("ONE", 1)

    # -- allocation (inputs first, then aux; ids are global) --
    def alloc_input(self, name: str = "", value: int | None = None) -> int:
        if self.num_aux:
            raise SynthesisError("allocate all inputs before aux variables")
        idx = self.num_inputs
        self.num_inputs += 1
        self.input_values.append(
            None if value is None else value % self.field.modulus)
        return idx

    def alloc(self, name: str = "", value: int | None = None) -> int:
        idx = self.num_inputs + self.num_aux
        self.num_aux += 1
        self.aux_values.append(
            None if value is None else value % self.field.modulus)
        return idx

    @property
    def num_constraints(self) -> int:
        return len(self.at)

    @property
    def num_variables(self) -> int:
        return self.num_inputs + self.num_aux

    def enforce(self, a: LinearCombination, b: LinearCombination,
                c: LinearCombination, name: str = ""):
        p = self.field.modulus
        self.at.append([(v, k % p) for v, k in a.terms.items() if k % p])
        self.bt.append([(v, k % p) for v, k in b.terms.items() if k % p])
        self.ct.append([(v, k % p) for v, k in c.terms.items() if k % p])
        self.names.append(name)

    # -- host-side evaluation (exact oracle) --
    def assignment(self) -> list[int]:
        vals = list(self.input_values) + list(self.aux_values)
        if any(v is None for v in vals):
            raise SynthesisError("missing assignment values")
        return vals

    def eval_lc(self, terms, vals) -> int:
        p = self.field.modulus
        return sum(vals[v] * c for v, c in terms) % p

    def is_satisfied(self) -> bool:
        return self.which_is_unsatisfied() is None

    def which_is_unsatisfied(self) -> str | None:
        """Name of the first failing constraint, or None."""
        vals = self.assignment()
        p = self.field.modulus
        for i in range(self.num_constraints):
            a = self.eval_lc(self.at[i], vals)
            b = self.eval_lc(self.bt[i], vals)
            c = self.eval_lc(self.ct[i], vals)
            if (a * b - c) % p != 0:
                return self.names[i] or f"constraint {i}"
        return None


# ---------------------------------------------------------------------------
# device compilation
# ---------------------------------------------------------------------------

@dataclass
class CooMatrix:
    rows: torch.Tensor     # [nnz] int64
    cols: torch.Tensor     # [nnz] int64 (variable index)
    coeffs: torch.Tensor   # [nnz, nd] int64 Montgomery digits
    num_rows: int
    max_row_nnz: int


@dataclass
class CompiledR1CS:
    field: FpParams
    num_inputs: int
    num_aux: int
    num_constraints: int
    domain_size: int
    a: CooMatrix
    b: CooMatrix
    c: CooMatrix
    _domain: object = field(default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.a.coeffs.device

    def domain(self):
        """The evaluation domain of this circuit on its device, built once
        (its twiddle tables are set-up cost, not per-proof cost)."""
        if self._domain is None:
            from ..ops.fft import Domain
            self._domain = Domain(self.field, self.domain_size,
                                  device=self.device)
        return self._domain


def _compile_matrix(params: FpParams, mat, num_rows: int, device
                    ) -> CooMatrix:
    rows, cols, coeffs = [], [], []
    max_nnz = 0
    for i, terms in enumerate(mat):
        max_nnz = max(max_nnz, len(terms))
        for v, k in terms:
            rows.append(i)
            cols.append(v)
            coeffs.append(k)
    if max_nnz >= (1 << 15):
        raise SynthesisError("row too dense for lazy segment-sum reduction")
    if not rows:
        rows, cols, coeffs = [0], [0], [0]
    return CooMatrix(
        rows=torch.tensor(rows, dtype=torch.int64, device=device),
        cols=torch.tensor(cols, dtype=torch.int64, device=device),
        coeffs=torch.from_numpy(fpmod.fp_from_ints(params, coeffs)).to(device),
        num_rows=num_rows,
        max_row_nnz=max_nnz,
    )


def domain_size_for(cs: ConstraintSystem) -> int:
    """Next power of two >= constraints + inputs."""
    raw = cs.num_constraints + cs.num_inputs
    m = 1 << max(0, (raw - 1).bit_length())
    if m.bit_length() - 1 > cs.field.two_adicity:
        raise ValueError(f"domain size {m} exceeds the two-adicity "
                         f"{cs.field.two_adicity} of {cs.field.name}")
    return m


def compile_r1cs(cs: ConstraintSystem, domain_size: int | None = None,
                 device=None) -> CompiledR1CS:
    device = resolve_device(device)
    if domain_size is None:
        domain_size = domain_size_for(cs)
    return CompiledR1CS(
        field=cs.field,
        num_inputs=cs.num_inputs,
        num_aux=cs.num_aux,
        num_constraints=cs.num_constraints,
        domain_size=domain_size,
        a=_compile_matrix(cs.field, cs.at, domain_size, device),
        b=_compile_matrix(cs.field, cs.bt, domain_size, device),
        c=_compile_matrix(cs.field, cs.ct, domain_size, device),
    )


def eval_matrix(params: FpParams, coo: CooMatrix, z):
    """Batched A_i(z) for all constraints: [num_rows, nd] (Montgomery).

    z: full assignment [num_vars, nd], Montgomery.  The per-row sums are
    plain digit-column sums (below 2^31 by the max_row_nnz bound), reduced
    once per row by ``lazy_reduce``, which normalises them first.
    """
    prods = fpmod.mont_mul(params, z[coo.cols], coo.coeffs)      # [nnz, nd]
    sums = torch.zeros((coo.num_rows, params.n_digits), dtype=DTYPE,
                       device=z.device)
    sums.index_add_(0, coo.rows, prods)
    return fpmod.lazy_reduce(params, sums)
