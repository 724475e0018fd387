"""R1CS constraint system: host-side construction and device compilation.

Counterpart of ``gingerlib_tpu/relations/r1cs.py``.

* Trace time (host): circuits are plain Python that allocates variables and
  enforces a*b = c over ``LinearCombination``s with python-int coefficients.
  Variable 0 is the constant ONE input and inputs come before aux variables;
  the QAP depends on that order.
* Compile time: the constraint matrices become COO tensors (rows, cols,
  Montgomery coefficient digits) on the device; witness evaluation is then
  gather -> Montgomery multiply -> ``column_sums`` by row (``index_add_``
  of raw digit columns in groups small enough for one lazy modular
  reduction each, so a row may hold any number of terms).  Setup's QAP at
  the toxic point is the transpose (``eval_matrix_transposed``): sums by
  column.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..fields import fp as fpmod
from ..fields.fp import FpParams
from ..ops.limbs import DTYPE


class SynthesisError(Exception):
    pass


# ``fp.lazy_reduce`` takes digit columns below 2^31: sums of fewer than
# this many residues (and, by the value, see ``lazy_terms``)
LAZY_TERMS = 1 << 15


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
    """The rows of ``mat`` as COO tensors.  Each distinct coefficient is
    put in Montgomery form once and gathered on the device: a verifier
    circuit's B matrix holds 13 million terms over fewer than 5,000
    coefficients."""
    lens = np.fromiter(map(len, mat), dtype=np.int64, count=len(mat))
    max_nnz = int(lens.max()) if len(mat) else 0
    nnz = int(lens.sum())
    if nnz == 0:
        lens, nnz, mat = np.ones(1, np.int64), 1, [[(0, 0)]]
    first = {}                   # coefficient -> its index among distinct
    cols = np.fromiter((v for row in mat for v, _ in row), np.int64, nnz)
    keys = np.fromiter((first.setdefault(k, len(first))
                        for row in mat for _, k in row), np.int64, nnz)
    table = torch.from_numpy(fpmod.fp_from_ints(params, list(first)))
    return CooMatrix(
        rows=torch.from_numpy(np.repeat(np.arange(len(mat)), lens)).to(
            device),
        cols=torch.from_numpy(cols).to(device),
        coeffs=table.to(device)[torch.from_numpy(keys).to(device)],
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

    z: full assignment [num_vars, nd], Montgomery.  Gather z by column,
    multiply, add the digit columns by row (``column_sums``: a row of any
    density)."""
    prods = fpmod.mont_mul(params, z[coo.cols], coo.coeffs)      # [nnz, nd]
    return column_sums(params, prods, coo.rows, coo.num_rows)


def eval_matrix_transposed(params: FpParams, coo: CooMatrix, u, num_cols: int):
    """sum_j M[j][i] u_j for every column i < num_cols: [num_cols, nd]
    (Montgomery).  u: [>= num_rows, nd], Montgomery.

    The transpose of ``eval_matrix``: gather u by row, multiply, add the
    digit columns by column (``column_sums``)."""
    prods = fpmod.mont_mul(params, u[coo.rows], coo.coeffs)      # [nnz, nd]
    return column_sums(params, prods, coo.cols, num_cols)


def lazy_terms(params: FpParams) -> int:
    """The most residues one ``lazy_reduce`` may take: digit columns stay
    below 2^31 (fewer than 2^15 terms) and the value below R (terms *
    (p - 1) < R; 13 for BLS12-377's Fr, whose p is near R / 2^3.7)."""
    r = 1 << (16 * params.n_digits)
    return min(LAZY_TERMS - 1, (r - 1) // (params.modulus - 1))


def column_sums(params: FpParams, vals, cols, num_cols: int):
    """sum of the residues vals[k] (< p) with cols[k] == i, for i <
    num_cols, reduced: [num_cols, nd].

    A column may hold far more terms than one ``lazy_reduce`` takes (the
    ONE variable can sit in every constraint).  Each column's terms are cut
    into groups of ``lazy_terms``: the first group sums in the column's
    own slot, the others in slots of their own, every slot is reduced once,
    and the slots' residues are summed again the same way until no column
    has more than one slot."""
    nd = params.n_digits
    dev = vals.device
    limit = lazy_terms(params)
    nnz = cols.shape[0]
    order = torch.argsort(cols, stable=True)
    sc = cols[order]
    counts = torch.bincount(cols, minlength=num_cols)
    start = torch.cumsum(counts, 0) - counts
    group = (torch.arange(nnz, device=dev) - start[sc]) // limit
    extra = group > 0
    groups = -(-nnz // limit) + 1       # more than any column's groups
    keys, slot = torch.unique(sc[extra] * groups + group[extra],
                              return_inverse=True)
    slots = sc.clone()
    slots[extra] = num_cols + slot
    sums = torch.zeros((num_cols + keys.shape[0], nd), dtype=DTYPE,
                       device=dev)
    sums.index_add_(0, slots, vals[order])
    sums = fpmod.lazy_reduce(params, sums)
    if keys.shape[0] == 0:
        return sums
    return column_sums(params, sums, torch.cat([
        torch.arange(num_cols, device=dev), keys // groups]), num_cols)
