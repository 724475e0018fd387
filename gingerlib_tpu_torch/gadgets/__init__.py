"""In-circuit gadgets over the port's R1CS ``ConstraintSystem`` (host code)."""

from . import std  # noqa: F401
