from .boolean import Boolean  # noqa: F401
from .fp import FpG  # noqa: F401
