"""Part 1 of 2 of the parity tests in ``tests/torch_sparse_cases.py``
(that module says what they hold and to which limits)."""

from torch_gc_barrier import collect_around_module  # noqa: F401
from torch_parts import install
from torch_sparse_cases import PARTS, _on_cpu  # noqa: F401

install(globals(), PARTS[0])
