"""Part 3 of 3 of the parity tests in ``tests/torch_vision_cases.py``
(that module says what they hold and to which limits)."""

from torch_gc_barrier import collect_cycles  # noqa: F401
from torch_parts import install
from torch_vision_cases import PARTS

install(globals(), PARTS[2])
