"""A garbage-collection barrier around each port test.

The port's tests build JAX ``Model``, ``LLMEngine`` and
``CheckpointManager`` objects to compare against, and some end up in
reference cycles. Their ``weakref.finalize`` callbacks release entries
of the JAX package's perf and memory registries, taking the registry's
non-reentrant lock. A collection that finalizes them while that same
lock is held — an allocation inside
``paddle_tpu/observability/perf.py::register_program`` — deadlocks the
test process (ROADMAP Queue C item 1). Collecting before a module's
first test and after every test finalizes such cycles outside any lock:
those each test leaves, and those the files run before the module in
the same worker left. What a collection that starts inside one test
finds (a JAX object dropped in a cycle and another registered later in
the same test) is not covered. A port test module opts in by importing
:func:`collect_cycles`.
"""

import gc

import pytest

_modules_seen = set()


@pytest.fixture(autouse=True)
def collect_cycles(request):
    module = request.module.__name__
    if module not in _modules_seen:
        _modules_seen.add(module)
        gc.collect()
    yield
    gc.collect()
