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
:func:`collect_cycles`. A module whose tests build no JAX ``Model``,
``LLMEngine`` or ``CheckpointManager`` (JAX ops and small layers only)
imports :func:`collect_around_module` instead: one collection before its
first test and one after its last, so the next module starts as clean
as after :func:`collect_cycles`, without a full collection (~0.15 s) a
test.
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


@pytest.fixture(autouse=True, scope="module")
def collect_around_module():
    gc.collect()
    yield
    gc.collect()
