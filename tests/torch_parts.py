"""Cut a family of parity tests into test files of at most 26 tests.

pytest-xdist's ``--dist loadfile`` hands whole files to its workers, the
files with the most tests first, and gives a worker its next file when
two tests of its current one are left.
``tests/test_perf_observability.py`` (25 tests) holds
``test_program_cap_discipline``, which deadlocks when a collection inside
it finalizes a dead JAX ``Model`` or ``LLMEngine`` (ROADMAP Queue C item
4): whether it does depends on what its worker ran before it since the
last full collection. Parts of 26 tests queue just ahead of it, are
short, and end with a full collection (``torch_gc_barrier.
collect_around_module``), so the worker that draws it is most often one
finishing a part, which collects before it starts.

A family's case module lists its tests as ``(name, body, cases, ids)``
(``cases`` None for a test that takes no parameters); :func:`split`
cuts the list into parts, and each part's file calls :func:`install`.
"""

import pytest

PART_SIZE = 26


def split(tests, files):
    """The tests' cases in order, cut into parts of at most
    ``PART_SIZE`` tests: a list of ``files`` parts, each a list of
    ``(name, body, cases, ids)``. Raises when the family needs another
    number of part files than it has."""
    flat = []
    for name, body, cases, ids in tests:
        if cases is None:
            flat.append((name, body, None, None))
        else:
            flat += [(name, body, c, i) for c, i in zip(cases, ids)]
    parts = [flat[i:i + PART_SIZE] for i in range(0, len(flat), PART_SIZE)]
    if len(parts) != files:
        raise RuntimeError(f"{len(flat)} tests need {len(parts)} part "
                           f"files, not {files}")
    out = []
    for part in parts:
        grouped = {}
        for name, body, case, case_id in part:
            entry = grouped.setdefault(name, (body, [], []))
            if case is not None:
                entry[1].append(case)
                entry[2].append(case_id)
        out.append([(n, b, c or None, i or None)
                    for n, (b, c, i) in grouped.items()])
    return out


def install(namespace, part):
    """Define the part's tests in a test module's ``namespace``."""
    for name, body, cases, ids in part:
        if cases is None:
            def test(body=body):
                body()
        else:
            @pytest.mark.parametrize("case", cases, ids=ids)
            def test(case, body=body):
                body(*case)
        test.__name__ = test.__qualname__ = name
        test.__doc__ = body.__doc__
        namespace[name] = test
