"""One rank of a launcher job: ``python run_rank.py <script> <args...>``
(``launch.rank_argv``), what the port's launchers (``elastic.ElasticManager``,
``multinode.NodeAgent``) start for each rank.

It runs ``script`` as ``__main__`` with the ``sys.argv`` and
``sys.path[0]`` that ``python script`` gives it, then ends the process as
Python would (non-daemon threads joined, ``atexit`` handlers run, the
standard streams flushed, Python's exit code: 0, ``SystemExit``'s code,
1 after an uncaught exception) but by ``os._exit``, without the
interpreter's finalization. The cause it steps round is in torch: a
gloo process group's worker thread (``pt_gloo_runloop``,
``c10d::ProcessGroupGloo::runLoop``) can still hold the last reference
to a finished collective when the collective's caller has returned, and
releasing it frees a tensor that has a Python object, which takes the
GIL. When the rank's script has ended by then, the interpreter is
finalizing, CPython ends a thread that asks for the GIL with
``pthread_exit``, and its forced unwind through the worker's
``noexcept`` frame calls ``std::terminate`` ("terminate called without
an active exception", exit -6). A rank that had finished its work then
aborted now and then under load, and its node agent counted a failure
of the job. Destroying the process group first does not close the race
while anything else still references the group. Imports only the
standard library.
"""

import atexit
import os
import runpy
import sys
import threading


def _exit_code(e: SystemExit) -> int:
    if e.code is None:
        return 0
    if isinstance(e.code, int):
        return e.code
    print(e.code, file=sys.stderr)
    return 1


def main() -> None:
    script = sys.argv[1]
    sys.argv = sys.argv[1:]
    sys.path[0] = os.path.dirname(os.path.abspath(script))
    code = 0
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        code = _exit_code(e)
    except BaseException as e:  # noqa: BLE001 — reported as Python does
        sys.excepthook(type(e), e, e.__traceback__)
        code = 1
    for t in threading.enumerate():
        if t is not threading.main_thread() and not t.daemon:
            t.join()
    atexit._run_exitfuncs()
    for stream in (sys.stdout, sys.stderr):
        stream.flush()
    os._exit(code)


if __name__ == "__main__":
    main()
