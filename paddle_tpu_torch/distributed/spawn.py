"""paddle.distributed.spawn parity (the port's counterpart of
``paddle_tpu/distributed/spawn.py``; ref: python/paddle/distributed/
spawn.py — starts ``nprocs`` worker processes running ``func(*args)``
with the trainer env set, joining with error propagation).

Workers start with the ``spawn`` method by default (a fresh
interpreter: forking a process whose torch threads are live can
deadlock) and get the same PADDLE_* / torch.distributed rendezvous env
the launcher sets; the parent joins and re-raises the first failure."""

from __future__ import annotations

import multiprocessing as mp
import os
import traceback
from typing import Optional, Sequence

from .launch import find_free_port, trainer_env


class ProcessContext:
    """ref: spawn.py MultiprocessContext — join() with error text."""

    def __init__(self, procs, error_queues):
        self.processes = procs
        self._errors = error_queues

    def join(self, timeout: Optional[float] = None) -> bool:
        # drain error queues WHILE joining: a child blocked in put()
        # (traceback larger than the pipe buffer) must be read before
        # its process can exit
        tracebacks = {}
        import time as _time
        deadline = None if timeout is None else _time.time() + timeout
        pending = list(enumerate(self.processes))
        while pending:
            for i, q in enumerate(self._errors):
                if i not in tracebacks and not q.empty():
                    tracebacks[i] = q.get()
            still = []
            for i, p in pending:
                p.join(0.05)
                if p.exitcode is None:
                    still.append((i, p))
            pending = still
            if deadline is not None and _time.time() > deadline:
                break
        for i, q in enumerate(self._errors):
            if i not in tracebacks and not q.empty():
                tracebacks[i] = q.get()
        if tracebacks:
            rank = min(tracebacks)
            raise RuntimeError(
                f"spawned rank {rank} failed:\n{tracebacks[rank]}")
        # a rank can die without a Python exception (segfault, _exit):
        # surface it like the reference instead of returning quietly
        bad = [(i, p.exitcode) for i, p in enumerate(self.processes)
               if p.exitcode not in (0, None)]
        if bad:
            raise RuntimeError(
                f"spawned rank {bad[0][0]} exited with code "
                f"{bad[0][1]} (no Python traceback)")
        return all(p.exitcode == 0 for p in self.processes)


def _worker(func, args, rank, nprocs, master, err_q):
    os.environ.update(trainer_env(rank, nprocs, master))
    try:
        func(*args)
    except BaseException:
        err_q.put(traceback.format_exc())
        raise


def spawn(func, args: Sequence = (), nprocs: int = 1,
          join: bool = True, daemon: bool = False,
          **options) -> ProcessContext:
    """ref: paddle.distributed.spawn(func, args, nprocs, join)."""
    master = options.get("master") or f"127.0.0.1:{find_free_port()}"
    ctx = mp.get_context(options.get("start_method", "spawn"))
    procs, errs = [], []
    for rank in range(nprocs):
        err_q = ctx.SimpleQueue()
        p = ctx.Process(target=_worker,
                        args=(func, tuple(args), rank, nprocs, master,
                              err_q),
                        daemon=daemon)
        p.start()
        procs.append(p)
        errs.append(err_q)
    context = ProcessContext(procs, errs)
    if join:
        context.join()
    return context
