"""Multi-process launcher: ``python -m paddle_tpu_torch.distributed.launch``
(the port's counterpart of ``paddle_tpu/distributed/launch.py``).

Reference being replaced: ``python -m paddle.distributed.launch``
(python/paddle/distributed/launch/__main__.py:18 → main.py; the
CollectiveController spawns one process per device with a watcher that
restarts failures — launch/controllers/collective.py, launch/job/).

This launcher covers the single-host multi-process story: it spawns N
ranks with the PADDLE_MASTER / PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM
environment (and torch.distributed's MASTER_ADDR / MASTER_PORT / RANK /
WORLD_SIZE), streams logs per rank, and propagates the first failure
(optionally restarting, the elastic watcher's job). With ``--nnodes >
1`` this process is the node agent of ``--node_rank``
(``multinode.NodeAgent``) over a shared rendezvous directory
(``--rdzv_dir``) or the leader's socket store (``--rdzv_backend tcp
--rdzv_endpoint``)."""

from __future__ import annotations

import argparse
import os
import socket
import sys
from typing import List, Optional


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def rank_argv(script: str, script_args: List[str]) -> List[str]:
    """The command of one rank of ``script``: run by ``run_rank.py``,
    which ends the rank without the interpreter's finalization, where
    gloo's worker thread can abort a rank that finished its work."""
    runner = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "run_rank.py")
    return [sys.executable, runner, script, *script_args]


def trainer_env(rank: int, nprocs: int, master: str) -> dict:
    """The rendezvous environment every worker-launch path sets
    (launcher generations, elastic restarts, spawn)."""
    host, port = master.split(":")
    return {"PADDLE_MASTER": master, "MASTER_ADDR": host,
            "MASTER_PORT": port, "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nprocs), "RANK": str(rank),
            "WORLD_SIZE": str(nprocs)}


def launch(nproc: int, training_script: str,
           script_args: List[str],
           master: Optional[str] = None,
           log_dir: Optional[str] = None,
           max_restarts: int = 0,
           heartbeat_timeout: Optional[float] = None,
           env_extra: Optional[dict] = None) -> int:
    """Spawn ``nproc`` ranks of ``training_script``; return exit code.

    One code path: the ElasticManager watches every generation
    (process liveness always; progress heartbeats when
    ``heartbeat_timeout`` is set) and restarts failed/stalled
    generations up to ``max_restarts`` times."""
    from .elastic import ElasticManager
    return ElasticManager(
        nproc, training_script, script_args, master=master,
        log_dir=log_dir, max_restarts=max_restarts,
        heartbeat_timeout=heartbeat_timeout, env_extra=env_extra).run()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="single-host multi-process launcher "
                    "(ref: python -m paddle.distributed.launch)")
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--master", type=str, default=None,
                        help="host:port rendezvous (default: free port)")
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("--max_restarts", type=int, default=0)
    parser.add_argument("--heartbeat_timeout", type=float, default=None,
                        help="restart the job if no rank heartbeats for "
                             "this many seconds (elastic stall watch)")
    parser.add_argument("--nnodes", type=int, default=1,
                        help="number of nodes; >1 runs this process as "
                             "the node agent for --node_rank (ref: "
                             "launch/controllers/collective.py Pod)")
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--rdzv_dir", type=str, default=None,
                        help="shared rendezvous directory (file "
                             "backend; NFS/GCS-fuse on pods)")
    parser.add_argument("--rdzv_backend", type=str, default="file",
                        choices=("file", "tcp"),
                        help="rendezvous store: 'file' (shared dir) or "
                             "'tcp' (rank-0-hosted socket store, ref: "
                             "distributed/store/tcp_store.h)")
    parser.add_argument("--rdzv_endpoint", type=str, default=None,
                        help="host:port of the tcp store (leader binds "
                             "the port; peers connect)")
    parser.add_argument("--node_timeout", type=float, default=10.0,
                        help="seconds without a peer agent heartbeat "
                             "before declaring the node lost")
    parser.add_argument("training_script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.nnodes > 1:
        if args.rdzv_backend == "file" and not args.rdzv_dir:
            parser.error("--nnodes > 1 requires --rdzv_dir "
                         "(or --rdzv_backend tcp --rdzv_endpoint)")
        if args.rdzv_backend == "tcp" and not args.rdzv_endpoint:
            parser.error("--rdzv_backend tcp requires --rdzv_endpoint")
        from .multinode import NodeAgent
        from .tcp_store import StoreUnavailable
        try:
            return NodeAgent(
                args.node_rank, args.nnodes, args.nproc_per_node,
                args.training_script, args.script_args,
                rdzv_dir=args.rdzv_dir, max_restarts=args.max_restarts,
                node_timeout=args.node_timeout,
                log_dir=args.log_dir,
                rdzv_backend=args.rdzv_backend,
                rdzv_endpoint=args.rdzv_endpoint).run()
        except StoreUnavailable as e:
            # leader's store never came up inside the rendezvous
            # window: same exit as a rendezvous timeout, so the
            # platform treats it as a job-level restart
            print(f"[launch] rendezvous store unavailable: {e}",
                  file=sys.stderr)
            return 2
    return launch(args.nproc_per_node, args.training_script,
                  args.script_args, master=args.master,
                  log_dir=args.log_dir, max_restarts=args.max_restarts,
                  heartbeat_timeout=args.heartbeat_timeout)


if __name__ == "__main__":
    sys.exit(main())
