"""paddle_tpu_torch.distributed — the single-host launcher, ``spawn``,
elastic restarts and preemption (``launch``, ``spawn``, ``elastic``),
and the socket store the serving fleet runs its membership on. The
process groups, collectives, the multi-node agent and the mesh of the
JAX package's ``distributed`` are not ported yet (ROADMAP A6.3)."""

from . import elastic, launch  # noqa: F401
from .elastic import (RESTART_EXIT_CODE, ElasticManager,  # noqa: F401
                      ElasticStatus, Heartbeat, PreemptionGuard,
                      restart_count)
from .spawn import ProcessContext, spawn  # noqa: F401
from .tcp_store import (StoreUnavailable, TCPMembership,  # noqa: F401
                        TCPStoreClient, TCPStoreServer)

__all__ = ["ElasticManager", "ElasticStatus", "Heartbeat",
           "PreemptionGuard", "ProcessContext", "RESTART_EXIT_CODE",
           "StoreUnavailable", "TCPMembership", "TCPStoreClient",
           "TCPStoreServer", "elastic", "launch", "restart_count",
           "spawn"]
