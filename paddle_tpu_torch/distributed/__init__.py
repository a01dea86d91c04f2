"""paddle_tpu_torch.distributed — the reference-compatible namespace
(the port's counterpart of ``paddle_tpu/distributed``): the mesh,
sharding and collectives of :mod:`paddle_tpu_torch.parallel` under their
``paddle.distributed`` names; the eager communication calls
(``comm``); the fleet facade; ``LocalFS``; the launcher (``python -m
paddle_tpu_torch.distributed.launch``, one node or several through
``multinode.NodeAgent``), ``spawn``, elastic restarts and preemption;
the socket store behind the serving fleet's membership and the tcp
rendezvous; and the parameter-server datasets (``dataset``:
``QueueDataset``, ``InMemoryDataset``, the admission entries) and the
tree index of ``index_dataset``."""

from ..parallel import (AXIS_ORDER, DataParallel, DeviceMesh,  # noqa: F401
                        DistributedStrategy, GradientMerge, LogicalRules,
                        RecomputeSequential, all_gather, all_reduce,
                        barrier, broadcast, distributed_model, get_mesh,
                        get_rank, get_world_size, init_mesh,
                        init_parallel_env, named_sharding, recompute,
                        replicate, set_mesh, shard_batch, shard_params)
from . import elastic, fleet, fs, index_dataset, launch  # noqa: F401
from . import multinode  # noqa: F401
from .comm import (Group, ParallelEnv, ParallelMode,  # noqa: F401
                   ReduceOp, alltoall, get_group, gloo_barrier,
                   gloo_init_parallel_env, gloo_release, irecv,
                   is_initialized, isend, new_group, recv, reduce,
                   reduce_scatter, scatter, send, split, wait)
from .elastic import (RESTART_EXIT_CODE, ElasticManager,  # noqa: F401
                      ElasticStatus, Heartbeat, PreemptionGuard,
                      restart_count)
from .multinode import FileRendezvous, NodeAgent  # noqa: F401
from .spawn import ProcessContext, spawn  # noqa: F401
from .tcp_store import (StoreUnavailable, TCPMembership,  # noqa: F401
                        TCPRendezvous, TCPStoreClient, TCPStoreServer)
from .dataset import (CountFilterEntry, InMemoryDataset,  # noqa: F401
                      ProbabilityEntry, QueueDataset, ShowClickEntry)
