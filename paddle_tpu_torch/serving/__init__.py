"""Fault-tolerant serving fleet: engine replicas + prefix-affinity
router with failover (docs/RELIABILITY.md "Fleet failure model").

The single-process :class:`~paddle_tpu_torch.inference.LLMEngine` scales out
here: a :class:`Router` fronts K replicas (in-process engines, spawned
subprocesses, or attached endpoints; membership via the rendezvous
TCPStore), routing by prefix affinity, breaking circuits on failing
replicas, and failing crashed requests over within their retry budget
— token-identically, because the router pins each request's sampling
nonce and all replicas share weights and seed.

    from paddle_tpu_torch.serving import Router, LocalReplica
    router = Router({"r0": LocalReplica(eng0),
                     "r1": LocalReplica(eng1)})
    out = router.submit(prompt_ids, deadline=5.0).result()
"""

from .autoscaler import (Autoscaler, SubprocessReplica,
                         make_subprocess_spawner)
from .breaker import CircuitBreaker
from .fleet import FleetScraper, parse_prometheus_text
from .overload import (AIMDLimiter, BrownoutLadder, OverloadController,
                       ServiceTimeEstimator)
from .replica import (HTTPReplica, LocalReplica, ReplicaUnavailable,
                      build_net_from_spec, make_engine_from_spec,
                      spawn_replica, terminate_replica)
from .router import Router, SLOClass, TenantQuota

__all__ = [
    "AIMDLimiter",
    "Autoscaler",
    "BrownoutLadder",
    "SubprocessReplica",
    "make_subprocess_spawner",
    "CircuitBreaker",
    "FleetScraper",
    "parse_prometheus_text",
    "HTTPReplica",
    "LocalReplica",
    "OverloadController",
    "ReplicaUnavailable",
    "Router",
    "SLOClass",
    "ServiceTimeEstimator",
    "TenantQuota",
    "build_net_from_spec",
    "make_engine_from_spec",
    "spawn_replica",
    "terminate_replica",
]
