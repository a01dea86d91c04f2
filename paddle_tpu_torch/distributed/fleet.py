"""paddle_tpu_torch.distributed.fleet — the fleet facade (the port's
counterpart of ``paddle_tpu/distributed/fleet.py``).

Reference being replaced: ``paddle.distributed.fleet``
(python/paddle/distributed/fleet/__init__.py re-exporting
fleet/base/fleet_base.py:110 ``Fleet`` — ``init`` :211,
``distributed_optimizer`` :947, ``distributed_model`` :1000, worker/
server role queries, PS worker lifecycle) over role makers
(base/role_maker.py PaddleCloudRoleMaker).

``init(is_collective=True)`` is ``parallel.init_parallel_env`` (the
launcher's environment; a role maker only carries indices).
``distributed_model`` attaches the mesh to a hapi ``Model`` or wraps a
``Layer`` in ``DataParallel`` — the same two shapes the reference
handles. ``distributed_optimizer`` records the strategy. Parameter-server
lifecycle calls (init_worker/init_server/run_server) raise, as in the
JAX package: run collective mode.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from ..parallel import (DataParallel, DistributedStrategy,
                        distributed_model as _distributed_model,
                        get_mesh, init_mesh, init_parallel_env)
from ..parallel import get_rank, get_world_size

_state: dict = {"initialized": False, "strategy": None,
                "is_collective": False}


class UserDefinedRoleMaker:
    """ref: base/role_maker.py UserDefinedRoleMaker — carries explicit
    rank/world-size."""

    def __init__(self, current_id: int = 0, worker_num: int = 1,
                 role: Any = "worker", **kw):
        self.current_id = current_id
        self.worker_num_ = worker_num


class PaddleCloudRoleMaker:
    """ref: base/role_maker.py PaddleCloudRoleMaker — reads the launcher
    environment (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM)."""

    def __init__(self, is_collective: bool = False, **kw):
        self.current_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        self.worker_num_ = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
        self.is_collective = is_collective


def init(role_maker=None, is_collective: bool = False,
         strategy: Optional[DistributedStrategy] = None, **env_kw) -> None:
    """ref: fleet_base.py:211 Fleet.init. ``env_kw`` (``backend``,
    ``device``) pass through to ``init_parallel_env``."""
    if is_collective or role_maker is None:
        init_parallel_env(**env_kw)
    _state.update(initialized=True, strategy=strategy,
                  is_collective=is_collective,
                  role_maker=role_maker or PaddleCloudRoleMaker(
                      is_collective=is_collective))


def _require_init():
    if not _state["initialized"]:
        raise RuntimeError("call fleet.init() first "
                           "(ref: fleet_base.py raises the same)")


def is_first_worker() -> bool:
    return worker_index() == 0


def worker_index() -> int:
    rm = _state.get("role_maker")
    if isinstance(rm, UserDefinedRoleMaker):
        return rm.current_id  # explicit user-managed launch
    return get_rank()


def worker_num() -> int:
    rm = _state.get("role_maker")
    if isinstance(rm, UserDefinedRoleMaker):
        return rm.worker_num_
    return get_world_size()


def is_worker() -> bool:
    return True  # collective mode: every process trains


def barrier_worker() -> None:
    from ..parallel import barrier
    barrier()


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """ref: fleet_base.py:947. Records the strategy and returns the
    optimizer unwrapped: the gradient reduction belongs to the Model on
    the mesh (``parallel.reducer``) or to ``DataParallel``."""
    _require_init()
    if strategy is not None:
        _state["strategy"] = strategy
    optimizer._fleet_strategy = _state["strategy"]
    return optimizer


def distributed_model(model):
    """ref: fleet_base.py:1000 — hapi Model gets the mesh hooks, a raw
    Layer gets the DataParallel wrapper (the reference's two shapes)."""
    _require_init()
    from ..hapi.model import Model as HapiModel
    from ..nn.layer import Layer
    if isinstance(model, HapiModel):
        return _distributed_model(model, strategy=_state["strategy"])
    if isinstance(model, Layer):
        if get_mesh(required=False) is None:
            axes = (_state["strategy"].mesh_axes()
                    if _state["strategy"] else None) or {"dp": -1}
            init_mesh(**axes)
        return DataParallel(model)
    raise TypeError(f"cannot distribute {type(model).__name__}")


def get_strategy() -> Optional[DistributedStrategy]:
    return _state["strategy"]


# -- parameter-server lifecycle (deliberately unsupported) ------------------

_PS_MSG = ("the parameter-server runtime is not part of this framework "
           "(the JAX package replaces it by sharded embeddings over the "
           "mesh) — run collective mode: fleet.init(is_collective=True)")


# fleet.utils namespace (ref: fleet/utils/__init__.py exposes fs)
from . import fs as utils  # noqa: E402


def init_worker(*a, **kw):
    raise NotImplementedError(_PS_MSG)


def init_server(*a, **kw):
    raise NotImplementedError(_PS_MSG)


def run_server(*a, **kw):
    raise NotImplementedError(_PS_MSG)


def stop_worker(*a, **kw):
    raise NotImplementedError(_PS_MSG)
