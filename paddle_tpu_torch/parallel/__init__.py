"""paddle_tpu_torch.parallel — distributed training on a named mesh of
``torch.distributed`` ranks (the port's counterpart of
``paddle_tpu/parallel``): a :class:`DeviceMesh` with named axes,
logical-axis sharding rules, collectives by mesh axis, the strategy
config, ``init_parallel_env`` / ``DataParallel`` / ``distributed_model``
(dp and fsdp run; tp, pp, sp and ep resolve but raise), and
recomputation with gradient merge. The planner, the pipeline schedules
and local SGD are not ported yet (ROADMAP A6.4)."""

from .mesh import (AXIS_ORDER, DeviceMesh, get_mesh, init_mesh,  # noqa
                   init_mesh_from_axes, set_mesh)
from .sharding import (DEFAULT_RULES, LogicalRules, named_sharding,  # noqa
                       replicate, shard_batch, shard_params, shard_spec,
                       shard_superbatch, with_logical_constraint)
from .strategy import (AMPConfig, DistributedStrategy,  # noqa
                       GradientMergeConfig, HybridConfig, MoEConfig,
                       PipelineConfig, RecomputeConfig, ShardingConfig)
from .api import (DataParallel, all_gather, all_reduce, barrier,  # noqa
                  broadcast, distributed_model, get_rank, get_world_size,
                  init_parallel_env)
from .recompute import (GradientMerge, RecomputeSequential,  # noqa: F401
                        recompute)
from . import collective  # noqa: F401
