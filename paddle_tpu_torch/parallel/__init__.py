"""paddle_tpu_torch.parallel — distributed training on a named mesh of
``torch.distributed`` ranks (the port's counterpart of
``paddle_tpu/parallel``): a :class:`DeviceMesh` with named axes,
logical-axis sharding rules, collectives by mesh axis (and the
tensor-parallel pair), the strategy config, ``init_parallel_env`` /
``DataParallel`` / ``distributed_model`` (dp, fsdp, tp and pp run; sp and
ep resolve but raise), the pipeline (``PipelineLayer`` /
``PipelineParallel``), the auto-parallel planner, local SGD, and
recomputation with gradient merge."""

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
from .pipeline import (LayerDesc, PipelineLayer, PipelineParallel,  # noqa
                       SharedLayerDesc)
from .recompute import (GradientMerge, RecomputeSequential,  # noqa: F401
                        recompute)
from .planner import ChipSpec, Plan, evaluate, plan  # noqa: F401
from .localsgd import (build_local_sgd_step, replicate_params,  # noqa
                       unreplicate_params)
from . import collective  # noqa: F401
from . import planner  # noqa: F401
