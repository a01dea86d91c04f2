"""DistributedStrategy — the typed strategy config (the port's counterpart
of ``paddle_tpu/parallel/strategy.py``, the same dataclasses).

Rebuild of the reference's strategy proto + wrapper
(reference: paddle/fluid/framework/distributed_strategy.proto:278 with
per-feature sub-messages at :320+; Python facade
python/paddle/distributed/fleet/base/distributed_strategy.py:110).
The reference toggles graph-rewrite passes; here each knob either picks a
mesh axis size, a jit option, or a training-loop behavior. Dataclasses
replace protobuf — serializable via to_dict/from_dict (JSON) for parity
with proto text format.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class AMPConfig:
    """ref: distributed_strategy.proto AMPConfig (:320s); bf16-first,
    so no loss scaling by default (dtype='bfloat16'); fp16 + dynamic
    loss scaling kept for parity."""
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O1"
    init_loss_scaling: float = 32768.0
    incr_every_n_steps: int = 1000
    decr_every_n_nan_or_inf: int = 2
    incr_ratio: float = 2.0
    decr_ratio: float = 0.5
    use_dynamic_loss_scaling: bool = True
    custom_white_list: Tuple[str, ...] = ()
    custom_black_list: Tuple[str, ...] = ()


@dataclass
class RecomputeConfig:
    """ref: RecomputeConfig proto; the JAX package maps it to
    jax.checkpoint policies (kept as data here)."""
    enable: bool = False
    checkpoints: Tuple[str, ...] = ()     # layer-name prefixes to remat
    policy: str = "nothing_saveable"      # the JAX package's policy name


@dataclass
class ShardingConfig:
    """ZeRO stages (ref: GroupShardedStage2/3
    distributed/fleet/meta_parallel/sharding/group_sharded_stage2.py:49,
    group_sharded_stage3.py:60). stage>=3 shards params on the fsdp axis;
    stages 1/2 (optimizer/grad shard) also express as fsdp-axis
    sharding of the respective trees."""
    enable: bool = False
    stage: int = 3
    degree: int = 1


@dataclass
class PipelineConfig:
    """ref: PipelineConfig proto + meta_parallel/pipeline_parallel.py."""
    enable: bool = False
    degree: int = 1
    micro_batches: int = 1
    schedule: str = "1F1B"


@dataclass
class MoEConfig:
    enable: bool = False
    degree: int = 1  # expert-parallel group size


@dataclass
class HybridConfig:
    """ref: fleet/base/distributed_strategy.py hybrid_configs
    {dp,mp,pp,sharding}_degree."""
    dp_degree: int = -1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sp_degree: int = 1
    ep_degree: int = 1


@dataclass
class GradientMergeConfig:
    """ref: gradient_merge_optimizer.py — microbatch grad accumulation."""
    enable: bool = False
    k_steps: int = 1
    avg: bool = True


@dataclass
class DistributedStrategy:
    amp: AMPConfig = field(default_factory=AMPConfig)
    recompute: RecomputeConfig = field(default_factory=RecomputeConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    hybrid_configs: HybridConfig = field(default_factory=HybridConfig)
    gradient_merge: GradientMergeConfig = field(
        default_factory=GradientMergeConfig)
    # loose knobs (proto scalars)
    gradient_scale: bool = True          # mean-reduce grads over dp
    find_unused_parameters: bool = False  # parity no-op (trace finds all)

    def mesh_axes(self) -> Dict[str, int]:
        h = self.hybrid_configs
        axes = {"dp": h.dp_degree, "tp": h.mp_degree, "pp": h.pp_degree,
                "fsdp": h.sharding_degree, "sp": h.sp_degree,
                "ep": h.ep_degree}
        if self.sharding.enable and self.sharding.degree > 1:
            axes["fsdp"] = self.sharding.degree
        if self.pipeline.enable and self.pipeline.degree > 1:
            axes["pp"] = self.pipeline.degree
        if self.moe.enable and self.moe.degree > 1:
            axes["ep"] = self.moe.degree
        return {k: v for k, v in axes.items() if v != 1}

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DistributedStrategy":
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if dataclasses.is_dataclass(f.type) or (
                    isinstance(f.default_factory, type)
                    and dataclasses.is_dataclass(f.default_factory)):
                sub = f.default_factory
                v = sub(**{k: (tuple(x) if isinstance(x, list) else x)
                           for k, x in v.items()})
            kw[f.name] = v
        return cls(**kw)
