"""The port stands alone: no module of ``paddle_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package
(``paddle_tpu``), not even its JAX-free modules. Checked on the source
with an AST scan, so an import inside a function counts too."""

import ast
from pathlib import Path

import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                _forbidden(str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("paddle_tpu_torch/inference/llm.py",
                 "paddle_tpu_torch/ops/paged_attention.py",
                 "paddle_tpu_torch/ops/flash_attention.py",
                 "paddle_tpu_torch/ops/fused_xent.py",
                 "paddle_tpu_torch/ops/ring_attention.py",
                 "paddle_tpu_torch/nn/functional_fill.py",
                 "paddle_tpu_torch/nn/layers/fill_r4.py",
                 "paddle_tpu_torch/nn/layers/sparse_embedding.py",
                 "paddle_tpu_torch/nn/layers/host_embedding.py",
                 "paddle_tpu_torch/nn/layers/sharded_embedding.py",
                 "paddle_tpu_torch/nn/layers/native_accessor.py",
                 "paddle_tpu_torch/core/native_build.py",
                 "paddle_tpu_torch/models/widedeep.py",
                 "paddle_tpu_torch/amp/__init__.py",
                 "paddle_tpu_torch/nn/clip.py",
                 "paddle_tpu_torch/optimizer/lr.py",
                 "paddle_tpu_torch/optimizer/optimizer.py",
                 "paddle_tpu_torch/hapi/model.py",
                 "paddle_tpu_torch/models/gpt.py",
                 "paddle_tpu_torch/inference/kv_transfer.py",
                 "paddle_tpu_torch/reliability/__init__.py",
                 "paddle_tpu_torch/reliability/faults.py",
                 "paddle_tpu_torch/reliability/retry.py",
                 "paddle_tpu_torch/observability/__init__.py",
                 "paddle_tpu_torch/observability/audit.py",
                 "paddle_tpu_torch/observability/exporters.py",
                 "paddle_tpu_torch/observability/flight.py",
                 "paddle_tpu_torch/observability/goodput.py",
                 "paddle_tpu_torch/observability/memory.py",
                 "paddle_tpu_torch/observability/metrics.py",
                 "paddle_tpu_torch/observability/perf.py",
                 "paddle_tpu_torch/observability/propagation.py",
                 "paddle_tpu_torch/observability/server.py",
                 "paddle_tpu_torch/observability/tracing.py",
                 "paddle_tpu_torch/observability/slo.py",
                 "paddle_tpu_torch/profiler/__init__.py",
                 "paddle_tpu_torch/cost_model.py",
                 "paddle_tpu_torch/jit/__init__.py",
                 "paddle_tpu_torch/static/__init__.py",
                 "paddle_tpu_torch/static/program.py",
                 "paddle_tpu_torch/static/nn.py",
                 "paddle_tpu_torch/quant/__init__.py",
                 "paddle_tpu_torch/incubate/autotune.py",
                 "paddle_tpu_torch/incubate/asp.py",
                 "paddle_tpu_torch/incubate/data_generator.py",
                 "paddle_tpu_torch/testing/__init__.py",
                 "paddle_tpu_torch/sysconfig.py",
                 "paddle_tpu_torch/version.py",
                 "paddle_tpu_torch/distributed/tcp_store.py",
                 "paddle_tpu_torch/serving/autoscaler.py",
                 "paddle_tpu_torch/serving/breaker.py",
                 "paddle_tpu_torch/serving/fleet.py",
                 "paddle_tpu_torch/serving/overload.py",
                 "paddle_tpu_torch/serving/replica.py",
                 "paddle_tpu_torch/serving/router.py",
                 "paddle_tpu_torch/io/__init__.py",
                 "paddle_tpu_torch/io/sequence.py",
                 "paddle_tpu_torch/metric/__init__.py",
                 "paddle_tpu_torch/hapi/callbacks.py",
                 "paddle_tpu_torch/hapi/summary.py",
                 "paddle_tpu_torch/callbacks.py",
                 "paddle_tpu_torch/core/flags.py",
                 "paddle_tpu_torch/amp/debugging.py",
                 "paddle_tpu_torch/reliability/guard.py",
                 "paddle_tpu_torch/nn/utils.py",
                 "paddle_tpu_torch/nn/initializer.py",
                 "paddle_tpu_torch/nn/functional.py",
                 "paddle_tpu_torch/core/monitor.py",
                 "paddle_tpu_torch/io/checkpoint.py",
                 "paddle_tpu_torch/io/crypto.py",
                 "paddle_tpu_torch/distributed/__init__.py",
                 "paddle_tpu_torch/distributed/launch.py",
                 "paddle_tpu_torch/distributed/spawn.py",
                 "paddle_tpu_torch/distributed/elastic.py",
                 "paddle_tpu_torch/parallel/__init__.py",
                 "paddle_tpu_torch/parallel/recompute.py",
                 "paddle_tpu_torch/parallel/api.py",
                 "paddle_tpu_torch/parallel/collective.py",
                 "paddle_tpu_torch/parallel/mesh.py",
                 "paddle_tpu_torch/parallel/reducer.py",
                 "paddle_tpu_torch/parallel/sharding.py",
                 "paddle_tpu_torch/parallel/pipeline.py",
                 "paddle_tpu_torch/parallel/planner.py",
                 "paddle_tpu_torch/parallel/localsgd.py",
                 "paddle_tpu_torch/parallel/strategy.py",
                 "paddle_tpu_torch/distributed/comm.py",
                 "paddle_tpu_torch/distributed/fleet.py",
                 "paddle_tpu_torch/distributed/fs.py",
                 "paddle_tpu_torch/distributed/multinode.py",
                 "paddle_tpu_torch/core/dtype.py",
                 "paddle_tpu_torch/core/device.py",
                 "paddle_tpu_torch/core/threefry.py",
                 "paddle_tpu_torch/core/xla_math.py",
                 "paddle_tpu_torch/device/__init__.py",
                 "paddle_tpu_torch/device/fill_r4.py",
                 "paddle_tpu_torch/tensor/__init__.py",
                 "paddle_tpu_torch/tensor/extra.py",
                 "paddle_tpu_torch/linalg.py",
                 "paddle_tpu_torch/fft.py",
                 "paddle_tpu_torch/signal.py",
                 "paddle_tpu_torch/framework.py",
                 "paddle_tpu_torch/compat_fill.py",
                 "paddle_tpu_torch/autograd/__init__.py",
                 "paddle_tpu_torch/regularizer.py",
                 "paddle_tpu_torch/distribution/__init__.py",
                 "paddle_tpu_torch/distribution/transform.py",
                 "paddle_tpu_torch/sparse/__init__.py",
                 "paddle_tpu_torch/sparse/nn/__init__.py",
                 "paddle_tpu_torch/sparse/nn/functional.py",
                 "paddle_tpu_torch/models/bert.py",
                 "paddle_tpu_torch/models/resnet.py",
                 "paddle_tpu_torch/models/vgg.py",
                 "paddle_tpu_torch/models/mobilenet.py",
                 "paddle_tpu_torch/models/lenet.py",
                 "paddle_tpu_torch/models/vision_extra.py",
                 "paddle_tpu_torch/models/convert.py",
                 "paddle_tpu_torch/vision/__init__.py",
                 "paddle_tpu_torch/vision/datasets.py",
                 "paddle_tpu_torch/vision/transforms.py",
                 "paddle_tpu_torch/vision/transforms_fill.py",
                 "paddle_tpu_torch/vision/ops.py",
                 "paddle_tpu_torch/vision/ops_fill.py",
                 "paddle_tpu_torch/text/__init__.py",
                 "paddle_tpu_torch/hub.py",
                 "chip_smoke.py"):
        assert must in names


def test_parallel_and_distributed_export_their_names():
    """The names of the JAX package's ``parallel`` and ``distributed``
    namespaces that the port has (less ``pipeline_spmd``, the JAX
    package's scan primitive, and the datasets, which wait for ROADMAP
    A6.3)."""
    import paddle_tpu_torch.distributed as d
    import paddle_tpu_torch.parallel as p
    for name in ("AXIS_ORDER", "DeviceMesh", "get_mesh", "init_mesh",
                 "set_mesh", "DEFAULT_RULES", "LogicalRules",
                 "named_sharding", "replicate", "shard_batch",
                 "shard_params", "shard_spec", "shard_superbatch",
                 "with_logical_constraint", "AMPConfig",
                 "DistributedStrategy", "GradientMergeConfig",
                 "HybridConfig", "MoEConfig", "PipelineConfig",
                 "RecomputeConfig", "ShardingConfig", "DataParallel",
                 "all_gather", "all_reduce", "barrier", "broadcast",
                 "distributed_model", "get_rank", "get_world_size",
                 "init_parallel_env", "GradientMerge",
                 "RecomputeSequential", "recompute", "collective",
                 "LayerDesc", "PipelineLayer", "PipelineParallel",
                 "SharedLayerDesc", "ChipSpec", "Plan", "evaluate", "plan",
                 "build_local_sgd_step", "replicate_params",
                 "unreplicate_params", "planner"):
        assert hasattr(p, name), name
    for name in ("psum", "pmean", "pmax", "pmin", "all_gather",
                 "reduce_scatter", "all_to_all", "ppermute", "shift",
                 "axis_index", "axis_size", "broadcast", "host_all_reduce",
                 "quantized_ring_allreduce"):
        assert hasattr(p.collective, name), name
    for name in ("Group", "ParallelEnv", "ParallelMode", "ReduceOp",
                 "alltoall", "get_group", "gloo_barrier",
                 "gloo_init_parallel_env", "gloo_release", "irecv",
                 "is_initialized", "isend", "new_group", "recv", "reduce",
                 "reduce_scatter", "scatter", "send", "split", "wait",
                 "fleet", "fs", "launch", "elastic", "multinode",
                 "ElasticManager", "ElasticStatus", "Heartbeat",
                 "ProcessContext", "spawn", "FileRendezvous", "NodeAgent",
                 "TCPRendezvous", "init_parallel_env", "distributed_model",
                 "DataParallel", "shard_batch", "shard_params"):
        assert hasattr(d, name), name
    for name in ("init", "distributed_model", "distributed_optimizer",
                 "worker_index", "worker_num", "is_first_worker",
                 "barrier_worker", "get_strategy", "init_worker",
                 "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "utils"):
        assert hasattr(d.fleet, name), name


def test_models_and_data_import_without_optional_packages():
    """``models``, ``vision``, ``text`` and ``hub`` import where neither
    ``transformers`` nor PIL nor cv2 can be imported: each is reached only
    inside the function that needs it."""
    import subprocess
    import sys
    code = ("import sys\n"
            "for m in ('transformers', 'PIL', 'cv2'):\n"
            "    sys.modules[m] = None\n"
            "import paddle_tpu_torch as pt\n"
            "from paddle_tpu_torch import hub, models, text, vision\n"
            "import paddle_tpu_torch.vision.ops\n"
            "assert pt.vision is vision and pt.text is text\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
