"""The port's ``cost_model`` and ``hapi.summary.flops`` against the JAX
package's.

``flops`` counts layer by layer in both packages: equal integers for a
GPT and a ResNet-18. The port counts FLOPs of one eager run
(``FlopCounterMode``): a matmul's are ``2 m n k``, the probe GPT step of
``tests/test_perf_gate.py`` lands in its ``[1.0, 1.30]`` band of ``6 N T
+ 6 L s H T``, and the kernels' reports (``ops._kernels.report_cost``)
add what a ``ctypes`` launch hides from the dispatch mode. The fused
loss's ``memory_profile`` undercuts the dense head's by at least one f32
logits buffer (the invariant of ``tests/test_perf_gate.py:35``). The
cache classes run the JAX package's scenarios to equal results."""

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu import cost_model as jcm  # noqa: E402
from paddle_tpu_torch import cost_model as tcm  # noqa: E402
from paddle_tpu_torch.core import device as tdev  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.ops import _kernels  # noqa: E402


@pytest.fixture(autouse=True)
def _on_cpu():
    tpt.set_device("cpu")
    yield
    tdev.set_current(None)


def _gpt_cfg(m, **over):
    return m.models.gpt.gpt_config(
        "gpt2-small", num_layers=2, hidden_size=64, num_heads=4,
        vocab_size=128, max_position_embeddings=16, hidden_dropout=0.0,
        attention_dropout=0.0, **over)


def test_flops_gpt_equal_jax():
    jpt.seed(0)
    jnet = jpt.models.gpt.GPTForCausalLM(_gpt_cfg(jpt))
    tnet = tpt.models.gpt.GPTForCausalLM(_gpt_cfg(tpt), device="cpu")
    want = jpt.flops(jnet, (2, 16), dtypes=["int32"])
    got = tpt.flops(tnet, (2, 16), dtypes=["int64"])
    assert got == want and got > 0


def test_flops_resnet18_equal_jax():
    from paddle_tpu.nn import initializer as JI
    # a constant init: JAX's random init compiles a kernel a shape
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        jnet = jpt.models.resnet18(num_classes=10)
    finally:
        JI.set_global_initializer(None, None)
    tnet = tpt.models.resnet18(num_classes=10, device="cpu")
    want = jpt.flops(jnet, (1, 3, 32, 32))
    got = tpt.flops(tnet, (1, 3, 32, 32))
    assert got == want and got > 0


@pytest.mark.parametrize("m,n,k", [(64, 32, 16), (7, 5, 3), (128, 1, 96)])
def test_matmul_flops_are_2mnk(m, n, k):
    a, b = torch.randn(m, k), torch.randn(k, n)
    cost = tcm.CostModel().profile(lambda x, y: x @ y, (a, b))
    assert cost.flops == 2 * m * n * k
    assert cost.bytes_accessed == 4 * (m * k + k * n + m * n)
    assert cost.output_bytes == 4 * m * n and cost.optimal_seconds is None
    assert cost.measured_seconds is None


def test_probe_gpt_step_flops_ratio():
    """tests/test_perf_gate.py's probe step (h 128, L 4, s 256, b 8,
    vocab 512): FLOPs / (6 N T + 6 L s H T) within [1.0, 1.30]."""
    cfg = tpt.models.gpt.gpt_config(
        "gpt2-small", num_layers=4, hidden_size=128, num_heads=2,
        vocab_size=512, max_position_embeddings=256, hidden_dropout=0.0,
        attention_dropout=0.0)
    tpt.seed(0)
    net = tpt.models.gpt.GPTForCausalLM(cfg, device="cpu")
    model = tpt.Model(net)
    model.prepare(tpt.optimizer.AdamW(learning_rate=1e-4, parameters=net),
                  tpt.models.gpt.GPTPretrainingCriterion())
    ids = np.random.RandomState(0).randint(0, 512, (8, 256))
    cost = tcm.CostModel().profile_measure(
        lambda: model.train_batch([ids], [ids]), (), warmup=0, iters=1)
    n = sum(p.numel() for p in net.parameters())
    analytic = 6 * n * ids.size + 6 * 4 * 256 * 128 * ids.size
    assert 1.0 <= cost.flops / analytic <= 1.30, cost.flops / analytic
    assert cost.measured_seconds > 0 and cost.bytes_accessed > 0
    assert "flops: " not in cost.describe() and "GFLOP" in cost.describe()


def test_kernel_reports_reach_the_count():
    """A ctypes launch dispatches no aten op: its wrapper's report is
    what the count holds of it."""
    def step(x):
        _kernels.report_cost("flash_attention_fwd", 1000.0, 64.0)
        return x * 2

    cost = tcm.CostModel().profile(step, (torch.ones(4),))
    assert cost.flops == 1000.0
    assert cost.raw["kernel_launches"] == 1.0
    assert cost.bytes_accessed == 64.0 + 16 + 16
    assert _kernels.cost_sinks == []
    _kernels.report_cost("flash_attention_fwd", 1.0, 1.0)  # no sink: no-op


def test_flash_op_flops_formula_equals_twin_matmuls():
    """B1's registered op (what an exported program runs) counts the
    twin's two products."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.randn(2, 32, 4, 64)
    k = torch.randn(2, 48, 2, 64)
    op = tcm.CostModel().profile(
        lambda a, b, c: fa.flash_attention_fwd_op(a, b, c, 0.125, False),
        (q, k, k.clone()))
    twin = tcm.CostModel().profile(
        lambda a, b, c: fa.flash_attention_fwd_torch(a, b, c, 0.125, False),
        (q, k, k.clone()))
    assert op.flops == twin.flops == 2 * 2 * 2 * 4 * 32 * 48 * 64


def test_fused_loss_memory_under_dense_by_a_logits_buffer():
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.fused_xent import fused_linear_cross_entropy
    t, h, v = 512, 64, 8192
    g = torch.Generator().manual_seed(0)
    hid = (torch.randn(t, h, generator=g) * 0.1).requires_grad_()
    w = (torch.randn(v, h, generator=g) * 0.1).requires_grad_()
    lb = torch.randint(0, v, (t,), generator=g)

    def dense(a, b):
        return torch.autograd.grad(F.cross_entropy(a @ b.T, lb), (a, b))

    def fused(a, b):
        return torch.autograd.grad(
            fused_linear_cross_entropy(a, b, lb, -100, 1024), (a, b))

    md = tcm.memory_profile(dense, (hid, w))
    mf = tcm.memory_profile(fused, (hid, w))
    assert md.temp_bytes - mf.temp_bytes >= t * v * 4
    assert mf.temp_bytes < 0.5 * md.temp_bytes
    assert md.argument_bytes == (t * h + v * h) * 4
    assert md.output_bytes == md.argument_bytes
    assert md.device_peak_bytes is None            # no card here
    assert tcm.memory_profile_compiled(md) is md
    assert md.total_bytes == md.temp_bytes + 2 * md.argument_bytes


def test_live_bytes_release_on_free():
    def fn(x):
        for _ in range(4):
            y = x * 2            # 4 KiB each, freed on the next pass
            del y
        return x + 1

    mp = tcm.memory_profile(fn, (torch.ones(1024),))
    assert mp.temp_bytes == 4096          # one temporary live at a time
    assert mp.output_bytes == 4096


def _cache_scenario(mod):
    c = mod.ProgramCostCache(cap=2)
    calls = []

    class Fake:
        def __init__(self, flops):
            self.flops = flops

        def cost_analysis(self):
            return {"flops": self.flops, "name": "x"}

    def thunk(v):
        def f():
            calls.append(v)
            if v is None:
                raise RuntimeError("lowering failed")
            return Fake(v)
        return f

    out = [c.get_or_compute("a", thunk(1.0)),
           c.get_or_compute("a", thunk(2.0)),
           c.get_or_compute("b", thunk(None)),
           c.get_or_compute("b", thunk(3.0)),
           c.get_or_compute("c", thunk(4.0)),
           c.get("a"), len(c)]
    c.clear()
    return out, calls, len(c)


def test_program_cost_cache_equal_jax():
    assert _cache_scenario(tcm) == _cache_scenario(jcm)
    assert tcm.program_cost_cache() is tcm.program_cost_cache()


def test_extract_cost_analysis_shapes():
    class L:
        def __init__(self, v):
            self.v = v

        def cost_analysis(self):
            if isinstance(self.v, Exception):
                raise self.v
            return self.v

    for v in ([{"flops": 2, "s": "x"}], {"flops": 3}, [], None, {},
              {"s": "x"}, RuntimeError("absent")):
        assert tcm.extract_cost_analysis(L(v)) == \
            jcm.extract_cost_analysis(L(v))
    cost = tcm.ProgramCost(10.0, 20.0, 4.0, None, None)
    assert tcm.extract_cost_analysis(cost) == {
        "flops": 10.0, "bytes accessed": 20.0,
        "bytes accessed output": 4.0}


def test_collective_elements_counts_c10d_ops(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        def step(a, b):
            dist.all_reduce(a)
            dist.all_reduce(b)
            out = [torch.empty(6)]
            dist.all_gather(out, torch.ones(6))
            return a

        stats = tcm.collective_elements(step, (torch.ones(10),
                                               torch.ones(3, 4)))
    finally:
        dist.destroy_process_group()
    assert stats["all-reduce"] == tcm.CollectiveStats(2, 22)
    assert stats["all-gather"] == tcm.CollectiveStats(1, 6)


def test_gpt_reference_state_counts_the_same(tmp_path):
    """A JAX state loaded into the port counts the same FLOPs as the
    port's own init (the count reads shapes, never values)."""
    jpt.seed(0)
    jnet = jpt.models.gpt.GPTForCausalLM(_gpt_cfg(jpt))
    tnet = tpt.models.gpt.GPTForCausalLM(_gpt_cfg(tpt), device="cpu")
    before = tcm.CostModel().profile(tnet, (torch.zeros(2, 16,
                                                        dtype=torch.long),))
    load_reference_state(tnet, {k: np.asarray(v)
                                for k, v in jnet.state_dict().items()})
    after = tcm.CostModel().profile(tnet, (torch.zeros(2, 16,
                                                       dtype=torch.long),))
    assert before.flops == after.flops > 0
