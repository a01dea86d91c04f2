"""The port's auto-parallel planner against the JAX package's
(``tests/test_planner.py``'s counterparts): the same plan for the same
net, rank count, batch and ``ChipSpec`` fields (read from the JAX
object), ``evaluate``'s numbers and breakdown, shape-only models on the
meta device, the H100 defaults, ``distributed_model(global_batch=)``
planning and training on two gloo ranks, and ``verify_plan`` re-planning
a Model already split over the planner's mesh against the JAX
package's re-plan."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch
from torch_gc_barrier import collect_cycles  # noqa: F401

import torch_dist_workers as W
import torch_mp_reference as R
import torch_mp_workers as MW

from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.parallel import planner as jplan  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.parallel import planner as tplan  # noqa: E402

_GiB = float(1 << 30)


@pytest.fixture(scope="module")
def nets():
    """gpt3-1.3b shape-only in both packages, and a small GPT."""
    import paddle_tpu as pt
    import paddle_tpu_torch as ptt
    small = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                 max_position_embeddings=32, use_flash=False)
    big = (jplan.abstract_model(
        lambda: jgpt.GPTForCausalLM(jgpt.gpt_config("gpt3-1.3b"))),
        tplan.abstract_model(lambda: tgpt.GPTForCausalLM(
            tgpt.gpt_config("gpt3-1.3b"), device="meta")))
    # a fresh key stream: the shape-only construction drew keys inside
    # jax.eval_shape
    pt.seed(0)
    ptt.seed(0)
    return {"1p3b": big,
            "small": (jgpt.GPTForCausalLM(jgpt.GPTConfig(**small)),
                      tgpt.GPTForCausalLM(tgpt.GPTConfig(**small),
                                          device="cpu"))}


def _chip(**over):
    """Both packages' ChipSpec on the JAX object's fields."""
    j = dataclasses.replace(jplan.ChipSpec(), **over)
    return j, tplan.ChipSpec(**dataclasses.asdict(j))


def test_abstract_model_holds_no_values(nets):
    t = nets["1p3b"][1]
    assert all(p.device.type == "meta" for p in t.parameters())
    assert sum(p.numel() for p in t.parameters()) > 1.3e9


@pytest.mark.parametrize("net, n, batch, seq, over", [
    ("1p3b", 8, 64, 2048, {}),
    ("1p3b", 8, 4, 2048, {}),
    ("1p3b", 8, 64, None, {}),
    ("1p3b", 4, 32, 2048, {"hbm_bytes": 80e9}),
    ("1p3b", 16, 64, 2048, {"ici_bytes_per_s": 900e9}),
    ("small", 8, 32, 32, {}),
    ("small", 2, 8, 32, {"peak_flops": 989.4e12})])
def test_plan_matches_jax(nets, net, n, batch, seq, over):
    jnet, tnet = nets[net]
    jchip, tchip = _chip(**over)
    jbest, jall = jplan.plan(jnet, n, batch, seq_len=seq, chip=jchip,
                             return_all=True)
    tbest, tall = tplan.plan(tnet, n, batch, seq_len=seq, chip=tchip,
                             return_all=True)
    assert tbest.axes == jbest.axes and tbest.fits == jbest.fits
    assert [p.axes for p in tall] == [p.axes for p in jall]
    for a, b in zip(tall, jall):
        np.testing.assert_allclose(
            [a.hbm_bytes, a.step_time_s, a.comm_time_s],
            [b.hbm_bytes, b.step_time_s, b.comm_time_s], rtol=1e-9)


def test_evaluate_breakdown_sums_to_total(nets):
    jnet, tnet = nets["1p3b"]
    jchip, tchip = _chip()
    t = tplan.evaluate(tnet, {"fsdp": 4, "tp": 2}, global_batch=64,
                       seq_len=2048, chip=tchip)
    j = jplan.evaluate(jnet, {"fsdp": 4, "tp": 2}, global_batch=64,
                       seq_len=2048, chip=jchip)
    parts = sum(t.breakdown[k] for k in ("params", "grads", "opt_state",
                                         "activations"))
    np.testing.assert_allclose(t.hbm_bytes, parts, rtol=1e-9)
    assert t.breakdown.keys() == j.breakdown.keys()
    for k, v in j.breakdown.items():
        np.testing.assert_allclose(t.breakdown[k], v, rtol=1e-9, err_msg=k)
    assert t.breakdown["params"] < 2.0 * _GiB    # fsdp shards the bulk


def test_h100_defaults(nets):
    """The port plans for one H100 SXM (NVIDIA's datasheet): 80 GB of
    HBM3, 989.4 TFLOP/s dense bf16, NVLink 4's 450 GB/s a direction, a
    700 W power limit; gpt3-1.3b under pure dp on 8 such cards fits,
    where it does not on the JAX package's 16 GiB default."""
    c = tplan.ChipSpec()
    assert (c.hbm_bytes, c.peak_flops, c.ici_bytes_per_s,
            c.power_limit_w) == (80e9, 989.4e12, 450e9, 700.0)
    jnet, tnet = nets["1p3b"]
    assert tplan.evaluate(tnet, {"dp": 8}, 64, 2048).fits
    assert not jplan.evaluate(jnet, {"dp": 8}, 64, 2048).fits


def test_strategy_and_global_batch_conflict():
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.hapi.model import Model
    with pytest.raises(ValueError, match="not both"):
        parallel.distributed_model(
            Model(torch.nn.Linear(2, 2)),
            strategy=parallel.DistributedStrategy(), global_batch=16)


def test_measured_step_bytes_needs_a_card(nets):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the measurement would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplan.measured_step_bytes(None, [], [])


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    d = tmp_path_factory.mktemp("planner")
    with open(d / "w.pkl", "wb") as f:
        pickle.dump(R.weights(layers=2), f)
    return W.collect(W.start_ranks(
        "planner2", 2, d / "two",
        {"weights": str(d / "w.pkl"), "ids": R.ids().tolist()},
        script=MW.__file__), timeout=300)


def test_distributed_model_plans_the_mesh_on_two_ranks(planned):
    """distributed_model(global_batch=4) on two ranks: the plan this
    process makes for the same net and rank count, installed as the
    Model's mesh, and two steps equal on both ranks."""
    net = MW.dense_net(R.weights(layers=2), layers=2)
    want = tplan.plan(net, 2, 4, seq_len=16)
    r0, r1 = planned
    for r in (r0, r1):
        assert r["axes"] == want.axes and r["fits"]
        assert {k: v for k, v in r["mesh"].items() if v > 1} == \
            {k: v for k, v in want.axes.items() if v > 1}
        assert all(np.isfinite(r["losses"]))
    assert r0["losses"] == r1["losses"]


REPLAN_RATIO = 8.0


def _replan_chip():
    """A ChipSpec (the port's H100 fields) whose budget, at the measured
    REPLAN_RATIO, holds fsdp=2 and not the first plan's tp=2."""
    net = MW.dense_net(R.weights(layers=2), layers=2)
    base = tplan.ChipSpec()
    _, cands = tplan.plan(net, 2, 4, seq_len=16, return_all=True,
                          hbm_scale=REPLAN_RATIO)
    by = {tuple(sorted(c.axes.items())): c.hbm_bytes for c in cands}
    lo = by[(("dp", 1), ("fsdp", 2), ("tp", 1))]
    hi = by[(("dp", 1), ("fsdp", 1), ("tp", 2))]
    assert lo < hi
    return dataclasses.replace(
        base, hbm_bytes=(lo + hi) / 2 / base.hbm_headroom)


@pytest.fixture(scope="module")
def replanned(tmp_path_factory):
    d = tmp_path_factory.mktemp("replan")
    with open(d / "w.pkl", "wb") as f:
        pickle.dump(R.weights(layers=2), f)
    chip = dataclasses.asdict(_replan_chip())
    handle = W.start_ranks(
        "replan2", 2, d / "two",
        {"weights": str(d / "w.pkl"), "ids": R.ids(n=3).tolist(),
         "ratio": REPLAN_RATIO, "chip": chip}, script=MW.__file__)
    first = tplan.plan(MW.dense_net(R.weights(layers=2), layers=2), 2, 4,
                       seq_len=16)
    jax_side = R.replan(REPLAN_RATIO, tuple(sorted(chip.items())),
                        tuple(sorted(dataclasses.asdict(
                            tplan.ChipSpec()).items())),
                        tuple(sorted(first.axes.items())))
    return W.collect(handle, timeout=300), jax_side


def test_verify_plan_replans_a_model_split_over_a_mesh(replanned):
    """A Model split over the planner's tp=2 mesh, whose measured step is
    8x the prediction, re-plans as the JAX package does (the same new
    axes and report), gathers its whole state, drops the optimizer
    state and goes on over fsdp=2: the three losses and the trained
    state agree with the JAX re-plan's, the ranks bit for bit."""
    ranks, (losses, axes, installed, report, state) = replanned
    assert installed == [axes]
    for r in ranks:
        assert r["first_axes"] == {"dp": 1, "fsdp": 1, "tp": 2}
        assert r["axes"] == axes and axes["fsdp"] == 2
        assert r["mesh"] == {"fsdp": 2}
        assert r["sharded"]   # the state is split over the new mesh
        assert {k: r["report"][k] for k in ("replanned", "new_axes")} == \
            {k: report[k] for k in ("replanned", "new_axes")}
        np.testing.assert_allclose(r["report"]["ratio"], report["ratio"],
                                   rtol=1e-6)
        np.testing.assert_allclose(r["losses"], losses, rtol=2e-4,
                                   atol=2e-5)
        for k, v in state.items():
            np.testing.assert_allclose(r["state"][k], v, rtol=2e-4,
                                       atol=2e-5, err_msg=k)
    assert ranks[0]["losses"] == ranks[1]["losses"]
