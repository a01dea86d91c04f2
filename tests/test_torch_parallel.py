"""The port's ``parallel`` package against the JAX package's
(``tests/test_parallel.py``'s counterparts): mesh construction, the
logical sharding rules, the strategy, batch splitting, the mesh context,
the stacked host collectives, and every collective of
``parallel.collective`` over 2 and 4 gloo CPU ranks, each rank's result
equal to its device's block of the JAX function under ``shard_map`` on
the virtual CPU mesh."""

import functools

import numpy as np
import pytest
import torch
from torch_gc_barrier import collect_cycles  # noqa: F401

import torch_dist_workers as W

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from paddle_tpu import parallel as jpar  # noqa: E402
from paddle_tpu.parallel import collective as jcoll  # noqa: E402
from paddle_tpu_torch import parallel as tpar  # noqa: E402
from paddle_tpu_torch.parallel import collective as tcoll  # noqa: E402


# ---------------------------------------------------------------------------
# mesh (test_parallel.py:26-45)
# ---------------------------------------------------------------------------

def test_mesh_construction_and_wildcard():
    m = tpar.DeviceMesh(devices=8, dp=2, tp=-1)
    j = jpar.DeviceMesh(devices=jax.devices()[:8], dp=2, tp=-1)
    assert m.axis_sizes == j.axis_sizes
    assert m.axis_names == j.axis_names == ("dp", "tp")
    assert m.shape == (2, 4) and m.size == 8
    assert m.axis_size("tp") == 4 and m.axis_size("pp") == 1
    assert m.has_axis("dp") and not m.has_axis("fsdp")
    assert m.data_axes == j.data_axes == ("dp",)
    assert m.mesh is None   # no process group here: a layout only
    one = tpar.DeviceMesh(devices=1)
    assert one.axis_names == ("dp",) and one.data_size == 1
    assert repr(tpar.DeviceMesh(devices=4, fsdp=4)) == \
        repr(jpar.DeviceMesh(devices=jax.devices()[:4], fsdp=4))


@pytest.mark.parametrize("axes, msg", [
    (dict(dp=3), "needs 3 devices"),
    (dict(dp=-1, tp=-1), "only one axis"),
    (dict(bogus=2), "unknown mesh axes"),
    (dict(dp=3, tp=-1), "not divisible")])
def test_mesh_errors(axes, msg):
    with pytest.raises(ValueError, match=msg):
        tpar.DeviceMesh(devices=8 if "tp" in axes else 2, **axes)
    with pytest.raises(ValueError, match=msg):
        jpar.DeviceMesh(devices=jax.devices()[:8 if "tp" in axes else 2],
                        **axes)


def test_mesh_context_restores_previous():
    tpar.set_mesh(None)
    outer = tpar.init_mesh(devices=2, dp=2)
    inner = tpar.DeviceMesh(devices=4, fsdp=4)
    with inner as m:
        assert tpar.get_mesh() is m is inner
    assert tpar.get_mesh() is outer
    tpar.set_mesh(None)
    assert tpar.get_mesh(required=False) is None
    with pytest.raises(RuntimeError, match="no DeviceMesh"):
        tpar.get_mesh()


# ---------------------------------------------------------------------------
# rules (test_parallel.py:47): the same axes as the JAX package
# ---------------------------------------------------------------------------

RULE_CASES = [
    (dict(fsdp=8), ("embed", "mlp"), (32, 128)),
    (dict(fsdp=8), ("mlp", "embed"), (128, 32)),
    (dict(fsdp=8), ("vocab", "embed"), (64, 32)),
    (dict(fsdp=8), (None, "embed"), (16, 32)),
    (dict(fsdp=8), ("heads",), (96,)),
    (dict(dp=8), ("embed", "mlp"), (32, 128)),
    (dict(dp=2, fsdp=4), ("batch", None), (8, 16)),
    (dict(dp=2, fsdp=4), ("batch", None), (6, 16)),
    (dict(dp=2, tp=4), ("embed", "mlp"), (32, 128)),
    (dict(dp=2, tp=4), ("vocab", "embed"), (64, 32)),
    (dict(dp=2, tp=4), ("heads", "embed"), (32, 32)),
    (dict(fsdp=2, tp=4), ("embed", "heads"), (32, 96)),
    (dict(fsdp=2, tp=4), ("mlp", "embed"), (130, 32)),
    (dict(tp=8), ("embed", "heads"), (32, 12)),
]


@pytest.mark.parametrize("axes, logical, shape", RULE_CASES,
                         ids=[f"{a}-{l}-{s}" for a, l, s in RULE_CASES])
def test_rules_resolve_like_jax(axes, logical, shape):
    n = int(np.prod(list(axes.values())))
    tm = tpar.DeviceMesh(devices=n, **axes)
    jm = jpar.DeviceMesh(devices=jax.devices()[:n], **axes)
    got = tpar.LogicalRules().mesh_axes(logical, shape, tm)
    want = tuple(jpar.LogicalRules().mesh_axes(logical, shape, jm))
    assert got == want


def test_gpt_param_meta_matches_jax():
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.models import gpt as tgpt
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
              max_position_embeddings=16, use_flash=False)
    for tie in (True, False):
        tnet = tgpt.GPTForCausalLM(tgpt.GPTConfig(tie_word_embeddings=tie,
                                                  **kw), device="cpu")
        jnet = jgpt.GPTForCausalLM(jgpt.GPTConfig(tie_word_embeddings=tie,
                                                  **kw))
        tm, jm = tnet.param_meta(), jnet.param_meta()
        assert set(tm) == set(jm)
        for k in tm:
            assert tm[k].axes == (tuple(jm[k].axes) if jm[k].axes
                                  is not None else None), k
            assert tm[k].trainable == jm[k].trainable


def test_shard_spec_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = tpar.DeviceMesh(devices=4, dp=2, fsdp=2)
    meta = {"w": type("M", (), {"axes": ("embed", "mlp")})(),
            "b": type("M", (), {"axes": ("mlp",)})()}
    assert tpar.shard_spec("w", (32, 128), meta, m) == [Replicate(),
                                                         Shard(0)]
    assert tpar.shard_spec("b", (128,), meta, m) == [Replicate(),
                                                      Replicate()]
    assert tpar.shard_spec("x", (4,), meta, m) == [Replicate(),
                                                    Replicate()]


# ---------------------------------------------------------------------------
# strategy round trip (test_parallel.py:104)
# ---------------------------------------------------------------------------

def test_strategy_round_trip_and_axes():
    from paddle_tpu.parallel import strategy as js
    from paddle_tpu_torch.parallel import strategy as ts
    for kw in ({}, {"sharding": dict(enable=True, degree=4)},
               {"hybrid_configs": dict(dp_degree=2, mp_degree=4)},
               {"pipeline": dict(enable=True, degree=2, micro_batches=4),
                "amp": dict(enable=True, custom_white_list=["matmul"])}):
        t = ts.DistributedStrategy.from_dict(
            ts.DistributedStrategy().to_dict() | kw)
        j = js.DistributedStrategy.from_dict(
            js.DistributedStrategy().to_dict() | kw)
        assert t.to_dict() == j.to_dict()
        assert t.mesh_axes() == j.mesh_axes()
        assert ts.DistributedStrategy.from_dict(t.to_dict()) == t
        assert t.to_json() == j.to_json()


# ---------------------------------------------------------------------------
# batches (test_parallel.py:179)
# ---------------------------------------------------------------------------

def test_shard_batch_rows_and_partial_replication():
    m = tpar.DeviceMesh(devices=2, dp=2)   # rank 0 of a layout
    x = np.arange(8 * 3).reshape(8, 3)
    got = tpar.shard_batch({"x": x, "s": 5, "name": "a", "t":
                            torch.arange(8)}, m)
    np.testing.assert_array_equal(got["x"], x[:4])
    assert torch.equal(got["t"], torch.arange(4))
    assert got["s"] == 5 and got["name"] == "a"
    partial = tpar.shard_batch([x[:5]], m)[0]
    np.testing.assert_array_equal(partial, x[:5])   # replicated
    sb = np.arange(2 * 8).reshape(2, 8)
    np.testing.assert_array_equal(tpar.shard_superbatch(sb, m), sb[:, :4])
    np.testing.assert_array_equal(tpar.shard_superbatch(sb[:, :5], m),
                                  sb[:, :5])
    one = tpar.DeviceMesh(devices=1)
    np.testing.assert_array_equal(tpar.shard_batch(x, one), x)


def test_with_logical_constraint_is_identity_without_tp():
    """An identity wherever a rank's activations already have the layout
    (dp, tp); on a live sp axis a ``seq`` dim is this rank's slice of the
    sequence (a layout mesh of four sp ranks: this process is rank 0),
    unless the rules map no dim to sp, and a sequence that does not
    divide raises the JAX package's error."""
    x = torch.randn(4, 8)
    for m in (tpar.DeviceMesh(devices=2, dp=2),
              tpar.DeviceMesh(devices=2, tp=2)):
        assert tpar.with_logical_constraint(x, ("batch", "mlp"), m) is x
    sp = tpar.DeviceMesh(devices=4, sp=4)
    assert torch.equal(tpar.with_logical_constraint(x, (None, "seq"), sp),
                       x[:, :2])
    assert tpar.with_logical_constraint(x, ("batch", "mlp"), sp) is x
    no_seq = tpar.LogicalRules([r for r in tpar.DEFAULT_RULES
                                if r != ("seq", "sp")])
    assert tpar.with_logical_constraint(x, (None, "seq"), sp,
                                        no_seq) is x
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        tpar.with_logical_constraint(torch.randn(4, 6), (None, "seq"), sp)


@pytest.mark.parametrize("axis, item", [("sp", None), ("ep", "A7.1")])
def test_sp_and_ep_still_raise_naming_their_items(axis, item):
    """tp and pp run (tests/test_torch_tensor_parallel.py,
    test_torch_pipeline.py, test_torch_planner.py); a live sp axis runs
    the sequence-parallel GPT (tests/test_torch_ring_attention.py) and
    refuses a network that does not slice the sequence; a live ep axis
    raises at distributed_model, naming the ROADMAP item it waits for."""
    from paddle_tpu_torch.hapi.model import Model
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import Linear
    mesh = tpar.DeviceMesh(devices=2, **{axis: 2})
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"'{axis}'.*{item}"):
            tpar.distributed_model(Model(Linear(4, 4)), mesh=mesh)
        return
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        tpar.distributed_model(Model(Linear(4, 4)), mesh=mesh)
    net = GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=32,
                                   num_layers=1, num_heads=4,
                                   max_position_embeddings=16,
                                   sequence_parallel=True), device="cpu")
    m = tpar.distributed_model(Model(net), mesh=mesh)
    assert m._mesh.axis_size("sp") == 2


# ---------------------------------------------------------------------------
# host collectives on stacked arrays (test_parallel.py:95, :194)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "mean"])
def test_host_all_reduce_matches_jax(op):
    x = W.stacked_input(4)
    np.testing.assert_allclose(
        tpar.all_reduce(torch.from_numpy(x), op).numpy(),
        np.asarray(jpar.all_reduce(jnp.asarray(x), op)), rtol=1e-6)


def test_host_broadcast_matches_jax():
    x = W.stacked_input(4)
    np.testing.assert_array_equal(
        tpar.broadcast(torch.from_numpy(x), src=2).numpy(),
        np.asarray(jpar.broadcast(jnp.asarray(x), src=2)))
    with pytest.raises(ValueError):
        tcoll.host_all_reduce(x, "bogus")


# ---------------------------------------------------------------------------
# collectives by mesh axis over gloo ranks against shard_map
# ---------------------------------------------------------------------------

def _jax_ops(n):
    perm = [(i, (i + 1) % n) for i in range(n - 1)]
    return {
        "psum": lambda x: jcoll.psum(x, "dp"),
        "pmean": lambda x: jcoll.pmean(x, "dp"),
        "pmax": lambda x: jcoll.pmax(x, "dp"),
        "pmin": lambda x: jcoll.pmin(x, "dp"),
        "all_gather": lambda x: jcoll.all_gather(x, "dp"),
        "all_gather_untiled": lambda x: jcoll.all_gather(x, "dp",
                                                         tiled=False),
        "all_gather_dim1": lambda x: jcoll.all_gather(x, "dp",
                                                      gather_dim=1),
        "reduce_scatter": lambda x: jcoll.reduce_scatter(x, "dp"),
        "reduce_scatter_dim1": lambda x: jcoll.reduce_scatter(
            jnp.concatenate([x] * n, axis=1), "dp", scatter_dim=1),
        "all_to_all": lambda x: jcoll.all_to_all(x, "dp", split_dim=0,
                                                 concat_dim=1),
        "ppermute": lambda x: jcoll.ppermute(x, "dp", perm),
        "shift": lambda x: jcoll.shift(x, "dp"),
        "shift_back": lambda x: jcoll.shift(x, "dp", -1),
        "axis_index": lambda x: jnp.reshape(jcoll.axis_index("dp"), (1,)),
        "axis_size": lambda x: jnp.reshape(jcoll.axis_size("dp"), (1,)),
        "broadcast": lambda x: jcoll.broadcast(x, "dp", src=n - 1),
        "quantized_ring_allreduce": lambda x:
            jcoll.quantized_ring_allreduce(x, "dp"),
        "quantized_ring_allreduce_4bit": lambda x:
            jcoll.quantized_ring_allreduce(x, "dp", bits=4),
    }


@functools.lru_cache(maxsize=None)
def _jax_results(n):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("dp",))
    x = W.stacked_input(n)
    g = jnp.asarray(x.reshape(n * x.shape[1], x.shape[2]))
    out = {}
    for name, f in _jax_ops(n).items():
        y = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("dp"),
                                  out_specs=P("dp")))(g)
        out[name] = np.split(np.asarray(y), n, axis=0)
    return out


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    handles = {n: W.start_ranks("collectives", n,
                                tmp_path_factory.mktemp(f"coll{n}"))
               for n in (2, 4)}
    return {n: W.collect(h, timeout=180) for n, h in handles.items()}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", list(_jax_ops(2)))
def test_collective_matches_jax(port_results, op, n):
    want = _jax_results(n)[op]
    # data movement is exact; a sum over 4 ranks may add in another
    # order than XLA's (last-ulp differences), as may the quantized
    # ring's dequantize-and-add
    summed = op in ("psum", "pmean", "reduce_scatter",
                    "reduce_scatter_dim1") or op.startswith("quantized")
    for r in range(n):
        got = port_results[n][r][op]
        if not summed:
            np.testing.assert_array_equal(got, want[r].astype(got.dtype),
                                          err_msg=f"{op} rank {r}")
        else:
            np.testing.assert_allclose(got, want[r], rtol=1e-6,
                                       atol=2e-6, err_msg=f"{op} rank {r}")
