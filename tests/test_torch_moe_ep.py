"""MoE layers on a live ``ep`` mesh axis: gloo CPU ranks of the port
(``tests/torch_nn_workers.py::moe_ep``) against the JAX package.

The JAX test ``tests/test_moe_recompute.py::test_moe_ep_sharded_runs_on_mesh``
runs a naive-gate ``MoELayer`` with its experts sharded over ``ep`` and
expects the unsharded numbers. Here the same layer, on the same seeded
weights and input, runs through ``Model.predict_batch`` on ``ep=2``,
``ep=4`` and ``dp=2 x ep=2`` (the last reached through a fleet strategy
whose ``moe`` degree is 2) and is held to the JAX package's unsharded
and ep-sharded outputs within 1e-5. ``moe_net`` (an embedding, a Switch
MoE layer and a head) then takes two AdamW ``train_batch`` steps on the
mesh and in one process of the port: every gradient the optimizer is
given (the gate's included, the experts' gathered over ep) and every
parameter after the steps within 1e-5, the losses within 1e-5 of each
other and of the JAX package's ``Model``. Each rank holds only its
experts; a save on the mesh reloads whole in one process."""

import functools

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import parallel as jpar  # noqa: E402
from paddle_tpu.nn.layer import functional_call, split_state  # noqa: E402
import torch_dist_workers as W  # noqa: E402
import torch_nn_workers as NW  # noqa: E402
from torch_nn_common import close, rand  # noqa: E402

TOL = 1e-5
JOBS = {"ep2": (2, False), "ep4": (4, False), "dp2xep2": (4, True)}


@functools.lru_cache(maxsize=None)
def _inputs():
    jpt.seed(0)
    layer = jpt.nn.MoELayer(8, 16, 4, gate="naive", capacity_factor=4.0)
    naive = {k: rand(*np.shape(v), seed=30 + i, scale=0.5) for i, (k, v)
             in enumerate(sorted(layer.state_dict().items()))}
    net = NW.moe_net(jpt.nn)
    moe_w = {k: rand(*np.shape(v), seed=20 + i, scale=0.5) for i, (k, v)
             in enumerate(sorted(net.state_dict().items()))}
    x = rand(4, 4, 8, seed=5)
    ids = np.random.RandomState(13).randint(0, 32, (4, 8))
    return naive, moe_w, x, ids


@functools.lru_cache(maxsize=None)
def _jax_naive():
    """The JAX layer's eval output unsharded and with its experts sharded
    over the JAX test's ``dp=2, ep=4`` mesh."""
    naive, _, x, _ = _inputs()
    layer = jpt.nn.MoELayer(8, 16, 4, gate="naive", capacity_factor=4.0)
    layer.set_state_dict({k: jnp.asarray(v) for k, v in naive.items()})
    layer.eval()
    ref = np.asarray(layer(jnp.asarray(x)))
    mesh = jpar.DeviceMesh(devices=jax.devices()[:8], dp=2, ep=4)
    params, buffers = split_state(layer)
    sharded = jpar.shard_params(params, layer.param_meta(), mesh,
                                jpar.LogicalRules())
    out, _ = functional_call(layer, sharded, buffers, jnp.asarray(x),
                             training=False)
    return ref, np.asarray(out)


@functools.lru_cache(maxsize=None)
def _jax_train_losses():
    _, moe_w, _, ids = _inputs()
    net = NW.moe_net(jpt.nn)
    net.set_state_dict({k: jnp.asarray(v) for k, v in moe_w.items()})
    m = jpt.Model(net)
    m.prepare(jpt.optimizer.AdamW(1e-3, parameters=net),
              jpt.nn.CrossEntropyLoss())
    return [float(m.train_batch([ids], [ids])["loss"]) for _ in range(2)]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    naive, moe_w, x, ids = _inputs()
    handles = {}
    for name, (world, dp) in JOBS.items():
        args = {"naive_weights": {k: v.tolist() for k, v in naive.items()},
                "moe_weights": {k: v.tolist() for k, v in moe_w.items()},
                "x": x.tolist(), "ids": ids.tolist(), "dp": dp}
        handles[name] = W.start_ranks(
            "moe_ep", world, tmp_path_factory.mktemp(name), args,
            script=NW.__file__)
    _jax_naive()   # the JAX side while the ranks run
    _jax_train_losses()
    return {name: W.collect(h) for name, h in handles.items()}


@pytest.mark.parametrize("job", list(JOBS))
def test_naive_layer_on_ep_mesh_gives_jax_unsharded_numbers(jobs, job):
    ref, sharded = _jax_naive()
    close(sharded, ref, TOL, "jax ep-sharded")
    for r in jobs[job]:
        close(r["naive_out"], ref, TOL, "port on the ep mesh")


@pytest.mark.parametrize("job", list(JOBS))
def test_ranks_hold_their_experts_only(jobs, job):
    world, dp = JOBS[job]
    ep = world // (2 if dp else 1)
    ranks = jobs[job]
    assert [r["ep_index"] for r in ranks] == [i % ep for i in range(world)]
    assert ranks[0]["mesh_repr"] == (
        f"DeviceMesh({{'dp': 2, 'ep': {ep}}}, 4 devices)" if dp
        else f"DeviceMesh({{'ep': {ep}}}, {world} devices)")
    assert ranks[0]["data_axes"] == (("dp",) if dp else ())
    n = 4 // ep
    total = ep * (ep + 1) / 2           # reduce_from_ep of index + 1
    for r in ranks:
        assert r["ep_sum"] == ([total] * 3, [1.0] * 3)
        assert r["expert_shapes"] == {"w_in": (n, 8, 16), "b_in": (n, 16),
                                      "w_out": (n, 16, 8), "b_out": (n, 8)}


@pytest.mark.parametrize("job", list(JOBS))
def test_two_adamw_steps_match_one_process_on_every_gradient(jobs, job):
    want = _jax_train_losses()
    for r in jobs[job]:
        (mesh_l, mesh_g, mesh_s), (one_l, one_g, one_s) = r["mesh"], r["one"]
        np.testing.assert_allclose(one_l, want, rtol=TOL)
        np.testing.assert_allclose(mesh_l, one_l, rtol=TOL)
        assert len(mesh_g) == len(one_g) == 2
        for step, (got, exp) in enumerate(zip(mesh_g, one_g)):
            assert set(got) == set(exp)
            assert "moe.gate.weight" in got
            for k, v in exp.items():
                close(got[k], v, TOL, f"step {step} grad {k}")
        for k, v in one_s.items():
            close(mesh_s[k], v, TOL, k)
    first = jobs[job][0]["mesh"]
    for r in jobs[job][1:]:
        assert r["mesh"][0] == first[0]
        for k, v in first[2].items():
            np.testing.assert_array_equal(r["mesh"][2][k], v)


@pytest.mark.parametrize("job", list(JOBS))
def test_save_on_ep_mesh_reloads_whole_in_one_process(jobs, job):
    r0 = jobs[job][0]
    for k, v in r0["mesh"][2].items():
        np.testing.assert_array_equal(r0["reloaded"][k], v)
