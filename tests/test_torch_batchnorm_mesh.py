"""BatchNorm under a data-parallel mesh: two gloo CPU ranks of the port
(``tests/torch_nn_workers.py``), each holding half of the global batch,
against one JAX process on the whole batch. Under GSPMD the JAX
package's BatchNorm normalises over the global batch; the port's sums
the per-channel count, sum and centred sum of squares over the data
ranks (``parallel.collective.data_rows``), so the ranks' output rows,
the running statistics and one SGD ``train_batch`` step equal one
process's. Tolerance 1e-5 (float32; the ranks' partial sums add in
another order); the two ranks' states equal each other exactly. An MoE
model (the Switch gate) trains on the same mesh, equal to one process
of the port within 1e-5."""

import functools

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import torch_dist_workers as W  # noqa: E402
import torch_nn_workers as NW  # noqa: E402
from torch_nn_common import close, rand  # noqa: E402

TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _inputs():
    jpt.seed(0)
    net = NW.bn_net(jpt.nn)
    weights = {k: np.asarray(v) for k, v in net.state_dict().items()}
    weights.update({k: rand(*v.shape, seed=i, scale=0.5)
                    for i, (k, v) in enumerate(sorted(weights.items()))
                    if not k.startswith("1._")})
    moe = NW.moe_net(jpt.nn)
    moe_w = {k: rand(*np.shape(v), seed=20 + i, scale=0.5) for i, (k, v)
             in enumerate(sorted(moe.state_dict().items()))}
    x = rand(8, 3, 6, 6, seed=11, scale=2) + 1
    y = np.random.RandomState(12).randint(0, 3, (8,))
    ids = np.random.RandomState(13).randint(0, 32, (4, 8))
    return weights, moe_w, x, y, ids


@functools.lru_cache(maxsize=None)
def _jax():
    weights, _, x, y, _ = _inputs()
    net = NW.bn_net(jpt.nn)
    net.set_state_dict({k: jnp.asarray(v) for k, v in weights.items()})
    out = np.asarray(net(jnp.asarray(x)))
    fwd = {k: np.asarray(v) for k, v in net.state_dict().items()}
    net.set_state_dict({k: jnp.asarray(v) for k, v in weights.items()})
    m = jpt.Model(net)
    m.prepare(jpt.optimizer.SGD(0.1, parameters=net),
              jpt.nn.CrossEntropyLoss())
    loss = float(m.train_batch([x], [y])["loss"])
    m.sync_weights()
    return out, fwd, loss, {k: np.asarray(v) for k, v in
                            net.state_dict().items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    weights, moe_w, x, y, ids = _inputs()
    args = {"weights": {k: v.tolist() for k, v in weights.items()},
            "moe_weights": {k: v.tolist() for k, v in moe_w.items()},
            "x": x.tolist(), "y": y.tolist(), "ids": ids.tolist()}
    handle = W.start_ranks("bn_dp", 2, tmp_path_factory.mktemp("bn_dp"),
                           args, script=NW.__file__)
    _jax()   # the JAX side while the ranks run
    return W.collect(handle)


def test_output_rows_and_running_stats_equal_one_jax_process(ranks):
    out, fwd, _, _ = _jax()
    close(np.concatenate([r["out_rows"] for r in ranks]), out, TOL)
    for r in ranks:
        for k in ("1._mean", "1._variance"):
            close(r["fwd_state"][k], fwd[k], TOL, k)
    for k, v in ranks[0]["fwd_state"].items():
        np.testing.assert_array_equal(ranks[1]["fwd_state"][k], v)


def test_train_batch_equals_one_jax_process(ranks):
    _, _, loss, after = _jax()
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=TOL)
        for k, v in after.items():
            close(r["step_state"][k], v, TOL, k)
    for k, v in ranks[0]["step_state"].items():
        np.testing.assert_array_equal(ranks[1]["step_state"][k], v)


def test_moe_trains_on_a_dp_mesh_as_in_one_process(ranks):
    for r in ranks:
        (mesh_l, mesh_s), (one_l, one_s) = r["moe"]["mesh"], r["moe"]["one"]
        np.testing.assert_allclose(mesh_l, one_l, rtol=TOL)
        for k, v in one_s.items():
            close(mesh_s[k], v, TOL, k)
