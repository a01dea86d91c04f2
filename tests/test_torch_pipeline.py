"""Pipeline parallelism and LocalSGD of the port on gloo CPU ranks
against the JAX package on the virtual CPU devices.

``GPTForCausalLMPipe`` (the tiny GPT of ``tests/torch_mp_workers.py``, 4
layers: 2 a chunk at ``virtual_pp_degree`` 1, 1 at 2, so both stacked
layouts) on two ranks of a pp=2 mesh against the JAX package's pipe on
its pp=2 mesh, at 1, 2 and 4 microbatches and v 1 and 2: the losses and
the trained (gathered) state within 2e-4, dropout 0.1 drawing the JAX
package's tick keys, the ranks bit for bit; ``Model.save`` on the mesh
loading into one process and the JAX package; a resumed fit; predict /
evaluate rows; the JAX package's rejection cases raising alike;
``load_flat_state_dict``; LocalSGD over dp=2 against synchronous SGD
(``sync_every=1``) and the JAX averages (``sync_every=4``). The pp=2 x
tp=2 mesh is in ``tests/test_torch_tensor_parallel.py``."""

import os
import pickle

import numpy as np
import pytest
import torch
from torch_gc_barrier import collect_cycles  # noqa: F401

import torch_dist_workers as W
import torch_mp_reference as R
import torch_mp_workers as MW

WORKERS = MW.__file__
RTOL, ATOL = 2e-4, 2e-5
PP2 = (("pp", 2),)
DPPP = (("pp", 2), ("dp", 2))


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def _lsgd_data():
    r = np.random.RandomState(0)
    params = {"w1": (r.randn(8, 16) * 0.3).astype(np.float32),
              "w2": (r.randn(16, 4) * 0.3).astype(np.float32)}
    r = np.random.RandomState(2)
    return params, r.randn(16, 8).astype(np.float32), \
        r.randn(16, 4).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    p, x, y = _lsgd_data()
    args = {"weights_v1": _dump(d / "w1.pkl", R.weights(pipe_v=1)),
            "weights_v2": _dump(d / "w2.pkl", R.weights(pipe_v=2)),
            "ids": R.ids().tolist(),
            "lsgd_params": {k: v.tolist() for k, v in p.items()},
            "lsgd_x": x.tolist(), "lsgd_y": y.tolist()}
    two = W.start_ranks("pp2", 2, d / "two", args, script=WORKERS)
    four = W.start_ranks("dppp", 4, d / "four", args, script=WORKERS)
    jax_side = {(m, v, p_): R.run(PP2, p_, pipe=(m, v))
                for m, v, p_ in MW.PP_RUNS}
    jax_side["dppp"] = R.run(DPPP, MW.DPPP_DROPOUT, pipe=(2, 1))
    jax_side["lsgd"] = _jax_local_sgd()
    return {"two": W.collect(two, timeout=400),
            "four": W.collect(four, timeout=400), "jax": jax_side,
            "dir": d / "two"}


def _close(got, want, msg):
    assert sorted(got) == sorted(want), msg
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{msg}: {k}")


@pytest.mark.parametrize("m, v, dropout", MW.PP_RUNS)
def test_pp2_losses_and_state_match_jax(runs, m, v, dropout):
    """Forward and gradients of the pipelined trunk: the losses of two
    steps and the state they train, against the JAX pipe; at dropout
    0.1 every chunk's masks come from ``fold_in(base_key, tick)``."""
    losses, state = runs["jax"][(m, v, dropout)]
    for r in runs["two"]:
        got_losses, got_state = r[(m, v, dropout)]
        np.testing.assert_allclose(got_losses, losses, rtol=RTOL, atol=ATOL)
        _close(got_state, state, f"pp=2 m {m} v {v} dropout {dropout}")
    if dropout:
        assert losses != runs["jax"][(2, 2, 0.0)][0]   # the masks acted


def test_dp2_pp2_dropout_draws_the_jax_rows(runs):
    """dp=2 x pp=2 at dropout 0.1: each data rank holds its slice of each
    microbatch (the JAX package shards the microbatches over dp), so
    its chunks draw those rows of the JAX masks: the losses and the
    trained state agree, every rank's equal; predictions come back in
    the global batch's row order."""
    losses, state = runs["jax"]["dppp"]
    for r in runs["four"]:
        np.testing.assert_allclose(r["losses"], losses, rtol=RTOL,
                                   atol=ATOL)
        _close(r["state"], state, "dp=2 x pp=2 dropout 0.1")
        assert r["losses"] == runs["four"][0]["losses"]
    net = _one_process_pipe(state)
    net.eval()
    with torch.no_grad():
        want = net(torch.from_numpy(np.asarray(R.ids()[0]))).numpy()
    for r in runs["four"]:
        np.testing.assert_allclose(r["predict"], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m, v, dropout", MW.PP_RUNS)
def test_pp_ranks_agree_bit_for_bit(runs, m, v, dropout):
    (l0, s0), (l1, s1) = (r[(m, v, dropout)] for r in runs["two"])
    assert l0 == l1
    for k, val in s0.items():
        np.testing.assert_array_equal(val, s1[k], err_msg=k)


def _one_process_pipe(state):
    """A single-process port pipe of the pp=2 layout (dense chunk
    order), holding ``state``."""
    from paddle_tpu_torch import parallel
    net = MW.pipe_net(state, parallel.DeviceMesh(devices=2, pp=2), 2, 1)
    net.pipe.attach_mesh(None)
    return net


def test_save_on_the_pp_mesh_loads_into_one_process_and_jax(runs):
    path = str(runs["dir"] / "pp2_saved")
    want = runs["two"][0][(4, 1, 0.0)][1]
    jax_state = R.load_into_jax(path, pipe_v=1)
    net = _one_process_pipe(R.weights(pipe_v=1))
    MW.model_of(net).load(path)
    for k, v in want.items():
        np.testing.assert_array_equal(jax_state[k], v, err_msg=k)
        np.testing.assert_array_equal(net.state_dict()[k].numpy(), v,
                                      err_msg=k)


def test_fit_resumed_on_the_pp_mesh_equals_uninterrupted(runs):
    for r in runs["two"]:
        assert len(r["resume_full"]) == 4
        assert r["resume_parts"] == r["resume_full"]


def test_predict_and_evaluate_on_the_pp_mesh(runs):
    """predict gathers the pp ranks' rows; evaluate's loss weighs each
    rank's rows: both equal one process's on the same state."""
    r = runs["two"][0]
    net = _one_process_pipe(r["eval_state"])
    net.eval()
    ids = torch.tensor(R.ids()[0])
    with torch.no_grad():
        logits = net(ids)
    np.testing.assert_allclose(r["predict"], logits.numpy(), rtol=1e-5,
                               atol=1e-6)
    crit = MW.model_of(net)._loss
    np.testing.assert_allclose(r["eval_loss"], float(crit(logits, ids)),
                               rtol=1e-6)
    assert runs["two"][1]["eval_loss"] == r["eval_loss"]


# -- construction and layout, in this process -----------------------------

def _blocks(pkg):
    """The JAX tests' Block (Linear 8 -> 8, relu) in either package."""
    if pkg == "jax":
        import jax
        from paddle_tpu import nn

        class Block(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(8, 8)

            def forward(self, x):
                return jax.nn.relu(self.fc(x))
        return Block
    from paddle_tpu_torch import nn

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(8, 8)

        def forward(self, x):
            return torch.relu(self.fc(x))
    return Block


def _other(pkg):
    nn = __import__("paddle_tpu.nn" if pkg == "jax"
                    else "paddle_tpu_torch.nn", fromlist=["nn"])

    class Other(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(8, 8)
            self.gc = nn.Linear(8, 8)

        def forward(self, x):
            return self.gc(self.fc(x))
    return Other


def _buffered(pkg):
    nn = __import__("paddle_tpu.nn" if pkg == "jax"
                    else "paddle_tpu_torch.nn", fromlist=["nn"])
    if pkg == "jax":
        return lambda: nn.BatchNorm1D(8)

    class Buffered(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(8, 8)
            self.register_buffer("stat", torch.zeros(8))

        def forward(self, x):
            return self.fc(x)
    return Buffered


def _pipeline(pkg):
    mod = __import__("paddle_tpu.parallel.pipeline" if pkg == "jax"
                     else "paddle_tpu_torch.parallel.pipeline",
                     fromlist=["pipeline"])
    return mod


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", ["uneven", "heterogeneous", "buffered",
                                  "virtual"])
def test_pipeline_rejections_raise_alike(pkg, case):
    P = _pipeline(pkg)
    Block = _blocks(pkg)
    with pytest.raises(ValueError) as e:
        if case == "uneven":
            P.PipelineLayer([P.LayerDesc(Block) for _ in range(6)],
                            num_stages=4)
        elif case == "heterogeneous":
            P.PipelineParallel(P.PipelineLayer(
                [P.LayerDesc(Block), P.LayerDesc(_other(pkg))],
                num_stages=2), num_microbatches=2)
        elif case == "buffered":
            P.PipelineParallel(P.PipelineLayer(
                [_buffered(pkg)() for _ in range(2)], num_stages=2),
                num_microbatches=2)
        else:
            P.PipelineParallel(P.PipelineLayer(
                [P.LayerDesc(Block) for _ in range(3)], num_stages=3),
                num_microbatches=2, virtual_pp_degree=2)
    want = {"uneven": "evenly", "heterogeneous": "structurally identical",
            "buffered": "buffer-free", "virtual": "not divisible"}[case]
    assert want in str(e.value)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", ["sequence_parallel", "layers"])
def test_gpt_pipe_rejections_raise_alike(pkg, case):
    if pkg == "jax":
        from paddle_tpu.models.gpt import GPTForCausalLMPipe
        kw = {}
    else:
        from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe
        kw = {"device": "cpu"}
    c = R.cfg() if pkg == "jax" else MW.cfg()
    if case == "sequence_parallel":
        c.sequence_parallel = True   # past the port's GPTConfig check
        match = "sequence_parallel cannot compose"
    else:
        c.num_layers = 3
        match = "not divisible by pp"
    with pytest.raises(ValueError, match=match):
        GPTForCausalLMPipe(c, 2, 2, **kw)


def test_gpt_pipe_warns_on_scan_layers():
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe
    c = MW.cfg()
    c.scan_layers = True
    with pytest.warns(UserWarning, match="scan_layers"):
        GPTForCausalLMPipe(c, 2, 1, device="cpu")


def test_load_flat_state_dict_maps_old_layout():
    """A pre-stacking checkpoint (flat ``{j}__{suffix}`` keys of [S, ...])
    of the JAX package's pipe loads into the port's stacked layout and
    gives the JAX forward (tests/test_pipeline.py's case)."""
    import jax.numpy as jnp
    import paddle_tpu as pt
    import paddle_tpu_torch as ptt
    J, T = _pipeline("jax"), _pipeline("torch")
    pt.seed(0)
    jpipe = J.PipelineParallel(J.PipelineLayer(
        [J.LayerDesc(_blocks("jax")) for _ in range(8)], num_stages=4),
        num_microbatches=2)
    sd = {k: np.asarray(v) for k, v in jpipe.state_dict().items()}
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    want = np.asarray(jpipe(jnp.asarray(x)))
    flat = {f"{j}__{k}": v[:, j] for k, v in sd.items()
            for j in range(v.shape[1])}
    ptt.seed(1)
    tpipe = T.PipelineParallel(T.PipelineLayer(
        [T.LayerDesc(_blocks("torch")) for _ in range(8)], num_stages=4),
        num_microbatches=2)
    assert sorted(tpipe.state_dict()) == ["fc__bias", "fc__weight"]
    assert not np.allclose(tpipe(torch.tensor(x)).detach().numpy(), want)
    tpipe.load_flat_state_dict(flat)
    np.testing.assert_allclose(tpipe(torch.tensor(x)).detach().numpy(),
                               want, rtol=1e-6, atol=1e-6)


def test_tick_table_is_the_circular_schedule():
    """Every (microbatch, chunk) runs once, chunk k of microbatch j on
    rank k % pp at tick t0(j) + k, and no rank runs two chunks a
    tick."""
    from paddle_tpu_torch.parallel.pipeline import tick_table
    for pp, v, m in ((2, 1, 4), (2, 2, 4), (4, 2, 8), (2, 3, 5)):
        S = pp * v
        seen = {}
        for t, row in enumerate(tick_table(pp, v, m)):
            for r, w in enumerate(row):
                if w is not None:
                    j, k = w
                    assert k % pp == r and w not in seen
                    seen[w] = t
        assert sorted(seen) == [(j, k) for j in range(m) for k in range(S)]
        for (j, k), t in seen.items():
            assert t == (j // pp) * S + j % pp + k


# -- LocalSGD ------------------------------------------------------------------

def _jax_local_sgd():
    """The JAX package's LocalSGD over dp=2 at sync_every 4."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu import parallel
    p, x, y = _lsgd_data()

    def grad_fn(params, batch):
        xb, yb = batch

        def loss(q):
            h = jnp.maximum(xb @ q["w1"], 0.0)
            return ((h @ q["w2"] - yb) ** 2).mean()
        return jax.value_and_grad(loss)(params)

    def update_fn(params, grads):
        return jax.tree_util.tree_map(lambda a, g: a - 0.1 * g, params,
                                      grads)
    mesh = parallel.DeviceMesh(devices=jax.devices()[:2], dp=2)
    stacked = parallel.replicate_params(
        {k: jnp.asarray(v) for k, v in p.items()}, mesh)
    step = parallel.build_local_sgd_step(grad_fn, update_fn, sync_every=4,
                                         mesh=mesh)
    for i in range(4):
        stacked, _ = step(stacked, (jnp.asarray(x), jnp.asarray(y)),
                          jnp.asarray(i))
    return {k: np.asarray(v) for k, v in
            parallel.unreplicate_params(stacked).items()}


def test_local_sgd_sync_every_1_equals_dp(runs):
    """k=1: each step's averaged parameters are full-batch SGD's."""
    grad_fn, update_fn = MW.local_sgd_fns()
    p, x, y = _lsgd_data()
    params = {k: torch.tensor(v) for k, v in p.items()}
    for _ in range(3):
        _, g = grad_fn(params, (torch.tensor(x), torch.tensor(y)))
        params = update_fn(params, g)
    for r in runs["two"]:
        got, avg, _ = r["localsgd"][1]
        for k, v in params.items():
            np.testing.assert_allclose(got[k], v.numpy(), rtol=2e-5,
                                       atol=2e-6)
            np.testing.assert_allclose(avg[k], v.numpy(), rtol=2e-5,
                                       atol=2e-6)


def test_local_sgd_sync_every_k_equals_jax_averages(runs):
    """k=4: four local steps on each rank's rows, then one average: the
    JAX package's LocalSGD parameters, on both ranks."""
    want = runs["jax"]["lsgd"]
    r0, r1 = runs["two"]
    for r in (r0, r1):
        got, _, losses = r["localsgd"][4]
        assert len(losses) == 4
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=2e-6)
    for k in want:
        np.testing.assert_array_equal(r0["localsgd"][4][0][k],
                                      r1["localsgd"][4][0][k])
