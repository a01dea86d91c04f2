"""The port's CTR path against the JAX package's
(``tests/test_ctr_sparse.py``'s counterparts): ``SparseEmbedding`` and
``MultiSlotEmbedding`` (the hash fold, the combiners, padding), the
Wide&Deep and DeepFM models on the device tables and
``WideDeepHostTable`` on the host tables, and ``synthetic_criteo``.

The same ids fold to the same rows in both packages exactly. Lookups,
logits and gradients are held to 1e-5 (float32, summation order); the
models' Adam losses over 10 steps to 1e-5 absolute (float32 steps
drift apart by ~1e-6 a step), and the host table's losses and rows
after 3 steps to 1e-5 relative."""

import functools

import numpy as np
import pytest
import torch
from torch_gc_barrier import collect_cycles  # noqa: F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.models import widedeep as jwd  # noqa: E402
from paddle_tpu.nn.layer import functional_call, split_state  # noqa: E402
from paddle_tpu.nn.layers import sparse_embedding as jse  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.metric import Auc  # noqa: E402
from paddle_tpu_torch.models import widedeep as twd  # noqa: E402
from paddle_tpu_torch.nn.layers import sparse_embedding as tse  # noqa
from torch_nn_common import close  # noqa: E402

TOL = 1e-5


def _carry(jnet, tnet):
    load_reference_state(tnet, {k: np.asarray(v) for k, v in
                                jnet.state_dict().items()})


@pytest.mark.parametrize("n", [10, 1000, 10 ** 8])
def test_hash_fold_maps_ids_to_the_jax_rows(n):
    ids = np.concatenate([
        np.random.RandomState(0).randint(0, 2 ** 31 - 1, 200),
        [0, 1, 2000000001, 2 ** 31 - 1]]).astype(np.int64)
    want = np.asarray(jse.fold_hash_ids(jnp.asarray(ids, jnp.int32), n, 0))
    got = tse.fold_hash_ids(torch.from_numpy(ids), n, 0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-4] == 0    # padding maps to itself
    h = (2000000001 * 0x9E3779B9) & 0xFFFFFFFF
    h ^= h >> 16
    assert got[-2] == 1 + h % (n - 1)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("hash_ids", [False, True])
def test_sparse_embedding_matches_jax(combiner, hash_ids):
    jl = jse.SparseEmbedding(100, 8, combiner=combiner, hash_ids=hash_ids)
    tl = tse.SparseEmbedding(100, 8, combiner=combiner, hash_ids=hash_ids)
    _carry(jl, tl)
    ids = np.array([[1, 2, 0, 0], [3, 0, 0, 0], [0, 0, 0, 0],
                    [5, 5, 99, 2000000001 if hash_ids else 150]])
    params, _ = split_state(jl)
    r = np.random.RandomState(1).randn(4, 8).astype(np.float32)

    def loss(p):
        out, _ = functional_call(jl, p, {}, jnp.asarray(ids))
        return jnp.sum(out * r), out
    (_, jout), jg = jax.value_and_grad(loss, has_aux=True)(params)
    tout = tl(torch.from_numpy(ids))
    close(tout, jout, TOL)
    (tout * torch.from_numpy(r)).sum().backward()
    close(tl.weight.grad, jg["weight"], TOL)
    touched = set(np.nonzero(np.abs(tl.weight.grad.numpy()).sum(-1))[0])
    looked = tse.fold_hash_ids(torch.from_numpy(ids), 100, 0).numpy() \
        if hash_ids else np.clip(ids, 0, 99)
    assert touched == set(looked.reshape(-1).tolist()) - {0}


def test_unhashed_out_of_range_ids_clamp_to_the_last_row():
    tl = tse.SparseEmbedding(10, 4, padding_idx=None)
    out = tl(torch.tensor([[2000000001]]))
    close(out[0], tl.weight[9].detach().numpy())


@pytest.mark.parametrize("shape", [(3, 4), (3, 4, 2)])
def test_multislot_layout_matches_jax(shape):
    jl = jse.MultiSlotEmbedding(50, 4, combiner="mean")
    tl = tse.MultiSlotEmbedding(50, 4, combiner="mean")
    _carry(jl, tl)
    ids = np.random.RandomState(2).randint(0, 50, shape)
    close(tl(torch.from_numpy(ids)), jl(jnp.asarray(ids)), TOL)
    assert tuple(tl(torch.from_numpy(ids)).shape) == (3, 16)


def test_synthetic_criteo_draws_the_jax_data():
    for a, b in zip(twd.synthetic_criteo(n=256, vocab_size=10 ** 8,
                                         seed=3),
                    jwd.synthetic_criteo(n=256, vocab_size=10 ** 8,
                                         seed=3)):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_losses(name, steps):
    """The JAX model's Adam losses over ``steps`` full-batch steps from
    its seeded weights, and those weights."""
    jpt.seed(0)
    net = getattr(jwd, name)(vocab_size=2000, embedding_dim=8,
                             hidden=(32, 16))
    init = {k: np.asarray(v) for k, v in net.state_dict().items()}
    d, s, y = jwd.synthetic_criteo(n=512, vocab_size=2000)
    params, buffers = split_state(net)
    opt = jpt.optimizer.Adam(learning_rate=1e-2, parameters=net)
    state = opt.init_state(params)

    @jax.jit
    def step(params, state, i):
        def loss_fn(p):
            logits, _ = functional_call(net, p, buffers, jnp.asarray(d),
                                        jnp.asarray(s))
            return jpt.nn.functional.binary_cross_entropy_with_logits(
                logits, jnp.asarray(y))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, state = opt.apply_gradients(params, grads, state, i)
        return params, state, loss
    losses = []
    for i in range(steps):
        params, state, loss = step(params, state, i)
        losses.append(float(loss))
    return init, losses


@pytest.mark.parametrize("name", ["WideDeep", "DeepFM"])
def test_ctr_model_trains_like_jax_and_auc_improves(name):
    init, want = _jax_losses(name, 10)
    net = getattr(twd, name)(vocab_size=2000, embedding_dim=8,
                             hidden=(32, 16))
    load_reference_state(net, init)
    d, s, y = (torch.from_numpy(a) for a in
               twd.synthetic_criteo(n=512, vocab_size=2000))
    m = pt.Model(net)
    m.prepare(pt.optimizer.Adam(learning_rate=1e-2, parameters=net),
              pt.nn.BCEWithLogitsLoss())

    def auc():
        net.eval()
        with torch.no_grad():
            probs = torch.sigmoid(net(d, s)).numpy()
        a = Auc()
        a.update(probs, y.numpy())
        return a.accumulate()
    first = auc()
    losses = [float(m.train_batch([d, s], [y])["loss"]) for _ in range(60)]
    # float32 Adam steps drift apart at ~1e-6 a step
    np.testing.assert_allclose(losses[:10], want, rtol=0, atol=TOL)
    assert losses[-1] < losses[0] * 0.8, losses[::20]
    last = auc()
    assert last > first and last > 0.7


def test_widedeep_host_table_matches_jax():
    """``WideDeepHostTable`` (both tables in host RAM, adagrad rows,
    native accessor) from the same dense weights and the same lazy rows:
    3 Adam steps' losses, the touched-row count and the rows after the
    steps."""
    d, s, y = twd.synthetic_criteo(n=128, vocab_size=10 ** 8, seed=1)
    jpt.seed(0)
    jnet = jwd.WideDeepHostTable(hidden=(16, 8))
    tnet = twd.WideDeepHostTable(hidden=(16, 8))
    _carry(jnet, tnet)
    losses = {}
    for name, pkg, net in (("jax", jpt, jnet), ("torch", pt, tnet)):
        m = pkg.Model(net)
        m.prepare(pkg.optimizer.Adam(learning_rate=1e-3, parameters=net),
                  pkg.nn.BCEWithLogitsLoss())
        inputs = [d, s] if name == "jax" else \
            [torch.from_numpy(d), torch.from_numpy(s)]
        label = [y] if name == "jax" else [torch.from_numpy(y)]
        losses[name] = [float(m.train_batch(inputs, label)["loss"])
                        for _ in range(3)]
    jax.effects_barrier()
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=TOL)
    for table in ("wide", "embedding"):
        tt, jt = getattr(tnet, table), getattr(jnet, table)
        assert tt.touched_rows == jt.touched_rows > 0
        ids = np.sort(np.asarray(list(jt._rows)))
        close(tt._pull(ids), jt._pull(ids), TOL, table)


def test_incubate_namespace():
    from paddle_tpu_torch import incubate
    assert incubate.SparseEmbedding is tse.SparseEmbedding
    assert incubate.MultiSlotEmbedding is tse.MultiSlotEmbedding
    assert hasattr(incubate, "FusedMultiHeadAttention")
    assert hasattr(incubate, "MoELayer")
