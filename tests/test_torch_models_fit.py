"""The slice as a whole on the CPU: ``Model.fit`` of a tiny BERT
pretraining model (fused loss, O1, AdamW; 2 epochs of 2 steps, an eval
pass each) and of LeNet on ``tests/test_hapi_mnist.py``'s synthetic MNIST
(Adam, ``Accuracy``; 2 epochs of 4 steps), each in both packages from
the same weights over the same shuffled batches: every step's loss
within 5e-4 of the JAX fit's (1e-4 for LeNet in float32: 8 Adam
steps carry the first step's 1e-7 apart to 1.7e-5), and
``evaluate``'s loss and accuracy equal within those limits."""

import functools

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.core import rng as jrng  # noqa: E402
from paddle_tpu.models import bert as jb  # noqa: E402
from paddle_tpu.models.lenet import LeNet as JLeNet  # noqa: E402
from paddle_tpu_torch.core import rng as trng  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.models import bert as tb  # noqa: E402
from paddle_tpu_torch.models.lenet import LeNet as TLeNet  # noqa: E402

BERT = dict(num_layers=2, hidden_size=128, num_heads=2, vocab_size=1000,
            hidden_dropout=0.0, attention_dropout=0.0, fused_loss=True)


def synthetic_mnist(n=256, seed=0):
    """``tests/test_hapi_mnist.py``'s class-dependent blob patterns."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 10, n)
    imgs = rs.randn(n, 1, 28, 28).astype(np.float32) * 0.1
    for i, c in enumerate(labels):
        r, col = divmod(c, 4)
        imgs[i, 0, 4 + r * 8: 10 + r * 8, 2 + col * 7: 8 + col * 7] += 2.0
    return imgs, labels.astype(np.int64)


def _bert_data(n=4, s=128):
    rs = np.random.RandomState(0)
    ids = rs.randint(1, 1000, (n, s))
    mlm = np.where(rs.rand(n, s) < 0.15, ids, -100)
    nsp = rs.randint(0, 2, (n,))
    return ids, mlm, nsp


def _recorder(pkg):
    class Recorder(pkg.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(np.asarray(logs["loss"]).ravel()[0]))
    return Recorder()


def _fit(pkg, net, crit, opt, data, batch, epochs, amp=None,
         metrics=None, labels=None):
    model = pkg.Model(net, labels=labels)
    model.prepare(optimizer=opt, loss=crit, amp_configs=amp,
                  metrics=metrics)
    ds = pkg.io.TensorDataset(list(data))
    rec = _recorder(pkg)
    model.fit(ds, eval_data=ds, batch_size=batch, epochs=epochs,
              verbose=0, shuffle=True, callbacks=[rec])
    res = model.evaluate(ds, batch_size=batch, verbose=0)
    return rec.losses, {k: float(np.asarray(v).ravel()[0])
                        for k, v in res.items()}


@functools.lru_cache(maxsize=None)
def _jax_bert():
    jpt.seed(0)
    net = jb.BertForPretraining(jb.bert_config("bert-base", **BERT))
    state = {k: np.asarray(v) for k, v in net.state_dict().items()}
    jrng.seed(1)
    out = _fit(jpt, net, jb.BertFusedPretrainingCriterion(),
               jpt.optimizer.AdamW(1e-3, parameters=net,
                                   weight_decay=0.01),
               _bert_data(), 2, 2, "O1", labels=["mlm", "nsp"])
    return state, out


@functools.lru_cache(maxsize=None)
def _jax_lenet():
    jpt.seed(0)
    net = JLeNet()
    state = {k: np.asarray(v) for k, v in net.state_dict().items()}
    jrng.seed(1)
    out = _fit(jpt, net, jpt.nn.CrossEntropyLoss(),
               jpt.optimizer.Adam(1e-3, parameters=net),
               synthetic_mnist(64), 16, 2,
               metrics=[jpt.metric.Accuracy()])
    return state, out


def test_bert_pretraining_fit_matches_jax():
    state, (want, want_eval) = _jax_bert()
    net = tb.BertForPretraining(tb.bert_config("bert-base", **BERT),
                                device="cpu")
    load_reference_state(net, state)
    trng.seed(1)
    got, got_eval = _fit(tpt, net, tb.BertFusedPretrainingCriterion(),
                         tpt.optimizer.AdamW(1e-3, parameters=net,
                                             weight_decay=0.01),
                         _bert_data(), 2, 2, "O1", labels=["mlm", "nsp"])
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=5e-4)
    np.testing.assert_allclose(got_eval["loss"], want_eval["loss"],
                               rtol=5e-4)


def test_lenet_fit_matches_jax():
    state, (want, want_eval) = _jax_lenet()
    net = TLeNet(device="cpu")
    load_reference_state(net, state)
    trng.seed(1)
    got, got_eval = _fit(tpt, net, tpt.nn.CrossEntropyLoss(),
                         tpt.optimizer.Adam(1e-3, parameters=net),
                         synthetic_mnist(64), 16, 2,
                         metrics=[tpt.metric.Accuracy()])
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got_eval["acc"] == want_eval["acc"]
    np.testing.assert_allclose(got_eval["loss"], want_eval["loss"],
                               rtol=1e-4)
