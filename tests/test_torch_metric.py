"""The port's metrics against the JAX package's on the same NumPy
inputs. ``Accuracy.compute`` must give the JAX package's ``correct``
array exactly (its stable ``argsort``: ties to the lower index, NaN
last), and every accumulated value must be equal (the same NumPy
``update``/``accumulate`` code), but for float32 means, which round
the same count in another order: 2e-7 relative, about one ulp."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu.metric as jm  # noqa: E402
import paddle_tpu_torch.metric as tm  # noqa: E402


def _scores(shape, seed, ties=False):
    r = np.random.RandomState(seed)
    if ties:   # few distinct values: many ties across a row
        return r.randint(0, 4, shape).astype(np.float32)
    return r.randn(*shape).astype(np.float32)


def _correct(topk, pred, label):
    want = np.asarray(jm.Accuracy(topk).compute(jnp.asarray(pred),
                                                jnp.asarray(label)))
    got = tm.Accuracy(topk).compute(torch.from_numpy(pred),
                                    torch.from_numpy(label))
    return want, got.numpy()


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("form", ["column", "flat", "onehot", "seq"])
@pytest.mark.parametrize("topk", [(1,), (1, 5), (3,)],
                         ids=["top1", "top1-5", "top3"])
def test_accuracy_compute_matches_jax(form, topk, ties):
    pred = _scores((3, 6, 10) if form == "seq" else (32, 10), 0, ties)
    r = np.random.RandomState(1)
    lab = r.randint(0, 10, pred.shape[:-1]).astype(np.int64)
    if form == "column":
        lab = lab[:, None]
    elif form == "onehot":
        lab = np.eye(10, dtype=np.float32)[lab]
    want, got = _correct(topk, pred, lab)
    assert got.dtype == np.bool_ and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_accuracy_compute_nan_scores_and_out_of_range_labels():
    """NaN scores sort last (by index among themselves); a label that
    names no column is never correct."""
    pred = _scores((8, 6), 2, ties=True)
    pred[0, 2] = np.nan
    pred[1, :] = np.nan
    pred[2, [0, 4]] = np.nan
    lab = np.array([[2], [3], [4], [0], [6], [-1], [1], [5]], np.int64)
    want, got = _correct((1, 6), pred, lab)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("topk", [(1, 2), (1,)])
def test_accuracy_accumulates_like_jax(topk):
    jacc, tacc = jm.Accuracy(topk), tm.Accuracy(topk)
    for seed in range(4):
        pred = _scores((16, 5), seed, ties=seed % 2 == 1)
        lab = np.random.RandomState(seed + 10).randint(
            0, 5, (16, 1)).astype(np.int64)
        jacc.update(jacc.compute(jnp.asarray(pred), jnp.asarray(lab)))
        tacc.update(tacc.compute(torch.from_numpy(pred),
                                 torch.from_numpy(lab)))
        np.testing.assert_allclose(tacc.accumulate(), jacc.accumulate(),
                                   rtol=2e-7)
    assert tacc.name() == jacc.name()
    tacc.reset()
    assert tacc.accumulate() == (0.0 if len(topk) == 1 else [0.0, 0.0])


def test_update_stacked_equals_per_step_updates():
    steps = [(_scores((8, 5), s), np.random.RandomState(s).randint(
        0, 5, (8, 1)).astype(np.int64)) for s in range(3)]
    per_step, stacked, jax_stacked = (tm.Accuracy((1, 3)),
                                      tm.Accuracy((1, 3)),
                                      jm.Accuracy((1, 3)))
    outs = []
    for p, lab in steps:
        c = per_step.compute(torch.from_numpy(p), torch.from_numpy(lab))
        per_step.update_stacked((c,), 1)
        outs.append(c)
    stacked.update_stacked((torch.stack(outs),), 3)
    jax_stacked.update_stacked((np.stack([o.numpy() for o in outs]),), 3)
    assert stacked.accumulate() == per_step.accumulate() == \
        jax_stacked.accumulate()


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_jax(name):
    jmet, tmet = getattr(jm, name)(), getattr(tm, name)()
    r = np.random.RandomState(4)
    for _ in range(3):
        preds = r.rand(40, 1).astype(np.float32)
        labels = r.randint(0, 2, (40, 1)).astype(np.int64)
        jmet.update(jnp.asarray(preds), jnp.asarray(labels))
        tmet.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert tmet.accumulate() == jmet.accumulate()
    assert tmet.name() == jmet.name()
    if name == "Auc":   # [N, 2] class scores: column 1 is positive
        two = r.rand(10, 2).astype(np.float32)
        lab = r.randint(0, 2, 10)
        jmet.update(two, lab)
        tmet.update(torch.from_numpy(two), lab)
        assert tmet.accumulate() == jmet.accumulate()


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_functional_accuracy_matches_jax(k, ties):
    pred = _scores((30, 7), 5, ties)
    lab = np.random.RandomState(6).randint(0, 7, (30, 2)).astype(np.int64)
    for labels in (lab[:, :1], lab, lab[:, 0]):
        want = float(jm.accuracy(pred, labels, k=k))
        got = tm.accuracy(torch.from_numpy(pred), torch.from_numpy(labels),
                          k=k)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=2e-7)
