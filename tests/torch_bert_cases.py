"""BERT / ERNIE of the port (``paddle_tpu_torch/models/bert.py``)
against the JAX package's, cut into files of at most 26 tests by
``tests/torch_parts.py`` (``test_torch_bert*.py``).

At the bench's ``cpu_smoke`` shape (``bench.py:442-444``: 2 layers,
hidden 128, 2 heads of d 64, vocab 30522, seq 128, batch 2): the JAX
model's weights are carried into the port through numpy
(``interop.load_reference_state``). The JAX side runs its flash path as
its own tests run it on the CPU (the Pallas kernels in interpret mode);
the port runs the twins of B1-B3. Limits: float32 forwards within ``1e-6
+ 1e-5 |jax|`` where both sides take the same attention math (the
masked, plain path) and within the flash tolerance of
``tests/test_torch_flash_attention.py`` (2e-5) where the JAX side tiles
with its online softmax; train losses within 5e-4 under O1 and 1e-5 in
float32; dropout masks bit for bit (losses within 1e-5).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import rng as jrng
from paddle_tpu.models import bert as jb
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.interop import load_reference_state
from paddle_tpu_torch.models import bert as tb
from torch_parts import split

B, S = 2, 128
SMOKE = dict(num_layers=2, hidden_size=128, num_heads=2,
             hidden_dropout=0.0, attention_dropout=0.0)
FLASH_FWD = 2e-5
O1_RTOL, F32_RTOL = 5e-4, 1e-5


def _cfg(mod, **kw):
    return mod.bert_config("bert-base", **{**SMOKE, **kw})


def _batch(seed=0, pad=False):
    """Ids, 15% MLM labels and NSP labels drawn as ``bench.py`` draws
    them; ``pad`` zeroes (pad id 0) the last 40 positions of row 1."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 30522, (B, S))
    mlm = np.where(rs.rand(B, S) < 0.15, ids, -100)
    nsp = rs.randint(0, 2, (B,))
    if pad:
        ids[1, -40:] = 0
        mlm[1, -40:] = -100
    return ids, mlm, nsp


def _close(got, want, tol, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol * 0.1,
                               rtol=tol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_state(kind="pretrain", **kw):
    jpt.seed(0)
    cfg = _cfg(jb, **dict(kw))
    net = jb.BertForPretraining(cfg) if kind == "pretrain" else \
        jb.BertForSequenceClassification(cfg, num_classes=3)
    return {k: np.asarray(v) for k, v in net.state_dict().items()}


def _pair(kind="pretrain", **kw):
    """The JAX net and the port's (``device="cpu"``) on one state."""
    state = _jax_state(kind, **kw)
    if kind == "pretrain":
        jnet = jb.BertForPretraining(_cfg(jb, **kw))
        tnet = tb.BertForPretraining(_cfg(tb, **kw), device="cpu")
    else:
        jnet = jb.BertForSequenceClassification(_cfg(jb, **kw),
                                                num_classes=3)
        tnet = tb.BertForSequenceClassification(_cfg(tb, **kw),
                                                num_classes=3,
                                                device="cpu")
    jnet.set_state_dict(state)
    load_reference_state(tnet, state)
    return jnet, tnet


def _jax_mask(ids):
    return jb.BertModel.attention_mask_from_ids(jnp.asarray(ids), 0)


def _port_mask(ids):
    return tb.BertModel.attention_mask_from_ids(torch.from_numpy(ids), 0)


def names_and_tied_weight():
    """The state-dict keys are the JAX package's, in its order; the
    decoder's weight is the word embedding, one parameter under one
    name."""
    jnet, tnet = _pair()
    assert list(tnet.state_dict()) == list(jnet.state_dict())
    assert tnet.lm_head.tied_weight() is \
        tnet.bert.embeddings.word_embeddings.weight
    names = [n for n, _ in tnet.named_parameters()]
    assert len(names) == len(set(names)) == len(list(tnet.parameters()))
    assert [n for n in names if "word_embeddings" in n] == \
        ["bert.embeddings.word_embeddings.weight"]
    assert "lm_head.decoder_bias" in names
    meta = tnet.param_meta()
    assert meta["bert.embeddings.word_embeddings.weight"].axes == \
        ("vocab", "embed")
    assert meta["lm_head.decoder_bias"].axes == ("vocab",)
    assert meta["bert.encoder.0.fc_in.weight"].axes == ("embed", "mlp")


def attention_mask_matches():
    ids, _, _ = _batch(pad=True)
    got, want = _port_mask(ids), _jax_mask(ids)
    assert tuple(got.shape) == tuple(want.shape) == (B, 1, 1, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def pretraining_forward_matches(masked):
    """Eval forward (MLM logits, NSP logits) with and without a padding
    mask; without one the port takes the flash twin, with one the plain
    path, as the JAX package takes its Pallas kernel or its plain
    path."""
    from paddle_tpu_torch.ops import flash_attention as fa
    jnet, tnet = _pair()
    jnet.eval()
    tnet.eval()
    ids, _, _ = _batch(pad=masked)
    jm = _jax_mask(ids) if masked else None
    tm = _port_mask(ids) if masked else None
    want = jnet(jnp.asarray(ids), attn_mask=jm)
    calls = []
    real = fa.flash_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    fa.flash_attention = counted
    try:
        with torch.no_grad():
            got = tnet(torch.from_numpy(ids), attn_mask=tm)
    finally:
        fa.flash_attention = real
    assert len(calls) == (0 if masked else 2)
    tol = F32_RTOL if masked else FLASH_FWD
    _close(got[0], want[0], tol, "mlm logits")
    _close(got[1], want[1], tol, "nsp logits")


def classification_forward_matches(masked):
    jnet, tnet = _pair("cls")
    jnet.eval()
    tnet.eval()
    ids, _, _ = _batch(seed=1, pad=masked)
    jm = _jax_mask(ids) if masked else None
    tm = _port_mask(ids) if masked else None
    want = jnet(jnp.asarray(ids), attn_mask=jm)
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids), attn_mask=tm)
    assert tuple(got.shape) == (B, 3)
    _close(got, want, F32_RTOL if masked else FLASH_FWD)


def _prepare(pt, net, mod, fused, amp):
    model = pt.Model(net)
    crit = mod.BertFusedPretrainingCriterion() if fused else \
        mod.BertPretrainingCriterion()
    model.prepare(optimizer=pt.optimizer.AdamW(
        learning_rate=1e-4, parameters=net, weight_decay=0.01),
        loss=crit, amp_configs=amp)
    return model


@functools.lru_cache(maxsize=None)
def _jax_losses(fused, amp, cfg_kw=()):
    kw = dict(cfg_kw)
    jnet, _ = _pair(fused_loss=fused, **kw)
    model = _prepare(jpt, jnet, jb, fused, amp)
    jrng.seed(5)
    out = []
    for i in range(3):
        ids, mlm, nsp = _batch(seed=10 + i)
        out.append(float(model.train_batch([ids], [mlm, nsp])["loss"]))
    return out


def _port_losses(fused, amp, cfg_kw=()):
    kw = dict(cfg_kw)
    _, tnet = _pair(fused_loss=fused, **kw)
    model = _prepare(tpt, tnet, tb, fused, amp)
    trng.seed(5)
    out = []
    for i in range(3):
        ids, mlm, nsp = _batch(seed=10 + i)
        out.append(float(model.train_batch([ids], [mlm, nsp])["loss"]))
    return out


def train_batch_matches(fused, amp):
    """3 ``train_batch`` steps (AdamW 1e-4, wd 0.01) from the same weights
    and batches: the fused criterion under O1 (the bench's) and the dense
    one under O0 and O1. Each case is one more JAX compile (25-35 s under
    ``-n 6``), so the fused criterion's O0 step is left to the dropout
    cases below, which train it in float32."""
    got = _port_losses(fused, amp)
    want = _jax_losses(fused, amp)
    rtol = O1_RTOL if amp == "O1" else F32_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[-1] < got[0]


def remat_scan_dropout_matches(remat, scan):
    """``remat`` / ``scan_layers`` at dropout 0.1 (hidden and attention):
    the port draws the JAX package's masks (``scan_layers`` folds each
    layer's key from ``next_key("bert_trunk")``), so the float32 losses
    agree. Recomputation changes no number, and the JAX package's
    ``remat`` without ``scan_layers`` raises under dropout (its
    ``jax.checkpoint`` leaks the key stream's tracer, ROADMAP Queue C),
    so the port's remat-only run is held to the JAX run without remat."""
    cfg_kw = (("hidden_dropout", 0.1), ("attention_dropout", 0.1),
              ("remat", remat), ("scan_layers", scan))
    jax_kw = (("hidden_dropout", 0.1), ("attention_dropout", 0.1),
              ("remat", remat and scan), ("scan_layers", scan))
    got = _port_losses(True, None, cfg_kw)
    want = _jax_losses(True, None, jax_kw)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL)


def tied_weight_gradient_sums_both_uses():
    """The word embedding's gradient is the lookup's plus the decoder's,
    as JAX differentiates the tied parameter, in float32 through the
    dense criterion; attention takes the plain path on both sides here
    (``use_flash=False``: an eager JAX gradient through the interpreted
    Pallas kernels takes ~20 s)."""
    jnet, tnet = _pair(use_flash=False)
    ids, mlm, nsp = _batch(seed=3)
    crit_j, crit_t = jb.BertPretrainingCriterion(), \
        tb.BertPretrainingCriterion()
    from paddle_tpu.nn.layer import functional_call, split_state
    params, bufs = split_state(jnet)

    def loss(p):
        out, _ = functional_call(jnet, p, bufs, jnp.asarray(ids),
                                 training=False)
        return crit_j(*out, jnp.asarray(mlm), jnp.asarray(nsp))
    want = jax.grad(loss)(params)["bert.embeddings.word_embeddings.weight"]
    tnet.eval()
    out = tnet(torch.from_numpy(ids))
    crit_t(*out, torch.from_numpy(mlm), torch.from_numpy(nsp)).backward()
    w = tnet.bert.embeddings.word_embeddings.weight
    _close(w.grad, want, F32_RTOL, "tied weight grad")
    # both uses contribute: the decoder touches every row, the lookup
    # only the ids' rows (row 0, the pad id, none)
    decoder_only = torch.ones(w.shape[0], dtype=torch.bool)
    decoder_only[torch.from_numpy(np.unique(ids))] = False
    assert w.grad[decoder_only].abs().sum() > 0


def fused_loss_with_bias_matches():
    """``fused_linear_cross_entropy`` with the decoder bias at vocab 30522
    (not a multiple of its 8192 chunk) and ``ignore_index`` rows: loss
    and the gradients of hidden, weight and bias against the JAX op."""
    from paddle_tpu.ops.fused_xent import fused_linear_cross_entropy as jf
    from paddle_tpu_torch.ops.fused_xent import \
        fused_linear_cross_entropy as tf
    rs = np.random.RandomState(4)
    t, h, v = 64, 32, 30522
    hid = rs.randn(t, h).astype(np.float32)
    w = (rs.randn(v, h) * 0.05).astype(np.float32)
    bias = (rs.randn(v) * 0.1).astype(np.float32)
    lab = rs.randint(0, v, (t,))
    lab[::5] = -100
    jl, jg = jax.value_and_grad(
        lambda a, b, c: jf(a, b, jnp.asarray(lab), -100, None, c),
        argnums=(0, 1, 2))(jnp.asarray(hid), jnp.asarray(w),
                           jnp.asarray(bias))
    th, tw, tbias = (torch.from_numpy(x).requires_grad_()
                     for x in (hid, w, bias))
    loss = tf(th, tw, torch.from_numpy(lab), -100, None, tbias)
    loss.backward()
    _close(loss, jl, F32_RTOL, "loss")
    for got, want, what in ((th.grad, jg[0], "dh"), (tw.grad, jg[1], "dw"),
                            (tbias.grad, jg[2], "dbias")):
        _close(got, want, F32_RTOL, what)


def eval_through_fused_criterion_matches():
    """In eval the fused model returns dense logits and the fused
    criterion takes the dense criterion's arity: ``eval_batch`` losses
    equal the JAX package's."""
    jnet, tnet = _pair(fused_loss=True)
    jm = _prepare(jpt, jnet, jb, True, "O1")
    tm = _prepare(tpt, tnet, tb, True, "O1")
    ids, mlm, nsp = _batch(seed=6)
    want = jm.eval_batch([ids], [mlm, nsp])["loss"]
    got = tm.eval_batch([ids], [mlm, nsp])["loss"]
    np.testing.assert_allclose(float(np.asarray(got).ravel()[0]),
                               float(np.asarray(want).ravel()[0]),
                               rtol=O1_RTOL)


def ernie_config_matches():
    """``ernie_config`` is the BERT skeleton with ERNIE's vocabulary, and
    every preset equals the JAX package's."""
    assert tb.PRESETS == jb.PRESETS
    for name in tb.PRESETS:
        assert vars(tb.ernie_config(name)) == vars(jb.ernie_config(name))
    cfg = tb.ernie_config("ernie-base", num_layers=1, hidden_size=64,
                          num_heads=1)
    assert cfg.vocab_size == 18000 and cfg.intermediate_size == 256
    net = tb.BertModel(cfg, device="cpu")
    jnet = jb.BertModel(jb.ernie_config("ernie-base", num_layers=1,
                                        hidden_size=64, num_heads=1))
    assert list(net.state_dict()) == list(jnet.state_dict())


def default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.BertForPretraining(_cfg(tb))


# three families of about equal JAX compile time, so that xdist runs
# them in three workers side by side
TESTS = [
    ("test_train_batch_matches_jax", train_batch_matches,
     [(True, "O1")], ["fused-O1"]),
    ("test_names_and_tied_weight", names_and_tied_weight, None, None),
    ("test_attention_mask_matches_jax", attention_mask_matches, None,
     None),
    ("test_pretraining_forward_matches_jax", pretraining_forward_matches,
     [(False,), (True,)], ["unmasked", "masked"]),
    ("test_classification_forward_matches_jax",
     classification_forward_matches, [(False,), (True,)],
     ["unpadded", "padded"]),
    ("test_fused_loss_with_bias_matches_jax", fused_loss_with_bias_matches,
     None, None),
    ("test_ernie_config_matches_jax", ernie_config_matches, None, None),
    ("test_default_device_is_the_card", default_device_is_the_card, None,
     None),
]
TESTS_DENSE = [
    ("test_train_batch_matches_jax", train_batch_matches,
     [(False, "O0"), (False, "O1")], ["dense-O0", "dense-O1"]),
    ("test_eval_through_fused_criterion_matches_jax",
     eval_through_fused_criterion_matches, None, None),
]
TESTS_DROPOUT = [
    ("test_remat_scan_dropout_matches_jax", remat_scan_dropout_matches,
     [(True, False), (True, True)], ["remat", "scan-remat"]),
    ("test_tied_weight_gradient_sums_both_uses",
     tied_weight_gradient_sums_both_uses, None, None),
]

PARTS = split(TESTS, 1) + split(TESTS_DENSE, 1) + \
    split(TESTS_DROPOUT, 1)
