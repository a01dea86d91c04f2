"""The port's training slice against the JAX package's: AMP casting,
gradient clipping, LR schedules, SGD/Adam/AdamW, and a tiny GPT trained
for 3 steps through ``Model.train_batch`` in each package (flash
attention and the fused loss on; JAX runs its Pallas kernels in
interpret mode, the port its plain twins), from weights carried across
by ``load_reference_state``.

Tolerances, each with its reason:
- LR schedules: 1e-6 relative and 1e-7 absolute (JAX evaluates them in
  float32, the port in host doubles);
- optimizer updates on float32 values: 1e-6 after k steps (the same
  elementwise formulas; bias corrections are host doubles here and f32
  scalars in JAX, ~1 ulp);
- the GPT run under O0 (all float32): per-step loss 1e-5 relative and
  parameters 1e-5 absolute after 3 AdamW steps at lr 1e-4;
- under O1 (bf16 matmuls): per-step loss 1e-4 relative, parameters
  1e-3 absolute. bf16 products round differently in XLA and in torch;
  where that flips the sign of a tiny gradient entry, Adam's normalised
  step (about lr in size) flips with it, so after 3 steps two runs may
  differ by up to ~2 * 3 * lr = 6e-4;
- the 3-step update of each parameter (its value minus its initial
  value) against JAX's, ||port - jax|| / ||jax||: 1e-3 under O0 and 1e-1
  under O1 (the sign flips above; a skipped update gives 1). The key
  slice of the qkv bias is left out of this comparison: its exact
  gradient is 0 (a shift of every key's score by one constant leaves
  the softmax unchanged), so both packages' Adam steps there are
  normalised rounding noise."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.nn import clip as jclip  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.optimizer import lr as jlr  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.nn import clip as tclip  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.optimizer import lr as tlr  # noqa: E402

TOL_OPT = 1e-6


# ---------------------------------------------------------------------------
# AMP
# ---------------------------------------------------------------------------

def test_auto_cast_state_nests_and_restores():
    assert not tamp.is_enabled() and tamp.compute_dtype() is None
    with tamp.auto_cast(custom_white_list=["layer_norm"],
                        custom_black_list=["attention"]):
        assert tamp.is_enabled()
        assert tamp.compute_dtype() == torch.bfloat16
        assert tamp.op_in_white("layer_norm")
        with tamp.auto_cast(enable=False):
            assert not tamp.is_enabled()
        assert tamp.is_enabled() and tamp.op_in_white("layer_norm")
        x = torch.ones(2, dtype=torch.float32)
        assert tamp.white_cast(x, op="attention").dtype == torch.float32
        a, b = tamp.white_cast(x, torch.ones(2, dtype=torch.int64))
        assert a.dtype == torch.bfloat16 and b.dtype == torch.int64
    assert not tamp.is_enabled()
    assert tamp.amp_guard is tamp.auto_cast


@pytest.mark.parametrize("op", ["linear", "linear-black", "layer_norm",
                                "layer_norm-white", "softmax-white",
                                "attention"])
def test_o1_dtype_flow_matches_jax(op):
    """The dtype each op returns under auto_cast O1 (and its values) is
    the JAX package's."""
    r = np.random.RandomState(0)
    x = r.randn(2, 128, 4, 64).astype(np.float32)
    w = r.randn(64, 32).astype(np.float32)
    b = r.randn(32).astype(np.float32)
    white = ["layer_norm", "softmax"] if op.endswith("-white") else None
    black = ["matmul"] if op.endswith("-black") else None
    kind = op.split("-")[0]

    def run(F, amp, arr):
        with amp.auto_cast(custom_white_list=white,
                           custom_black_list=black):
            if kind == "linear":
                return F.linear(arr(x), arr(w), arr(b))
            if kind == "layer_norm":
                return F.layer_norm(arr(x), 64, arr(w[:, 0]), arr(w[:, 1]))
            if kind == "softmax":
                return F.softmax(arr(x))
            return F.scaled_dot_product_attention(arr(x), arr(x), arr(x),
                                                  is_causal=True)
    want = run(JF, jamp, jnp.asarray)
    got = run(TF, tamp, torch.from_numpy)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


# ---------------------------------------------------------------------------
# clipping, schedules, optimizers
# ---------------------------------------------------------------------------

def _tree(seed=0, half=False):
    r = np.random.RandomState(seed)
    params = {"w": r.randn(4, 3).astype(np.float32),
              "b": r.randn(3).astype(np.float32),
              "ln.weight": r.randn(3).astype(np.float32)}
    grads = [{k: (r.randn(*v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name,arg", [("ClipGradByValue", 0.05),
                                      ("ClipGradByNorm", 0.1),
                                      ("ClipGradByGlobalNorm", 0.1)])
def test_clips_match_jax(name, arg):
    _, grads = _tree(1)
    g = grads[0]
    want = getattr(jclip, name)(arg)({k: jnp.asarray(v)
                                      for k, v in g.items()})
    got = getattr(tclip, name)(arg)({k: torch.from_numpy(v)
                                     for k, v in g.items()})
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-7)
    np.testing.assert_allclose(
        float(tclip.global_norm({k: torch.from_numpy(v)
                                 for k, v in g.items()})),
        float(jclip.global_norm({k: jnp.asarray(v) for k, v in g.items()})),
        rtol=1e-6)


SCHEDULES = {
    "constant": lambda m: m.ConstantLR(0.1),
    "warmup-const": lambda m: m.LinearWarmup(0.5, 4, 0.0, 0.5),
    "warmup-cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.5, 6), 3, 0.01, 0.5),
    "cosine": lambda m: m.CosineAnnealingDecay(0.5, 6, eta_min=0.01),
    "noam": lambda m: m.NoamDecay(64, 4),
    "exponential": lambda m: m.ExponentialDecay(0.5, 0.9),
    "natural-exp": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "inverse-time": lambda m: m.InverseTimeDecay(0.5, 0.1),
    "polynomial": lambda m: m.PolynomialDecay(0.5, 5, power=2.0),
    "polynomial-cycle": lambda m: m.PolynomialDecay(0.5, 3, cycle=True),
    "piecewise": lambda m: m.PiecewiseDecay([2, 5], [0.3, 0.2, 0.1]),
    "step": lambda m: m.StepDecay(0.5, 3, 0.5),
    "multistep": lambda m: m.MultiStepDecay(0.5, [2, 6], 0.5),
    "lambda": lambda m: m.LambdaDecay(0.5, lambda s: 1.0 / (s + 1)),
    "onecycle": lambda m: m.OneCycleLR(0.5, 10),
    "onecycle-linear": lambda m: m.OneCycleLR(0.5, 10,
                                              anneal_strategy="linear"),
    "cyclic": lambda m: m.CyclicLR(0.1, 0.5, 3),
    "cyclic2": lambda m: m.CyclicLR(0.1, 0.5, 2, 3, mode="triangular2"),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedules_match_jax(name):
    js, ts = SCHEDULES[name](jlr), SCHEDULES[name](tlr)
    for step in range(12):
        np.testing.assert_allclose(ts(step), float(js(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-7, err_msg=str(step))
    for _ in range(5):
        js.step()
        ts.step()
        np.testing.assert_allclose(ts.get_lr(), js.get_lr(), rtol=1e-6,
                                   atol=1e-7)


def test_stateful_schedules_match_jax():
    for m in (jlr, tlr):
        m.seq = []
        s = m.ReduceOnPlateau(0.5, patience=1, factor=0.5)
        for metric in (1.0, 0.9, 0.95, 0.96, 0.97, 0.5):
            s.step(metric)
            m.seq.append(s.get_lr())
        d = m.MultiplicativeDecay(0.5, lambda e: 0.9)
        for _ in range(3):
            d.step()
            m.seq.append(d.get_lr())
    np.testing.assert_allclose(tlr.seq, jlr.seq, rtol=1e-6)
    del jlr.seq, tlr.seq


OPTIMIZERS = {
    "sgd": lambda m: m.SGD(0.1),
    "sgd-wd": lambda m: m.SGD(0.1, weight_decay=0.01),
    "adam": lambda m: m.Adam(0.01),
    "adam-wd": lambda m: m.Adam(0.01, weight_decay=0.1),
    "adamw": lambda m: m.AdamW(0.01, weight_decay=0.1),
    "adamw-decay-fun": lambda m: m.AdamW(
        0.01, weight_decay=0.1,
        apply_decay_param_fun=lambda n: not n.endswith("b")),
    "adamw-global-clip": lambda m: m.AdamW(
        0.01, grad_clip=m_clip(m).ClipGradByGlobalNorm(0.05)),
    "adamw-schedule": lambda m: m.AdamW(
        m_lr(m).LinearWarmup(0.01, 2, 0.0, 0.01)),
}


def m_clip(m):
    return jclip if m is jpt.optimizer else tclip


def m_lr(m):
    return jlr if m is jpt.optimizer else tlr


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    """k steps of apply_gradients from the same values and gradients."""
    params, grads = _tree(2)
    jo, to = OPTIMIZERS[name](jpt.optimizer), \
        OPTIMIZERS[name](tpt.optimizer)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jo.init_state(jp), to.init_state(tp)
    for step, g in enumerate(grads):
        jp, js = jo.apply_gradients(jp, {k: jnp.asarray(v)
                                         for k, v in g.items()}, js, step)
        tp, ts = to.apply_gradients(tp, {k: torch.from_numpy(v)
                                         for k, v in g.items()}, ts, step)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=TOL_OPT, rtol=TOL_OPT, err_msg=k)
    if "m" in js:
        assert ts["t"] == int(js["t"]) == len(grads)
        for k in params:
            np.testing.assert_allclose(ts["m"][k].numpy(),
                                       np.asarray(js["m"][k]),
                                       atol=TOL_OPT, err_msg=k)
            np.testing.assert_allclose(ts["v"][k].numpy(),
                                       np.asarray(js["v"][k]),
                                       atol=TOL_OPT, err_msg=k)


def test_apply_gradients_is_pure():
    params, grads = _tree(3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = tpt.optimizer.AdamW(0.01)
    state = opt.init_state(tp)
    new, new_state = opt.apply_gradients(
        tp, {k: torch.from_numpy(v) for k, v in grads[0].items()}, state, 0)
    for k in params:
        assert np.array_equal(tp[k].numpy(), params[k])
        assert torch.count_nonzero(state["m"][k]) == 0
        assert not torch.equal(new[k], tp[k])
    assert state["t"] == 0 and new_state["t"] == 1


def test_bf16_param_keeps_an_f32_master_like_jax():
    """A bf16 parameter: f32 master copy and f32 moments in the state;
    the new bf16 value is the rounded master, as in JAX."""
    params, grads = _tree(4)
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "w" else jnp.float32)
          for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "w"
                                    else torch.float32)
          for k, v in params.items()}
    jo, to = jpt.optimizer.AdamW(0.01), tpt.optimizer.AdamW(0.01)
    js, ts = jo.init_state(jp), to.init_state(tp)
    assert set(ts) == set(js) == {"master", "m", "v", "t"}
    assert ts["master"]["w"].dtype == torch.float32
    assert ts["m"]["w"].dtype == torch.float32
    for step, g in enumerate(grads):
        jp, js = jo.apply_gradients(jp, {k: jnp.asarray(v)
                                         for k, v in g.items()}, js, step)
        tp, ts = to.apply_gradients(tp, {k: torch.from_numpy(v)
                                         for k, v in g.items()}, ts, step)
    assert tp["w"].dtype == torch.bfloat16 and tp["b"].dtype == torch.float32
    for k in params:
        np.testing.assert_allclose(ts["master"][k].numpy(),
                                   np.asarray(js["master"][k]),
                                   atol=TOL_OPT, err_msg=k)
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32),
                                   atol=TOL_OPT, err_msg=k)


def test_eager_step_writes_back_into_the_layer():
    tpt.seed(0)
    lin = tpt.nn.Linear(4, 3)
    x = torch.randn(5, 4)
    opt = tpt.optimizer.SGD(0.5, parameters=lin)
    before = {k: p.detach().clone() for k, p in lin.named_parameters()}
    lin(x).sum().backward()
    grads = {k: p.grad.clone() for k, p in lin.named_parameters()}
    opt.step()
    for k, p in lin.named_parameters():
        torch.testing.assert_close(p.detach(), before[k] - 0.5 * grads[k])
    opt.clear_grad()
    assert all(p.grad is None for p in lin.parameters())
    assert opt.state_dict()["step"] == 1
    assert opt.get_lr() == 0.5
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25 and opt.lr_fn(7) == 0.25


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _tiny(m, fused=True):
    return m.gpt_config("gpt2-small", num_layers=2, hidden_size=128,
                        num_heads=2, vocab_size=97,
                        max_position_embeddings=128, hidden_dropout=0.0,
                        attention_dropout=0.0, fused_loss=fused)


def _pair(fused=True):
    jpt.seed(0)
    jnet = jgpt.GPTForCausalLM(_tiny(jgpt, fused))
    tnet = tgpt.GPTForCausalLM(_tiny(tgpt, fused), device="cpu")
    load_reference_state(tnet, {k: np.asarray(v)
                                for k, v in jnet.state_dict().items()})
    return jnet, tnet


def _update_slice(name, hidden=128):
    """The entries of a parameter whose update is compared with JAX's:
    all but the key slice of a qkv bias (see the module docstring)."""
    if name.endswith("qkv_proj.bias"):
        return np.r_[0:hidden, 2 * hidden:3 * hidden]
    return slice(None)


@pytest.mark.parametrize("amp,tol_loss,tol_param,tol_update",
                         [(None, 1e-5, 1e-5, 1e-3),
                          ("O1", 1e-4, 1e-3, 1e-1)], ids=["O0", "O1"])
def test_gpt_train_steps_match_jax(amp, tol_loss, tol_param, tol_update):
    """3 Model.train_batch steps of a tiny GPT (2 layers, hidden 128, 2
    heads of d=64, seq 128: the flash path) with AdamW and the fused
    loss, in both packages from the same weights and batch."""
    jnet, tnet = _pair()
    init = {k: v.detach().clone() for k, v in tnet.state_dict().items()}
    jm, tm = jpt.Model(jnet), tpt.Model(tnet)
    jm.prepare(jpt.optimizer.AdamW(1e-4, parameters=jnet,
                                   weight_decay=0.01),
               jgpt.GPTFusedPretrainingCriterion(), amp_configs=amp)
    tm.prepare(tpt.optimizer.AdamW(1e-4, parameters=tnet,
                                   weight_decay=0.01),
               tgpt.GPTFusedPretrainingCriterion(), amp_configs=amp)
    ids = np.random.RandomState(0).randint(0, 97, (2, 128))
    for _ in range(3):
        want = float(jm.train_batch([ids], [ids])["loss"])
        got = tm.train_batch([ids], [ids])["loss"]
        assert got.dim() == 0 and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=tol_loss)
    jm.sync_weights()
    tstate = tnet.state_dict()
    for k, v in jnet.state_dict().items():
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(v),
                                   atol=tol_param, err_msg=k)
        keep = _update_slice(k)
        want_upd = (np.asarray(v) - init[k].numpy())[keep]
        got_upd = (tstate[k] - init[k]).numpy()[keep]
        rel = np.linalg.norm(got_upd - want_upd) / np.linalg.norm(want_upd)
        assert rel <= tol_update, (k, rel)


def test_fused_and_dense_heads_give_one_loss():
    """fused_loss=True and False compute one function: the same loss
    and the same first update, through Model."""
    _, tnet = _pair(fused=True)
    dense = tgpt.GPTForCausalLM(_tiny(tgpt, fused=False), device="cpu")
    dense.load_state_dict(tnet.state_dict())
    ids = np.random.RandomState(1).randint(0, 97, (2, 128))
    losses = []
    for net, crit in ((tnet, tgpt.GPTFusedPretrainingCriterion()),
                      (dense, tgpt.GPTPretrainingCriterion())):
        m = tpt.Model(net)
        m.prepare(tpt.optimizer.AdamW(1e-4, parameters=net), crit)
        losses.append(float(m.train_batch([ids], [ids])["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    # atol 1e-5: the two heads sum logits in another order, and Adam's
    # normalised step magnifies a last-bit difference in a tiny gradient
    for (k, a), b in zip(tnet.state_dict().items(),
                         dense.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   err_msg=k)


def test_eval_and_predict_batches_match_jax():
    jnet, tnet = _pair()
    jm, tm = jpt.Model(jnet), tpt.Model(tnet)
    jm.prepare(loss=jgpt.GPTFusedPretrainingCriterion())
    tm.prepare(loss=tgpt.GPTFusedPretrainingCriterion())
    ids = np.random.RandomState(2).randint(0, 97, (2, 128))
    np.testing.assert_allclose(
        float(tm.eval_batch([ids], [ids])["loss"]),
        float(jm.eval_batch([ids], [ids])["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm.predict_batch([ids]).numpy(),
                               np.asarray(jm.predict_batch([ids])),
                               atol=1e-4)


def test_untied_fused_head_returns_transposed_lm_head():
    cfg = tgpt.llama_config(hidden_size=64, num_layers=1, num_heads=1,
                            num_kv_heads=1, vocab_size=50,
                            max_position_embeddings=64,
                            ffn_hidden_size=128, fused_loss=True)
    net = tgpt.GPTForCausalLM(cfg, device="cpu").train()
    hidden, w = net(torch.zeros(1, 8, dtype=torch.long))
    assert hidden.shape == (1, 8, 64)
    assert w.shape == (50, 64) and torch.equal(w, net.lm_head.weight.t())
    assert net.eval()(torch.zeros(1, 8, dtype=torch.long)).shape == \
        (1, 8, 50)


def test_model_refuses_what_is_not_ported(tmp_path):
    """A step directory the JAX package committed (orbax data) is not
    restorable in the port: ``fit(resume=)`` raises naming its ROADMAP
    item, and before ``prepare`` the step entry points raise."""
    from paddle_tpu.io.checkpoint import CheckpointManager
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(1, {"params": {"w": np.zeros(2, np.float32)}})
    _, tnet = _pair()
    m = tpt.Model(tnet)
    m.prepare(tpt.optimizer.SGD(0.1, parameters=tnet),
              tgpt.GPTFusedPretrainingCriterion())
    with pytest.raises(NotImplementedError, match="ROADMAP A6.3"):
        m.fit(tpt.io.DataLoader(tpt.io.TensorDataset(
            [np.zeros((2, 8), np.int64)] * 2), device="cpu"),
            checkpoint_dir=str(tmp_path), resume="auto")
    m = tpt.Model(tnet)
    with pytest.raises(RuntimeError, match="prepare"):
        m.train_loop_batch([np.zeros((1, 2, 8), np.int64)])
    with pytest.raises(RuntimeError, match="prepare"):
        m.train_batch([np.zeros((1, 8), np.int64)])
    # the numeric guard is ported: prepare arms it
    m.prepare(loss=tgpt.GPTFusedPretrainingCriterion(), numeric_guard=True)
    assert m._guard is not None
    assert len(list(m.parameters())) == len(list(tnet.parameters()))
