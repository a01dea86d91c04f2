"""The port's ``amp.GradScaler`` and ``amp.debugging`` against the JAX
package's.

Tolerances, each with its reason:
- the scale / good / bad trajectory over a seeded pattern of finite and
  non-finite steps: equal (the same integer counters and power-of-two
  scales);
- ``unscale``: equal in float32 and float16 (one float32 multiply by
  the same reciprocal, rounded to the gradient's dtype);
- the eager ``scale`` -> backward -> ``step`` loop on a two-``Linear``
  classifier: parameters 1e-5 relative after 6 steps (float32 autograd
  in two frameworks), the skipped step leaving them bit-equal;
- instrument deltas (``amp_loss_scale``, ``amp_found_inf_total``,
  ``guard_trips_total{scaler_inf,skip}``, ``guard_skipped_steps_total``):
  equal."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu.amp import debugging as jdbg  # noqa: E402
from paddle_tpu.observability import metrics as jobs  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch.amp import debugging as tdbg  # noqa: E402
from paddle_tpu_torch.observability import metrics as tobs  # noqa: E402


def _pattern(n=40, seed=0):
    """A seeded run of finite (True) and non-finite (False) steps with
    streaks long enough to grow and shrink the scale."""
    r = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        out += [True] * int(r.randint(1, 6))
        out += [False] * int(r.randint(1, 4))
    return out[:n]


SCALERS = {
    "dynamic": dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=3,
                    decr_every_n_nan_or_inf=2),
    "clip-low": dict(init_loss_scaling=4.0, incr_every_n_steps=50,
                     decr_every_n_nan_or_inf=1, decr_ratio=0.25),
    "clip-high": dict(init_loss_scaling=2.0 ** 30, incr_every_n_steps=1,
                      incr_ratio=4.0),
    "static": dict(use_dynamic_loss_scaling=False),
}


@pytest.mark.parametrize("name", list(SCALERS))
def test_scale_trajectory_equals_jax(name):
    js, ts = jamp.GradScaler(**SCALERS[name]), tamp.GradScaler(
        **SCALERS[name])
    jst, tst = js.init_state(), ts.init_state()
    for i, ok in enumerate(_pattern()):
        jst = js.update_state(jst, jnp.asarray(ok))
        tst = ts.update_state(tst, torch.tensor(ok))
        for k in ("scale", "good", "bad"):
            assert float(tst[k]) == float(jst[k]), (i, k)
        assert tst["scale"].dtype == torch.float32
        assert tst["good"].dtype == tst["bad"].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_unscale_equals_jax(dtype):
    r = np.random.RandomState(1)
    g = {"w": (r.randn(5, 7) * 3e3).astype(dtype),
         "b": (r.randn(7) * 1e2).astype(dtype)}
    js, ts = jamp.GradScaler(init_loss_scaling=2.0 ** 12), \
        tamp.GradScaler(init_loss_scaling=2.0 ** 12)
    jg, jok = js.unscale({k: jnp.asarray(v) for k, v in g.items()})
    tg, tok = ts.unscale({k: torch.from_numpy(v) for k, v in g.items()})
    assert bool(tok) == bool(jok)
    for k in g:
        assert str(tg[k].dtype).split(".")[-1] == dtype
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
    g["w"][2, 3] = np.inf
    _, jok = js.unscale({k: jnp.asarray(v) for k, v in g.items()})
    _, tok = ts.unscale({k: torch.from_numpy(v) for k, v in g.items()})
    assert not bool(tok) and not bool(jok)
    loss = np.float32(2.5)
    assert float(ts.scale(torch.tensor(loss))) == \
        float(js.scale(jnp.asarray(loss)))


def test_state_dict_crosses_both_ways():
    """A state saved by one package continues in the other on the same
    trajectory."""
    kw = SCALERS["dynamic"]
    pat = _pattern(20, seed=4)
    for src, dst in (("jax", "torch"), ("torch", "jax")):
        js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
        first = js if src == "jax" else ts
        arr = jnp.asarray if src == "jax" else torch.tensor
        st = first.init_state()
        for ok in pat[:9]:
            st = first.update_state(st, arr(ok))
        first._state = st
        sd = first.state_dict()
        second = ts if dst == "torch" else js
        second.load_state_dict(sd)
        assert second.state_dict() == sd
        a, b = first._state, second._state
        for ok in pat[9:]:
            a = first.update_state(a, arr(ok))
            b = second.update_state(
                b, (torch.tensor if dst == "torch" else jnp.asarray)(ok))
            assert float(a["scale"]) == float(b["scale"])


class _JNet(jpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jpt.nn.Linear(8, 16)
        self.fc2 = jpt.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(jnp.tanh(self.fc1(x)))


class _TNet(tpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tpt.nn.Linear(8, 16)
        self.fc2 = tpt.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


_COUNTED = ("amp_found_inf_total", "guard_skipped_steps_total")


def _counts(reg):
    out = {n: (reg.get(n).value if reg.get(n) is not None else 0)
           for n in _COUNTED}
    fam = reg.get("guard_trips_total")
    out["trips"] = fam.labels("scaler_inf", "skip").value \
        if fam is not None else 0
    return out


def test_eager_step_loop_equals_jax():
    """scale -> backward -> step over 6 batches, the 3rd with an Inf in
    the gradient: same parameters, the bad step skipped (bit-equal
    parameters), the gauge and the skip counters moved alike."""
    from paddle_tpu_torch.interop import load_reference_state
    r = np.random.RandomState(3)
    xs = [r.randn(4, 8).astype(np.float32) for _ in range(6)]
    ys = [r.randint(0, 4, (4,)) for _ in range(6)]
    kw = dict(init_loss_scaling=2.0 ** 8, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    jpt.seed(0)
    jnet = _JNet()
    tnet = _TNet()
    load_reference_state(tnet, {k: np.asarray(v) for k, v in
                                jnet.state_dict().items()})
    jopt = jpt.optimizer.Adam(0.01, parameters=jnet)
    topt = tpt.optimizer.Adam(0.01, parameters=tnet)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jreg, treg = jobs.default_registry(), tobs.default_registry()
    jb, tb = _counts(jreg), _counts(treg)

    def jloss(params, x, y):
        from paddle_tpu.nn.layer import functional_call
        out, _ = functional_call(jnet, params, {}, x)
        lp = jax.nn.log_softmax(out)
        return -jnp.mean(jnp.take_along_axis(lp, y[:, None], -1))

    for i, (x, y) in enumerate(zip(xs, ys)):
        params = dict(jnet.named_parameters())
        g = jax.grad(lambda p: js.scale(jloss(p, x, y)))(params)
        if i == 2:
            g = {**g, "fc1.weight": g["fc1.weight"].at[0, 0].set(jnp.inf)}
        js.step(jopt, g)

        loss = -torch.log_softmax(tnet(torch.from_numpy(x)), -1).gather(
            -1, torch.from_numpy(y)[:, None]).mean()
        ts.scale(loss).backward()
        tg = {k: p.grad for k, p in tnet.named_parameters()}
        if i == 2:
            tg["fc1.weight"][0, 0] = float("inf")
            before = [p.detach().clone() for p in tnet.parameters()]
        ts.step(topt, tg)
        topt.clear_grad()
        if i == 2:
            assert all(torch.equal(a, b) for a, b in
                       zip(before, tnet.parameters()))
        assert ts.state_dict() == js.state_dict(), i
        assert float(treg.get("amp_loss_scale").value) == \
            ts.state_dict()["scale"]
    for k, v in jnet.named_parameters():
        np.testing.assert_allclose(
            dict(tnet.named_parameters())[k].detach().numpy(),
            np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)
    ja, ta = _counts(jreg), _counts(treg)
    assert {k: ta[k] - tb[k] for k in ta} == \
        {k: ja[k] - jb[k] for k in ja} == \
        {"amp_found_inf_total": 1, "guard_skipped_steps_total": 1,
         "trips": 1}


# ---------------------------------------------------------------------------
# amp.debugging
# ---------------------------------------------------------------------------

def test_tensor_checker_is_reentrant():
    assert not torch.is_anomaly_enabled()
    tdbg.enable_tensor_checker()
    assert torch.is_anomaly_enabled()
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(enable=False))
    assert torch.is_anomaly_enabled()
    tdbg.disable_tensor_checker()
    assert torch.is_anomaly_enabled()     # the outer scope's value
    tdbg.disable_tensor_checker()
    assert not torch.is_anomaly_enabled()
    with tdbg.tensor_checker():
        assert torch.is_anomaly_enabled()
        with tdbg.tensor_checker(tdbg.TensorCheckerConfig(enable=False)):
            assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()
    tdbg.disable_tensor_checker()         # unbalanced: stays off
    assert not torch.is_anomaly_enabled()


def test_tensor_checker_names_the_backward_op():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with tdbg.tensor_checker():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()


def test_find_nonfinite_names_equal_jax():
    r = np.random.RandomState(0)
    tree = {"param": {"fc1.weight": r.randn(3, 2).astype(np.float32),
                      "fc2.bias": np.array([1.0, np.nan], np.float32)},
            "buffer": {"stats": np.array([np.inf], np.float32),
                       "count": np.array([3], np.int32)},
            "list": [np.ones(2, np.float32),
                     np.array([np.nan], np.float32)]}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else [torch.from_numpy(a) for a in v])
          for k, v in tree.items()}
    assert tdbg.find_nonfinite(tt) == jdbg.find_nonfinite(jt) == [
        "buffer.stats", "list.1", "param.fc2.bias"]
    assert sorted(tdbg.finite_bits(tt)) == sorted(jdbg.finite_bits(jt))
    ok = torch.ones(3)
    assert tdbg.check_numerics(ok) is not None
    with pytest.raises(FloatingPointError, match="w contains NaN/Inf"):
        tdbg.check_numerics(torch.tensor([np.nan]), name="w")
    with pytest.raises(FloatingPointError, match="w contains NaN/Inf"):
        jdbg.check_numerics(jnp.asarray([np.nan]), name="w")
