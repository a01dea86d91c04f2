"""``tools/torch_orbax_to_port.py`` against the JAX package's own
checkpoints: the JAX ``Model.fit`` of a tiny GPT checkpoints every 2
steps and stops after step 5 (step 4 committed); the tool converts step
4 (beside orbax's files, or to another directory); the port's
``fit(resume="auto")`` restores it with the step count, the learning
rate, the parameters and AdamW's moments equal to the JAX arrays bit
for bit, and its next two losses (steps 5 and 6) within 1e-5 relative
of the JAX package's uninterrupted fit (float32 on the CPU: summation
order only). A step whose leaves do not match its manifest is refused,
and a converted leaf that rots is caught by the port's own digests."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.io import checkpoint as jckpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "torch_orbax_to_port.py")
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_orbax_to_port as conv  # noqa: E402

IDS = np.random.RandomState(0).randint(0, 64, (24, 16))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg):
    return pkg.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=2, max_position_embeddings=16,
                         use_flash=False)


@functools.lru_cache(maxsize=None)
def _init():
    jpt.seed(0)
    net = jgpt.GPTForCausalLM(_cfg(jgpt))
    return {k: np.asarray(v) for k, v in net.state_dict().items()}


def _model(pkg):
    pkg.seed(0)
    mod = jgpt if pkg is jpt else tgpt
    if pkg is jpt:
        net = mod.GPTForCausalLM(_cfg(mod))
        net.set_state_dict({k: jnp.asarray(v) for k, v in _init().items()})
    else:
        net = mod.GPTForCausalLM(_cfg(mod), device="cpu")
        load_reference_state(net, _init())
    m = pkg.Model(net)
    lr = pkg.optimizer.lr.CosineAnnealingDecay(1e-3, T_max=10)
    m.prepare(pkg.optimizer.AdamW(lr, parameters=net, weight_decay=0.01),
              mod.GPTPretrainingCriterion())
    return m


def _fit(pkg, losses, ckpt_dir=None, stop_after=None, resume=None,
         snap=None):
    m = _model(pkg)

    class Rows(pkg.io.Dataset):
        def __len__(self):
            return IDS.shape[0]

        def __getitem__(self, i):
            return IDS[i], IDS[i]

    class Tap(pkg.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            if snap is not None and not snap:
                snap.update(_port_state(m))

        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"]))
            if stop_after is not None and len(losses) >= stop_after:
                raise RuntimeError("synthetic stop")
    kw = {}
    if ckpt_dir is not None:
        kw = dict(checkpoint_dir=ckpt_dir, checkpoint_freq=2,
                  resume=resume, async_checkpoint=False)
    m.fit(Rows(), batch_size=4, epochs=1, shuffle=False, verbose=0,
          callbacks=[Tap()], **kw)
    return m


def _port_state(m):
    """What the port's resumed Model holds before its first step."""
    return {"step": m._step_count,
            "lr": float(m._optimizer.lr_fn(m._step_count)),
            "params": {k: p.detach().numpy().copy() for k, p in
                       m.network.named_parameters()},
            "opt": {k: {n: t.numpy().copy() for n, t in v.items()}
                    for k, v in m._opt_state.items() if isinstance(v, dict)}}


@functools.lru_cache(maxsize=None)
def _jax_runs(tmp):
    """The stopped fit's checkpoint directory, its step-4 tree, and the
    uninterrupted fit's losses and step-4 lr."""
    d = os.path.join(tmp, "jax_ckpt")
    with pytest.raises(RuntimeError, match="synthetic stop"):
        _fit(jpt, [], ckpt_dir=d, stop_after=5)
    full = []
    jm = _fit(jpt, full)
    mgr = jckpt.CheckpointManager(d, async_save=False)
    tree = mgr.restore(4)
    mgr.close()
    return d, tree, tuple(full), float(jm._optimizer.lr_fn(jnp.asarray(4)))


def _copy_ckpt(src, dst):
    import shutil
    shutil.copytree(src, dst)
    return str(dst)


@pytest.mark.parametrize("where", ["beside", "out"])
def test_converted_step_resumes_bit_for_bit(tmp_path_factory, tmp_path,
                                            where):
    base, jtree, full, jlr = _jax_runs(str(tmp_path_factory.getbasetemp()))
    d = _copy_ckpt(base, tmp_path / "ckpt")
    with pytest.raises(NotImplementedError,
                       match="tools/torch_orbax_to_port.py"):
        tckpt.CheckpointManager(d, async_save=False).restore(4)
    out = str(tmp_path / "port") if where == "out" else None
    dest = conv.convert(d, out=out)
    assert dest == os.path.join(out or d, "4")
    resume_dir = out or d
    # the JAX package still restores the converted step, verified
    mgr = jckpt.CheckpointManager(d, async_save=False)
    assert jckpt.digest_tree(mgr.restore(4)) == jckpt.digest_tree(jtree)
    mgr.close()
    losses, snap = [], {}
    _fit(tpt, losses, ckpt_dir=resume_dir, resume="auto", snap=snap)
    assert snap["step"] == 4
    # the learning rate of step 5 as the update applies it (float32)
    assert np.float32(snap["lr"]) == np.float32(jlr)
    jparams = {k: np.asarray(v) for k, v in jtree["params"].items()}
    assert set(snap["params"]) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(snap["params"][k], v, err_msg=k)
    for moment in ("m", "v"):
        jm = jtree["opt"][moment]
        assert set(snap["opt"][moment]) == set(jm)
        for k, v in jm.items():
            np.testing.assert_array_equal(snap["opt"][moment][k],
                                          np.asarray(v), err_msg=k)
    assert len(losses) == 2
    np.testing.assert_allclose(losses, full[4:6], rtol=1e-5)


def test_a_step_that_does_not_verify_is_refused(tmp_path_factory,
                                                tmp_path, capsys):
    base, *_ = _jax_runs(str(tmp_path_factory.getbasetemp()))
    d = _copy_ckpt(base, tmp_path / "ckpt")
    path = os.path.join(d, "manifest-4.json")
    with open(path) as f:
        man = json.load(f)
    key = sorted(man["digests"])[3]
    man["digests"][key] = "0" * 32
    with open(path, "w") as f:
        json.dump(man, f)
    r = subprocess.run([sys.executable, TOOL, d, "--step", "4"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stderr
    assert "refused" in r.stderr and key in r.stderr
    assert not os.path.exists(os.path.join(d, "4", tckpt._TREE_FILE))
    # an intact step converts through the command's entry point
    assert conv.main([d, "--step", "2"]) == 0
    assert capsys.readouterr().out.strip() == os.path.join(d, "2")


def test_a_converted_leaf_that_rots_is_caught(tmp_path_factory, tmp_path):
    base, *_ = _jax_runs(str(tmp_path_factory.getbasetemp()))
    d = _copy_ckpt(base, tmp_path / "ckpt")
    out = str(tmp_path / "port")
    dest = conv.convert(d, step=4, out=out)
    leaf = os.path.join(dest, "leaf-00002.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0xFF
    open(leaf, "wb").write(bytes(raw))
    mgr = tckpt.CheckpointManager(out, async_save=False)
    with pytest.raises(tckpt.CheckpointCorrupt):
        mgr.restore(4)
    mgr.close()
