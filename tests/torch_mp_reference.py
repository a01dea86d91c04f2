"""The JAX package's side of the port's tensor- and pipeline-parallel
CPU tests: the tiny GPTs of ``tests/torch_mp_workers.py`` trained on
meshes of the virtual CPU devices (never installed as the global mesh),
each run cached for the test process."""

import dataclasses
import functools

import numpy as np

STEPS = 2


def ids(seq=16, n=STEPS, batch=4, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (n, batch, seq))


def e2e_ids():
    """tests/test_integration_e2e.py's first batches."""
    return np.stack([np.random.RandomState(100 + s).randint(0, 128, (4, 32))
                     for s in range(STEPS)])


def cfg(dropout=0.0, fused=True, layers=4, seq=16):
    from paddle_tpu.models.gpt import GPTConfig
    return GPTConfig(vocab_size=128, hidden_size=32, num_layers=layers,
                     num_heads=4, num_kv_heads=2,
                     max_position_embeddings=seq, hidden_dropout=dropout,
                     attention_dropout=dropout, use_flash=False,
                     fused_loss=fused)


def _mesh(axes):
    import jax
    from paddle_tpu import parallel
    n = int(np.prod([s for _, s in axes]))
    return parallel.DeviceMesh(devices=jax.devices()[:n], **dict(axes))


def _net(axes, pipe, **kw):
    import paddle_tpu as pt
    from paddle_tpu.models.gpt import GPTForCausalLM, GPTForCausalLMPipe
    pt.seed(0)
    if pipe is None:
        return GPTForCausalLM(cfg(**kw))
    return GPTForCausalLMPipe(cfg(**kw), pipe[0], pipe[1],
                              mesh=_mesh(axes))


def _state(net):
    return {k: np.asarray(v) for k, v in net.state_dict().items()}


@functools.lru_cache(maxsize=None)
def weights(pipe_v=None, layers=4, seq=16):
    """The initial weights (``seed(0)``): a dense GPT, or a pp=2 pipe of
    ``virtual_pp_degree`` ``pipe_v``."""
    if pipe_v is None:
        return _state(_net((), None, layers=layers, seq=seq))
    return _state(_net((("pp", 2),), (1, pipe_v), layers=layers, seq=seq))


@functools.lru_cache(maxsize=None)
def run(axes, dropout=0.0, pipe=None, fused=True, seq=16, batches="tiny"):
    """Losses and final state of STEPS ``train_batch`` calls on the mesh
    ``axes`` (``((name, size), ...)``); ``pipe`` ``(microbatches, v)``
    trains a GPTForCausalLMPipe."""
    import paddle_tpu as pt
    from paddle_tpu import parallel
    from paddle_tpu.models.gpt import (GPTFusedPretrainingCriterion,
                                       GPTPretrainingCriterion)
    net = _net(axes, pipe, dropout=dropout, fused=fused, seq=seq)
    model = pt.Model(net)
    model.prepare(optimizer=pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=net, weight_decay=0.01),
        loss=GPTFusedPretrainingCriterion() if fused
        else GPTPretrainingCriterion())
    parallel.distributed_model(model, mesh=_mesh(axes))
    data = e2e_ids() if batches == "e2e" else ids(seq)
    losses = [float(model.train_batch([data[i]], [data[i]])["loss"])
              for i in range(len(data))]
    model.sync_weights()
    return losses, _state(net)


def load_into_jax(path, pipe_v=None):
    """A saved ``.pdparams`` loaded into a fresh JAX Model (the dense GPT
    or a pp=2 pipe): its state."""
    import paddle_tpu as pt
    net = _net((("pp", 2),) if pipe_v else (), (1, pipe_v)
               if pipe_v else None)
    model = pt.Model(net)
    model.load(path, reset_optimizer=True)
    model.sync_weights()
    return _state(net)


@functools.lru_cache(maxsize=None)
def replan(ratio, chip_items, first_chip_items, first_axes):
    """The JAX package's verify_plan on the 2-layer GPT planned for two
    devices under the ChipSpec ``first_chip_items`` (the layout
    ``first_axes``): a step, the measured step (a step
    whose bytes are ``ratio`` x the prediction), the re-plan under the
    ChipSpec ``chip_items``, a step. The new mesh is recorded, not
    installed (two of the eight virtual devices), so the steps run on
    one device: the layout does not change the numbers. Returns the
    losses, the new axes, the report and the trained state."""
    import paddle_tpu as pt
    from paddle_tpu.models.gpt import GPTFusedPretrainingCriterion
    from paddle_tpu.parallel import api as japi
    from paddle_tpu.parallel import mesh as jmesh
    from paddle_tpu.parallel import planner as jplan
    net = _net((), None, layers=2)
    model = pt.Model(net)
    model.prepare(optimizer=pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=net, weight_decay=0.01),
        loss=GPTFusedPretrainingCriterion())
    data = ids(n=3)
    names = {f.name for f in dataclasses.fields(jplan.ChipSpec)}

    def spec(items):   # the fields the JAX package's ChipSpec has
        return jplan.ChipSpec(**{k: v for k, v in items if k in names})
    chip = spec(chip_items)
    first = jplan.plan(net, 2, global_batch=4, seq_len=16,
                       chip=spec(first_chip_items))
    assert first.axes == dict(first_axes), (first.axes, first_axes)
    model._plan = first
    model._planner_ctx = {"n_devices": 2, "global_batch": 4,
                          "seq_len": 16, "rules": None, "chip": None,
                          "act_dtype_bytes": None}
    losses = [float(model.train_batch([data[0]], [data[0]])["loss"])]

    def measured(m, inputs, labels=()):
        losses.append(float(m.train_batch(list(inputs),
                                          list(labels))["loss"]))
        return ratio * first.hbm_bytes
    saved = (jplan.measured_step_bytes, japi.distributed_model,
             jmesh.init_mesh_from_axes)
    installed = []
    jplan.measured_step_bytes = measured
    jmesh.init_mesh_from_axes = dict
    japi.distributed_model = lambda m, mesh=None, rules=None: \
        installed.append(mesh)
    try:
        report, new = jplan.verify_plan(model, [data[1]], [data[1]],
                                        chip=chip)
    finally:
        (jplan.measured_step_bytes, japi.distributed_model,
         jmesh.init_mesh_from_axes) = saved
    losses.append(float(model.train_batch([data[2]], [data[2]])["loss"]))
    model.sync_weights()
    return losses, dict(new.axes), installed, report, _state(net)


# ---------------------------------------------------------------------------
# sequence parallelism (tests/test_torch_ring_attention.py): the JAX
# package's ring on meshes of the virtual CPU devices; its GPT on an
# installed sp mesh (GPTAttention reads the installed mesh)
# ---------------------------------------------------------------------------

def _sp_mesh(axes, install=False):
    import jax
    from paddle_tpu import parallel
    n = int(np.prod([s for _, s in axes]))
    if install:
        return parallel.init_mesh(devices=jax.devices()[:n], **dict(axes))
    return parallel.DeviceMesh(devices=jax.devices()[:n], **dict(axes))


@functools.lru_cache(maxsize=None)
def ring_op(sp, name, grad=False):
    """The JAX ring's output (or its dq, dk, dv) on the ring case
    ``name`` of ``tests/torch_sp_workers.py`` at ``sp``."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.ring_attention import ring_attention
    import torch_sp_workers as S
    case = (S.GRAD_CASES if grad else S.OP_CASES)[name]
    q, k, v = (jnp.asarray(x) for x in S.qkv(**case))
    kpm = jnp.asarray(S.key_padding(**case)) if case.get("kpm") else None
    p = case.get("dropout", 0.0)
    key = jax.random.PRNGKey(case.get("key", 7))
    mesh = _sp_mesh((("sp", sp),))

    def f(q, k, v, kpm, key):
        return ring_attention(q, k, v, causal=case["causal"], mesh=mesh,
                              chunk_size=case.get("chunk"),
                              key_padding_mask=kpm, dropout_p=p,
                              dropout_key=key if p else None)
    if not grad:
        return np.asarray(jax.jit(f)(q, k, v, kpm, key))

    def loss(q, k, v):
        o = f(q, k, v, kpm, key)
        return jnp.sum(o * jnp.cos(o)) if case.get("loss") == "cos" \
            else jnp.sum(o ** 2)
    return [np.asarray(g) for g in
            jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]


def _sp_gpt_net(kind="gpt", **run):
    import paddle_tpu as pt
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM, llama_config
    import torch_sp_workers as S
    pt.seed(0)
    kw = S.gpt_cfg_kw(kind, **run)
    return GPTForCausalLM(llama_config(**kw) if kind == "llama"
                          else GPTConfig(**kw))


@functools.lru_cache(maxsize=None)
def sp_weights(kind="gpt"):
    """The initial weights (``seed(0)``) of the sp GPT (or LLaMA)."""
    return _state(_sp_gpt_net(kind))


@functools.lru_cache(maxsize=None)
def sp_gpt(axes, name):
    """The losses of the GPT run ``name`` of ``tests/torch_sp_workers.py``
    on the installed mesh ``axes``."""
    import paddle_tpu as pt
    from paddle_tpu import parallel
    from paddle_tpu.models.gpt import GPTPretrainingCriterion
    import torch_sp_workers as S
    run = S.GPT_RUNS[name]
    net = _sp_gpt_net(**{k: v for k, v in run.items() if k != "mask"})
    m = pt.Model(net)
    m.prepare(optimizer=pt.optimizer.AdamW(learning_rate=1e-3,
                                           parameters=net),
              loss=GPTPretrainingCriterion())
    mesh = _sp_mesh(axes, install=True)
    try:
        parallel.distributed_model(m, mesh=mesh)
        feed, labels = S.gpt_feed(run)
        return [float(m.train_batch(feed, labels)["loss"])
                for _ in range(S.STEPS)]
    finally:
        parallel.set_mesh(None)


@functools.lru_cache(maxsize=None)
def sp_dense_forward(pad):
    """The JAX dense (single-device) eval forward of the sp config on
    ``[2, 16]`` ids with a key-padding mask (``pad`` "left" or "right"),
    and without one."""
    import jax.numpy as jnp
    net = _sp_gpt_net()
    net.eval()
    ids = jnp.asarray(np.random.RandomState(0).randint(0, 64, (2, 16)))
    kpm = np.ones((2, 16), bool)
    if pad == "left":
        kpm[:, :4] = False
    else:
        kpm[:, 12:] = False
    return (np.asarray(net(ids, attn_mask=jnp.asarray(kpm))),
            np.asarray(net(ids)))
