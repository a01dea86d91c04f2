"""The JAX package's side of the port's tensor- and pipeline-parallel
CPU tests: the tiny GPTs of ``tests/torch_mp_workers.py`` trained on
meshes of the virtual CPU devices (never installed as the global mesh),
each run cached for the test process."""

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
