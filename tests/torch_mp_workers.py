"""Rank bodies of the port's tensor- and pipeline-parallel CPU tests
(``tests/test_torch_{tensor_parallel,pipeline,planner}.py``), run by
``torch_dist_workers``' harness (one fresh interpreter a rank, gloo over
a ``FileStore`` in the test's directory). Imports no JAX.

    python tests/torch_mp_workers.py <fn> <rank> <world> <dir>
"""

import os
import pickle
import sys

import numpy as np

import torch_dist_workers as W

STEPS = 2


def cfg(dropout=0.0, fused=True, layers=4, seq=16, heads=4, kv=2):
    """The tiny GPT of these tests (GQA: 4 heads on 2 kv heads)."""
    from paddle_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=128, hidden_size=32, num_layers=layers,
                     num_heads=heads, num_kv_heads=kv,
                     max_position_embeddings=seq, hidden_dropout=dropout,
                     attention_dropout=dropout, use_flash=False,
                     fused_loss=fused)


def model_of(net, weights=None, opt="adamw", fused=True):
    """A prepared Model on ``net`` (loaded with ``weights``)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.interop import load_reference_state
    from paddle_tpu_torch.models.gpt import (GPTFusedPretrainingCriterion,
                                             GPTPretrainingCriterion)
    if weights is not None:
        load_reference_state(net, weights)
    opts = {
        "adamw": lambda: optimizer.AdamW(1e-3, parameters=net,
                                         weight_decay=0.01),
        "lamb": lambda: optimizer.Lamb(1e-3, parameters=net),
        "adafactor": lambda: optimizer.Adafactor(1e-3, parameters=net),
        "lars": lambda: optimizer.LarsMomentum(0.1, parameters=net),
        # plain SGD: the clipped gradient reaches the parameters
        # linearly (Adam would normalize the clip's scale away)
        "clip": lambda: optimizer.SGD(
            0.1, parameters=net, grad_clip=nn.ClipGradByNorm(0.01)),
    }
    m = ptt.Model(net)
    m.prepare(optimizer=opts[opt](),
              loss=GPTFusedPretrainingCriterion() if fused
              else GPTPretrainingCriterion())
    return m


def dense_net(weights, **kw):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    ptt.seed(0)
    net = GPTForCausalLM(cfg(**kw), device="cpu")
    from paddle_tpu_torch.interop import load_reference_state
    load_reference_state(net, weights)
    return net


def pipe_net(weights, mesh, m, v, **kw):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.interop import load_reference_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe
    ptt.seed(0)
    net = GPTForCausalLMPipe(cfg(**kw), m, v, mesh=mesh, device="cpu")
    load_reference_state(net, weights)
    return net


def steps(model, ids, labels=None, n=STEPS):
    labels = ids if labels is None else labels
    out = [float(model.train_batch([ids[i]], [labels[i]])["loss"])
           for i in range(n)]
    model.drain_metrics()
    return out


def full_state(model):
    """The network's whole state in the JAX layouts (tp slices and pp
    stages gathered: a collective)."""
    with model._unsharded():
        sd = model.network.state_dict()
        if model._sync is not None:
            sd = model._sync.full_tree(sd, fsdp=False)
        return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _resume(make, ids, d, tag):
    """fit over two epochs uninterrupted, against one epoch checkpointed
    and a fresh Model resuming: both loss lists."""
    full, part = [], []
    W._fit(make(), ids, 2, full)
    ck = os.path.join(d, f"ckpt_{tag}")
    W._fit(make(), ids, 1, part, checkpoint_dir=ck, async_checkpoint=False)
    W._fit(make(), ids, 2, part, checkpoint_dir=ck, resume="auto",
           async_checkpoint=False)
    return full, part


# ---------------------------------------------------------------------------
# tensor parallelism (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------

def tp2(rank, world, d, args):
    import torch
    parallel = W._init(rank, world, d)
    w = _load(args["weights"])
    ids = np.asarray(args["ids"])
    res = {}
    mesh = parallel.DeviceMesh(tp=2)
    # the losses at dropout 0 and 0.1, the gathered state, the grads of
    # tp-replicated parameters before the reduction
    for dropout in (0.0, 0.1):
        m = model_of(dense_net(w, dropout=dropout))
        parallel.distributed_model(m, mesh=mesh)
        sync = m._mesh_sync()
        if dropout == 0.0:
            res["roundtrip"] = full_state(m)     # before any step
            res["local_shapes"] = {k: tuple(p.shape) for k, p in
                                   m.network.named_parameters()}
            seen = {}
            reduce = sync.reduce

            def record(grads, loss, weighted, seen=seen, reduce=reduce):
                if not seen:
                    seen.update({k: g.detach().numpy().copy()
                                 for k, g in grads.items()
                                 if k not in sync.pieces})
                return reduce(grads, loss, weighted)
            sync.reduce = record
        res[f"losses_{dropout}"] = steps(m, ids)
        res[f"state_{dropout}"] = full_state(m)
        if dropout == 0.0:
            res["replicated_grads"] = seen
            path = os.path.join(d, "tp2_saved")
            m.save(path)
            torch.distributed.barrier()
            m2 = model_of(dense_net(w))
            parallel.distributed_model(m2, mesh=mesh)
            m2.load(path)
            res["reloaded"] = full_state(m2)
            res["reloaded_next"] = [steps(x, ids[:1], n=1)[0]
                                    for x in (m, m2)]
    # the vocab-parallel fused loss on its own
    res["fused"] = _fused_parts(mesh)
    # per-tensor norms under tp and fsdp, against one process
    for opt in ("lamb", "adafactor", "lars", "clip"):
        for axis in ("tp", "fsdp"):
            m = model_of(dense_net(w), opt=opt)
            parallel.distributed_model(
                m, mesh=parallel.DeviceMesh(**{axis: 2}))
            res[f"{opt}_{axis}"] = (steps(m, ids), full_state(m))
        m = model_of(dense_net(w), opt=opt)
        res[f"{opt}_one"] = (steps(m, ids), full_state(m))
    # a fit stopped after an epoch and resumed on the tp mesh
    flat = ids.reshape(-1, ids.shape[-1])

    def make():
        m = model_of(dense_net(w))
        parallel.distributed_model(m, mesh=mesh)
        return m
    res["resume_full"], res["resume_parts"] = _resume(make, flat, d, "tp")
    # remat under dp=2 at dropout 0.1: the recompute in the backward
    # draws the rank's rows of the masks again (after the rows scope of
    # the forward closed)
    for remat in (False, True):
        m = model_of(dense_net(w, dropout=0.1))
        m.network.cfg.remat = remat
        parallel.distributed_model(m, mesh=parallel.DeviceMesh(dp=2))
        res[f"dp_remat_{remat}"] = (steps(m, ids), full_state(m))
    # fleet's hybrid_configs.mp_degree reaches the mesh
    from paddle_tpu_torch.distributed import fleet
    strat = parallel.DistributedStrategy()
    strat.hybrid_configs.mp_degree = 2
    fleet.init(is_collective=True, strategy=strat, backend="gloo",
               device="cpu")
    m = model_of(dense_net(w))
    fleet.distributed_model(m)
    res["fleet_axes"] = dict(m._mesh.axis_sizes)
    res["fleet_loss"] = steps(m, ids, n=1)
    parallel.set_mesh(None)
    torch.distributed.barrier()
    return res


def _fused_parts(mesh):
    """The vocab-parallel fused loss of fixed inputs: loss, dh and this
    rank's dW, and the widest logits block any call formed."""
    import torch
    from paddle_tpu_torch.ops import fused_xent as fx
    from paddle_tpu_torch.parallel.collective import TPGroup
    tp = TPGroup(mesh)
    rs = np.random.RandomState(3)
    h = torch.tensor(rs.randn(12, 32).astype(np.float32),
                     requires_grad=True)
    full = rs.randn(128, 32).astype(np.float32) * 0.3
    labels = torch.tensor([5, 70, 127, 0, 64, 63, -100, 100, 1, -100, 90,
                           30])
    w = torch.tensor(np.split(full, 2)[tp.index].copy(), requires_grad=True)
    widths = []
    orig = fx._chunk_logits

    def spy(*a):
        out = orig(*a)
        widths.append(out.shape[1])
        return out
    fx._chunk_logits = spy
    try:
        loss = fx.fused_linear_cross_entropy(h, w, labels, chunk=24, tp=tp)
        loss.backward()
    finally:
        fx._chunk_logits = orig
    return {"loss": float(loss), "dh": h.grad.numpy(), "dw": w.grad.numpy(),
            "max_width": max(widths), "inputs": (h.detach().numpy(), full,
                                                 labels.numpy())}


def dptp(rank, world, d, args):
    """dp=2 x tp=2 and pp=2 x tp=2 on four ranks."""
    import torch
    parallel = W._init(rank, world, d)
    w = _load(args["weights"])
    ids = np.asarray(args["ids"])
    res = {}
    mesh = parallel.DeviceMesh(dp=2, tp=2)
    for dropout in (0.0, 0.1):
        m = model_of(dense_net(w, dropout=dropout))
        parallel.distributed_model(m, mesh=mesh)
        res[f"dptp_losses_{dropout}"] = steps(m, ids)
        res[f"dptp_state_{dropout}"] = full_state(m)
    # the capstone's mesh without its dp axis (tests/test_integration_
    # e2e.py: 4 layers, seq 32, 2 microbatches, the dense criterion)
    pw = _load(args["e2e_weights"])
    e2e_ids = np.asarray(args["e2e_ids"])
    mesh = parallel.DeviceMesh(pp=2, tp=2)
    m = model_of(pipe_net(pw, mesh, 2, 1, seq=32, fused=False),
                 fused=False)
    parallel.distributed_model(m, mesh=mesh)
    res["pptp_losses"] = steps(m, e2e_ids, n=len(e2e_ids))
    res["pptp_state"] = full_state(m)
    torch.distributed.barrier()
    return res


# ---------------------------------------------------------------------------
# pipeline parallelism and LocalSGD (tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------

PP_RUNS = ((1, 1, 0.0), (4, 1, 0.0), (2, 2, 0.0), (2, 1, 0.1), (4, 2, 0.1))
DPPP_DROPOUT = 0.1   # the dp=2 x pp=2 run: 2 microbatches, v 1


def dppp(rank, world, d, args):
    """dp=2 x pp=2 at dropout 0.1 on four ranks: each data rank's rows
    are its slice of each microbatch, and so are its rows of the
    chunks' masks."""
    import torch
    parallel = W._init(rank, world, d)
    w = _load(args["weights_v1"])
    ids = np.asarray(args["ids"])
    mesh = parallel.DeviceMesh(pp=2, dp=2)
    m = model_of(pipe_net(w, mesh, 2, 1, dropout=DPPP_DROPOUT))
    parallel.distributed_model(m, mesh=mesh)
    res = {"losses": steps(m, ids), "state": full_state(m)}
    # predictions come back in the global batch's row order
    m.network.eval()
    res["predict"] = m.predict_batch([ids[0]]).detach().numpy()
    torch.distributed.barrier()
    return res


def pp2(rank, world, d, args):
    import torch
    parallel = W._init(rank, world, d)
    ids = np.asarray(args["ids"])
    res = {}
    mesh = parallel.DeviceMesh(pp=2)
    for mb, v, dropout in PP_RUNS:
        w = _load(args[f"weights_v{v}"])
        m = model_of(pipe_net(w, mesh, mb, v, dropout=dropout))
        parallel.distributed_model(m, mesh=mesh)
        res[(mb, v, dropout)] = (steps(m, ids), full_state(m))
        if (mb, v) == (4, 1) and dropout == 0.0:
            path = os.path.join(d, "pp2_saved")
            m.save(path)
            torch.distributed.barrier()
    # a fit stopped after an epoch and resumed on the pp mesh
    w = _load(args["weights_v1"])
    flat = ids.reshape(-1, ids.shape[-1])

    def make():
        m = model_of(pipe_net(w, mesh, 2, 1))
        parallel.distributed_model(m, mesh=mesh)
        return m
    res["resume_full"], res["resume_parts"] = _resume(make, flat, d, "pp")
    # evaluate and predict: the global rows and loss
    m = make()
    steps(m, ids, n=1)
    res["predict"] = m.predict_batch([ids[0]])
    if isinstance(res["predict"], torch.Tensor):
        res["predict"] = res["predict"].numpy()
    res["eval_loss"] = float(m.eval_batch([ids[0]], [ids[0]])["loss"])
    res["eval_state"] = full_state(m)
    # LocalSGD over dp=2
    res["localsgd"] = _local_sgd(parallel, args)
    torch.distributed.barrier()
    return res


def local_sgd_fns(lr=0.1):
    """tests/test_quant_localsgd.py's grad and update functions."""
    import torch

    def grad_fn(params, batch):
        x, y = batch
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        h = torch.clamp(x @ p["w1"], min=0.0)
        loss = ((h @ p["w2"] - y) ** 2).mean()
        g = torch.autograd.grad(loss, [p["w1"], p["w2"]])
        return loss.detach(), {"w1": g[0], "w2": g[1]}

    def update_fn(params, grads):
        return {k: params[k] - lr * grads[k] for k in params}
    return grad_fn, update_fn


def _local_sgd(parallel, args):
    import torch
    mesh = parallel.DeviceMesh(dp=2)
    x, y = (torch.tensor(np.asarray(a, np.float32))
            for a in (args["lsgd_x"], args["lsgd_y"]))
    p0 = {k: torch.tensor(np.asarray(v, np.float32))
          for k, v in args["lsgd_params"].items()}
    grad_fn, update_fn = local_sgd_fns()
    out = {}
    for k, n in ((1, 3), (4, 4)):
        params = parallel.replicate_params(p0, mesh)
        step = parallel.build_local_sgd_step(grad_fn, update_fn,
                                             sync_every=k, mesh=mesh)
        losses = []
        for i in range(n):
            params, loss = step(params, (x, y), i)
            losses.append(float(loss))
        out[k] = ({n_: v.numpy() for n_, v in params.items()},
                  {n_: v.numpy() for n_, v in
                   parallel.unreplicate_params(params, mesh).items()},
                  losses)
    return out


def planner2(rank, world, d, args):
    """distributed_model(global_batch=...) on two ranks."""
    import torch
    parallel = W._init(rank, world, d)
    w = _load(args["weights"])
    ids = np.asarray(args["ids"])
    m = model_of(dense_net(w, layers=2))
    parallel.distributed_model(m, global_batch=ids.shape[1],
                               seq_len=ids.shape[2])
    res = {"axes": dict(m._plan.axes), "fits": m._plan.fits,
           "mesh": dict(m._mesh.axis_sizes), "losses": steps(m, ids)}
    parallel.set_mesh(None)
    torch.distributed.barrier()
    return res


def replan2(rank, world, d, args):
    """verify_plan re-planning a Model already split over the planner's
    mesh: a step, the measured step (its bytes given: ``ratio`` x the
    prediction), the re-plan onto the new mesh, a step there."""
    import torch
    from paddle_tpu_torch.parallel import planner
    parallel = W._init(rank, world, d)
    w = _load(args["weights"])
    ids = np.asarray(args["ids"])
    m = model_of(dense_net(w, layers=2))
    parallel.distributed_model(m, global_batch=ids.shape[1],
                               seq_len=ids.shape[2])
    res = {"first_axes": dict(m._plan.axes)}
    losses = [float(m.train_batch([ids[0]], [ids[0]])["loss"])]
    predicted = m._plan.hbm_bytes

    def measured(model, inputs, labels=()):
        losses.append(float(model.train_batch(list(inputs),
                                               list(labels))["loss"]))
        return args["ratio"] * predicted
    planner.measured_step_bytes = measured
    report, new = planner.verify_plan(
        m, [ids[1]], [ids[1]], chip=planner.ChipSpec(**args["chip"]))
    losses.append(float(m.train_batch([ids[2]], [ids[2]])["loss"]))
    res.update(axes=dict(new.axes), report=report, losses=losses,
               mesh={k: v for k, v in m._mesh.axis_sizes.items() if v > 1},
               sharded=sorted(m._sync.sharded), state=full_state(m))
    parallel.set_mesh(None)
    torch.distributed.barrier()
    return res


if __name__ == "__main__":
    W.main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           globals())
