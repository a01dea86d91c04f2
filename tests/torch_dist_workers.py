"""Rank bodies of the port's multi-rank CPU tests and the harness that
runs them: ``run_ranks`` starts one fresh interpreter a rank (gloo over
a ``FileStore`` in the test's own directory, so parallel test workers
never share a port), waits with a timeout, kills stragglers, and returns
each rank's pickled result. Imports no JAX: the ranks run the port only.

    python tests/torch_dist_workers.py <fn> <rank> <world> <dir> <args.json>
"""

import json
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def start_ranks(fn: str, world: int, tmp_path, args=None, script=None):
    """Start ``fn(rank, world, dir, args)`` of this module (or of the
    worker file ``script``, whose ``__main__`` calls :func:`main` with its
    globals) on ``world`` gloo CPU ranks; :func:`collect` waits for
    them."""
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{fn}.args.json"), "w") as f:
        json.dump(args or {}, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]),
               OMP_NUM_THREADS="1")
    script = os.path.abspath(script or __file__)
    procs = [subprocess.Popen(
        [sys.executable, script, fn, str(r), str(world), d], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    return fn, world, d, procs


def run_ranks(fn: str, world: int, tmp_path, args=None,
              timeout: float = 240.0):
    """Run ``fn`` on ``world`` ranks; returns their results (rank
    order)."""
    return collect(start_ranks(fn, world, tmp_path, args), timeout)


def collect(handle, timeout: float = 240.0):
    """Each rank's pickled result, after waiting at most ``timeout``
    seconds in all (stragglers are killed and fail the call)."""
    fn, world, d, procs = handle
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{fn}: rank timed out")
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{fn} rank {r} exited " \
                                  f"{p.returncode}:\n{out[-4000:]}"
    res = []
    for r in range(world):
        with open(os.path.join(d, f"{fn}.rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _init(rank, world, d):
    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch import parallel
    parallel.init_parallel_env(f"file://{d}/store", world, rank,
                               backend="gloo", device="cpu")
    return parallel


# ---------------------------------------------------------------------------
# collectives (parallel.collective, distributed.comm)
# ---------------------------------------------------------------------------

def stacked_input(world, seed=0, shape=(4, 6)):
    return np.random.RandomState(seed).randn(world, *shape).astype(
        np.float32)


def collectives(rank, world, d, args):
    import torch
    parallel = _init(rank, world, d)
    from paddle_tpu_torch.parallel import collective as C
    parallel.init_mesh(dp=world)
    x = torch.from_numpy(stacked_input(world)[rank])
    perm = [(i, (i + 1) % world) for i in range(world - 1)]  # no wrap
    out = {
        "psum": C.psum(x, "dp"), "pmean": C.pmean(x, "dp"),
        "pmax": C.pmax(x, "dp"), "pmin": C.pmin(x, "dp"),
        "all_gather": C.all_gather(x, "dp"),
        "all_gather_untiled": C.all_gather(x, "dp", tiled=False),
        "all_gather_dim1": C.all_gather(x, "dp", gather_dim=1),
        "reduce_scatter": C.reduce_scatter(x, "dp"),
        "reduce_scatter_dim1": C.reduce_scatter(
            torch.cat([x] * world, dim=1), "dp", scatter_dim=1),
        "all_to_all": C.all_to_all(x, "dp", split_dim=0, concat_dim=1),
        "ppermute": C.ppermute(x, "dp", perm),
        "shift": C.shift(x, "dp"),
        "shift_back": C.shift(x, "dp", -1),
        "axis_index": torch.tensor([C.axis_index("dp")]),
        "axis_size": torch.tensor([C.axis_size("dp")]),
        "broadcast": C.broadcast(x, "dp", src=world - 1),
        "quantized_ring_allreduce": C.quantized_ring_allreduce(x, "dp"),
        "quantized_ring_allreduce_4bit": C.quantized_ring_allreduce(
            x, "dp", bits=4),
    }
    return {k: v.numpy() for k, v in out.items()}


def comm_calls(rank, world, d, args):
    import torch
    _init(rank, world, d)
    from paddle_tpu_torch.distributed import comm
    st = stacked_input(world, seed=1, shape=(world, 3))
    x = torch.from_numpy(st[rank])       # this rank's [group, 3] slice
    out = {
        "reduce_sum": comm.reduce(x, 1, comm.ReduceOp.SUM),
        "reduce_max": comm.reduce(x, 0, comm.ReduceOp.MAX),
        "reduce_avg": comm.reduce(x, 0, comm.ReduceOp.AVG),
        "reduce_scatter": comm.reduce_scatter(x),
        "reduce_scatter_min": comm.reduce_scatter(x, op=comm.ReduceOp.MIN),
        "scatter": comm.scatter(torch.from_numpy(st[0]), src=0),
        "scatter_list": comm.scatter(None, [torch.from_numpy(st[1][i])
                                            for i in range(world)], src=1),
        "alltoall": comm.alltoall(x),
        "alltoall_list": comm.alltoall([x[i] for i in range(world)]),
        "split": comm.split(torch.arange(16.).reshape(2, 8), world,
                            axis=1),
    }
    # point to point: rank r sends its slice to r + 1, receives r - 1's
    dst, src = (rank + 1) % world, (rank - 1) % world
    if rank % 2 == 0:
        comm.send(x, dst)
        got = comm.recv(torch.empty_like(x), src)
    else:
        got = comm.recv(torch.empty_like(x), src)
        comm.send(x, dst)
    out["send_recv"] = got
    task = comm.isend(x * 2, dst)
    got2 = comm.irecv(torch.empty_like(x), src).wait()
    task.wait()
    out["isend_irecv"] = got2
    g = comm.new_group(list(range(world)))
    out["group_reduce"] = comm.reduce(x, 0, group=g)
    env = comm.ParallelEnv()
    meta = {"rank": env.rank, "world_size": env.world_size,
            "nranks": env.nranks, "initialized": comm.is_initialized(),
            "group_nranks": g.nranks}
    comm.gloo_barrier()
    res = {k: v.numpy() for k, v in out.items()}
    res["meta"] = meta
    return res


def fleet_calls(rank, world, d, args):
    """The fleet facade on gloo ranks (tests/test_fleet.py's scenarios):
    init and the worker queries, distributed_model of a Layer and of a
    hapi Model, distributed_optimizer, the parameter-server calls."""
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn, optimizer, parallel
    from paddle_tpu_torch.distributed import fleet
    torch.set_num_threads(1)
    # the launcher's environment (distributed.launch.trainer_env)
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world))
    strat = parallel.DistributedStrategy()
    fleet.init(is_collective=True, strategy=strat, backend="gloo",
               device="cpu", coordinator_address=f"file://{d}/store")
    res = {"worker_num": fleet.worker_num(),
           "worker_index": fleet.worker_index(),
           "is_first_worker": fleet.is_first_worker(),
           "is_worker": fleet.is_worker(),
           "backend": torch.distributed.get_backend()}
    ptt.seed(0)
    wrapped = fleet.distributed_model(nn.Linear(4, 2))
    res["layer_wrapped"] = type(wrapped).__name__
    res["layer_out"] = tuple(wrapped(torch.ones(8, 4)).shape)
    ptt.seed(0)
    net = nn.Linear(4, 2)
    model = ptt.Model(net)
    model.prepare(optimizer=optimizer.SGD(0.1, parameters=net),
                  loss=lambda out, y: ((out - y) ** 2).mean())
    res["model_same"] = fleet.distributed_model(model) is model
    res["model_mesh"] = model._mesh is not None
    res["model_loss"] = float(model.train_batch(
        [np.ones((8, 4), np.float32)], [np.zeros((8, 2), np.float32)])[
        "loss"])
    opt = fleet.distributed_optimizer(optimizer.SGD(0.1, parameters=net))
    res["opt_strategy"] = opt._fleet_strategy is strat
    res["get_strategy"] = fleet.get_strategy() is strat
    raised = []
    for fn in (fleet.init_worker, fleet.init_server, fleet.run_server,
               fleet.stop_worker):
        try:
            fn()
        except NotImplementedError as e:
            raised.append("collective" in str(e))
    res["ps_raises"] = raised
    fleet.barrier_worker()
    return res


# ---------------------------------------------------------------------------
# training (hapi Model on a mesh, DataParallel)
# ---------------------------------------------------------------------------

def _tiny_gpt(weights, dropout=0.0, guard=False):
    """The tiny GPT of the JAX package's tests/dist_worker.py on the
    given weights."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.interop import load_reference_state
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTPretrainingCriterion)
    ptt.seed(0)
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=2, max_position_embeddings=16,
                    hidden_dropout=dropout, attention_dropout=0.0,
                    use_flash=False)
    net = GPTForCausalLM(cfg, device="cpu")
    load_reference_state(net, weights)
    model = ptt.Model(net)
    model.prepare(optimizer=optimizer.AdamW(
        learning_rate=1e-3, parameters=net, weight_decay=0.01),
        loss=GPTPretrainingCriterion(), numeric_guard=True if guard
        else None)
    return model


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _params(model):
    """Every trainable tensor as numpy (the full values)."""
    with model._unsharded():
        return {k: p.detach().numpy().copy()
                for k, p in model._trainable().items()}


def _fit(model, ids, epochs, losses, **kw):
    from paddle_tpu_torch.callbacks import Callback
    from paddle_tpu_torch.io import Dataset

    class Rows(Dataset):
        def __len__(self):
            return ids.shape[0]

        def __getitem__(self, i):
            return ids[i], ids[i]

    class Record(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"]))
    model.fit(Rows(), batch_size=4, epochs=epochs, shuffle=False,
              verbose=0, callbacks=[Record()], **kw)


def train(rank, world, d, args):
    """Every training scenario of tests/test_torch_dist_train.py on one
    process group, in order; each records its numbers."""
    import torch
    parallel = _init(rank, world, d)
    from paddle_tpu_torch.reliability import faults
    w = _load(args["weights"])
    ids = np.asarray(args["ids"])
    res = {}
    mesh_of = {}

    def mesh(axis):
        if axis not in mesh_of:
            mesh_of[axis] = parallel.DeviceMesh(**{axis: world})
        return mesh_of[axis]

    def steps(model, n=6):
        out = [float(model.train_batch([ids[i]], [ids[i]])["loss"])
               for i in range(n)]
        model.drain_metrics()
        return out

    # dp and fsdp against the JAX package's two-device meshes
    for axis in ("dp", "fsdp"):
        m = _tiny_gpt(w)
        parallel.distributed_model(m, mesh=mesh(axis))
        res[f"{axis}_losses"] = steps(m)
        res[f"{axis}_params"] = _params(m)
        name = "gpt.layers.0.mlp.fc_in.weight"
        res[f"{axis}_local_shape"] = tuple(
            (m._sync.shards.get(name) if m._sync.shards else
             m.network.get_parameter(name)).shape)
        res[f"{axis}_opt_bytes"] = sum(
            t.numel() * t.element_size() for t in
            m._opt_state["m"].values())
        # .pdparams / .pdopt of the whole state (rank 0 writes), loaded
        # into a fresh Model on the same mesh
        path = os.path.join(d, f"saved_{axis}")
        m.save(path)
        torch.distributed.barrier()
        m2 = _tiny_gpt(w)
        parallel.distributed_model(m2, mesh=mesh(axis))
        m2.load(path)
        res[f"{axis}_reloaded_params"] = _params(m2)
        res[f"{axis}_reloaded_next"] = [
            float(x.train_batch([ids[0]], [ids[0]])["loss"])
            for x in (m, m2)]
    # a loss mask whose count differs between the ranks' rows: each
    # rank's loss weighted by its count over the global count
    labels = np.asarray(args["masked_labels"])
    m = _tiny_gpt(w)
    parallel.distributed_model(m, mesh=mesh("dp"))
    res["masked_losses"] = [
        float(m.train_batch([ids[i]], [labels[i]])["loss"])
        for i in range(len(ids))]
    # fsdp's global norms: ClipGradByGlobalNorm and the numeric guard
    # over shards, against the same run under dp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    for axis in ("dp", "fsdp"):
        m = _tiny_gpt(w, guard=True)
        m._optimizer.grad_clip = ClipGradByGlobalNorm(0.05)
        parallel.distributed_model(m, mesh=mesh(axis))
        losses, gnorms = [], []
        for i in range(len(ids)):
            losses.append(float(m.train_batch([ids[i]], [ids[i]])["loss"]))
            # the guard's global grad norm of the step, still buffered
            gnorms.append(float(m._guard_pending[-1][1]))
        m.drain_metrics()
        res[f"clip_{axis}_losses"] = losses
        res[f"clip_{axis}_gnorms"] = gnorms
        res[f"clip_{axis}_params"] = _params(m)
    # residual dropout 0.1: the rank's rows of the global mask
    m = _tiny_gpt(w, dropout=0.1)
    parallel.distributed_model(m, mesh=mesh("dp"))
    res["dropout_losses"] = steps(m)
    # the K-step loop under dp: fit(steps_per_loop=4) against K 1
    for k in (1, 4):
        m = _tiny_gpt(w)
        parallel.distributed_model(m, mesh=mesh("dp"))
        losses = []
        _fit(m, ids.reshape(-1, 16), 1, losses, steps_per_loop=k)
        res[f"fit_k{k}_losses"] = losses
        res[f"fit_k{k}_params"] = _params(m)
    # a guard-skipped step: NaN gradients on rank 0 only, at step 2
    m = _tiny_gpt(w, guard=True)
    parallel.distributed_model(m, mesh=mesh("dp"))
    if rank == 0:
        faults.enable(seed=11)
        faults.inject("grad.nonfinite", nth=(2,))
    try:
        res["guard_losses"] = steps(m)
    finally:
        faults.reset()
    res["guard_skipped"] = m._guard.n_skipped
    res["guard_params"] = _params(m)
    # fit stopped after epoch 1 and resumed, against uninterrupted
    flat = ids.reshape(-1, 16)
    m = _tiny_gpt(w)
    parallel.distributed_model(m, mesh=mesh(args.get("ckpt_axis", "dp")))
    full = []
    _fit(m, flat, 2, full)
    ck = os.path.join(d, "ckpt")
    part = []
    m = _tiny_gpt(w)
    parallel.distributed_model(m, mesh=mesh(args.get("ckpt_axis", "dp")))
    _fit(m, flat, 1, part, checkpoint_dir=ck, async_checkpoint=False)
    m = _tiny_gpt(w)
    parallel.distributed_model(m, mesh=mesh(args.get("ckpt_axis", "dp")))
    _fit(m, flat, 2, part, checkpoint_dir=ck, resume="auto",
         async_checkpoint=False)
    res["resume_full"] = full
    res["resume_parts"] = part
    # Accuracy under dp over a classifier: evaluate's global numbers
    res["accuracy"] = _accuracy(mesh("dp"))
    # DataParallel on a raw Layer (fleet.distributed_model of a Layer)
    res["data_parallel"] = _data_parallel(mesh("dp"))
    torch.distributed.barrier()
    return res


def train_one(rank, world, d, args):
    """The one-process counterparts: a dp=1 mesh against no mesh, and
    the classifier / DataParallel runs on the global batch."""
    parallel = _init(rank, world, d)
    w = _load(args["weights"])
    ids = np.asarray(args["ids"])
    res = {}
    for name, on_mesh in (("plain", False), ("dp1", True)):
        m = _tiny_gpt(w)
        if on_mesh:
            parallel.distributed_model(m, mesh=parallel.DeviceMesh(dp=1))
        res[f"{name}_losses"] = [
            float(m.train_batch([ids[i]], [ids[i]])["loss"])
            for i in range(3)]
        res[f"{name}_params"] = _params(m)
    res["accuracy"] = _accuracy(None)
    res["data_parallel"] = _data_parallel(None)
    return res


def _classifier():
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.fc2 = nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(torch.tanh(self.fc1(x)))

    ptt.seed(3)
    return Net()


class _CE:
    def __call__(self, logits, label):
        import torch
        return torch.nn.functional.cross_entropy(
            logits.float(), label.reshape(-1).long())


def _cls_data(n=64):
    rs = np.random.RandomState(7)
    x = rs.randn(n, 8).astype(np.float32)
    y = (x[:, :4].argmax(1) + (x[:, 4] > 1.0)).astype(np.int64) % 4
    return x, y[:, None]


def _accuracy(mesh):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer, parallel
    from paddle_tpu_torch.io import Dataset
    from paddle_tpu_torch.metric import Accuracy
    net = _classifier()
    m = ptt.Model(net)
    m.prepare(optimizer=optimizer.Adam(1e-2, parameters=net), loss=_CE(),
              metrics=Accuracy(topk=(1, 2)))
    if mesh is not None:
        parallel.distributed_model(m, mesh=mesh)
    x, y = _cls_data()

    class Rows(Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]
    for i in range(4):
        m.train_batch([x[i * 8:(i + 1) * 8]], [y[i * 8:(i + 1) * 8]])
    return m.evaluate(Rows(), batch_size=8, verbose=0)


def _data_parallel(mesh):
    """Three manual steps of a raw Layer: DataParallel on the mesh (each
    rank its rows, gradients averaged), or the global batch on one
    process."""
    import torch
    from paddle_tpu_torch import optimizer, parallel
    net = _classifier()
    layer = parallel.DataParallel(net, mesh=mesh) if mesh is not None \
        else net
    opt = optimizer.SGD(0.1, parameters=net)
    x, y = _cls_data(24)
    losses = []
    for i in range(3):
        xb, yb = x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8]
        out = layer(torch.from_numpy(xb))
        rows = out.shape[0]
        if mesh is not None:
            r = parallel.get_rank()
            yb = yb[r * rows:(r + 1) * rows]
        loss = _CE()(out, torch.from_numpy(yb))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return {"losses": losses, "rows": rows,
            "params": {k: p.detach().numpy().copy()
                       for k, p in net.named_parameters()}}


def main(fn, rank, world, d, namespace=None):
    with open(os.path.join(d, f"{fn}.args.json")) as f:
        args = json.load(f)
    try:
        res = (namespace or globals())[fn](rank, world, d, args)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    with open(os.path.join(d, f"{fn}.rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f, protocol=4)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
