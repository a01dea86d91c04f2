"""Rank bodies of the port's nn layers under a data-parallel mesh
(``tests/test_torch_batchnorm_mesh.py``), run by ``torch_dist_workers``'
harness (one fresh interpreter a rank, gloo over a ``FileStore`` in the
test's directory). Imports no JAX.

    python tests/torch_nn_workers.py <fn> <rank> <world> <dir>
"""

import sys

import numpy as np

import torch_dist_workers as W


def bn_net(nn_):
    """A small conv classifier with a BatchNorm (either package's nn)."""
    return nn_.Sequential(nn_.Conv2D(3, 4, 3, padding=1),
                          nn_.BatchNorm2D(4), nn_.ReLU(),
                          nn_.AdaptiveAvgPool2D(1), nn_.Flatten(),
                          nn_.Linear(4, 3))


def moe_net(nn_):
    """Embedding, a Switch MoE layer, a vocabulary head."""
    class Net(nn_.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn_.Embedding(32, 8)
            self.moe = nn_.MoELayer(8, 16, 4, gate="switch",
                                    capacity_factor=1.0)
            self.head = nn_.Linear(8, 32)

        def forward(self, ids):
            return self.head(self.moe(self.emb(ids)))
    return Net()


def _state(net):
    import torch
    return {k: v.detach().numpy().copy() if isinstance(v, torch.Tensor)
            else v for k, v in net.state_dict().items()}


def bn_dp(rank, world, d, args):
    """BatchNorm under dp=world: the rank's output rows and the running
    statistics of one training forward, then one SGD ``train_batch``
    step from the same weights; and an MoE model's two AdamW steps on
    the mesh against the same model in one process."""
    import torch
    parallel = W._init(rank, world, d)
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.hapi.model import Model
    from paddle_tpu_torch.interop import load_reference_state
    from paddle_tpu_torch.parallel.collective import data_rows
    weights = {k: np.asarray(v, np.float32) for k, v in
               args["weights"].items()}
    x = np.asarray(args["x"], np.float32)
    y = np.asarray(args["y"])
    mesh = parallel.DeviceMesh(dp=world)
    rows = x.shape[0] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    res = {}

    net = bn_net(nn)
    load_reference_state(net, weights)
    net.train()
    with data_rows(mesh.group("dp")):
        out = net(torch.from_numpy(x[mine]))
    res["out_rows"] = out.detach().numpy()
    res["fwd_state"] = _state(net)

    net = bn_net(nn)
    load_reference_state(net, weights)
    m = Model(net)
    m.prepare(optimizer.SGD(0.1, parameters=net), nn.CrossEntropyLoss())
    parallel.distributed_model(m, mesh=mesh)
    res["loss"] = float(m.train_batch([x], [y])["loss"])
    res["step_state"] = _state(net)

    ids = np.asarray(args["ids"])
    out = {}
    for name in ("mesh", "one"):
        net = moe_net(nn)
        load_reference_state(net, {k: np.asarray(v, np.float32) for k, v
                                   in args["moe_weights"].items()})
        m = Model(net)
        m.prepare(optimizer.AdamW(1e-3, parameters=net),
                  nn.CrossEntropyLoss())
        if name == "mesh":
            parallel.distributed_model(m, mesh=mesh)
        losses = [float(m.train_batch([ids], [ids])["loss"])
                  for _ in range(2)]
        out[name] = (losses, _state(net))
    res["moe"] = out
    return res


def _full_grads(model, record):
    """Wrap the Model's optimizer so that each step records the whole
    gradients it was given (ep slices gathered: a collective)."""
    opt = model._optimizer
    inner = opt.apply_in_place

    def apply(params, grads, state, step):
        full = model._sync.full_tree(dict(grads), fsdp=False) \
            if model._sync is not None else grads
        record.append({k: v.detach().numpy().copy() for k, v in
                       full.items()})
        return inner(params, grads, state, step)
    opt.apply_in_place = apply


def moe_ep(rank, world, d, args):
    """MoE layers on an ep mesh (``ep=world``, or ``dp=2 x ep=2`` with
    ``args["dp"]``, reached through a fleet strategy whose ``moe``
    degree is 2): the naive-gate layer's eval forward through
    ``predict_batch`` (the JAX test's ``dp=2, ep=4`` case), the rank's
    expert shapes, two AdamW ``train_batch`` steps of ``moe_net`` with
    every gradient and parameter, the same steps in one process, and a
    save of the mesh model."""
    import os

    import torch
    parallel = W._init(rank, world, d)
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.hapi.model import Model
    from paddle_tpu_torch.interop import load_reference_state

    def f32(tree):
        return {k: np.asarray(v, np.float32) for k, v in tree.items()}

    if args["dp"]:
        from paddle_tpu_torch.parallel.strategy import DistributedStrategy
        strategy = DistributedStrategy()
        strategy.hybrid_configs.dp_degree = 2
        strategy.moe.enable = True
        strategy.moe.degree = 2
        fleet.init(is_collective=True, strategy=strategy, backend="gloo",
                   device="cpu")

        def attach(m):
            return fleet.distributed_model(m)
    else:
        def attach(m):
            return parallel.distributed_model(
                m, mesh=parallel.DeviceMesh(ep=world))
    res = {}
    layer = nn.MoELayer(8, 16, 4, gate="naive", capacity_factor=4.0)
    m = Model(layer)
    m.prepare()
    attach(m)
    load_reference_state(layer, f32(args["naive_weights"]))
    res["naive_out"] = m.predict_batch(
        [torch.tensor(args["x"], dtype=torch.float32)]).detach().numpy()
    res["mesh_repr"] = repr(m._mesh)
    res["ep_index"] = m._mesh.local_rank("ep")
    res["data_axes"] = m._mesh.data_axes
    from paddle_tpu_torch.parallel import collective as coll
    x = torch.full((3,), res["ep_index"] + 1.0, requires_grad=True)
    ep_sum = coll.reduce_from_ep(x, coll.EPGroup(m._mesh))
    ep_sum.sum().backward()
    res["ep_sum"] = (ep_sum.detach().tolist(), x.grad.tolist())
    res["expert_shapes"] = {k: tuple(p.shape) for k, p in
                            layer.experts.named_parameters()}

    ids = np.asarray(args["ids"])
    for name in ("mesh", "one"):
        net = moe_net(nn)
        m = Model(net)
        m.prepare(optimizer.AdamW(1e-3, parameters=net),
                  nn.CrossEntropyLoss())
        if name == "mesh":
            attach(m)
            m._mesh_sync()
        load_reference_state(net, f32(args["moe_weights"]))
        grads = []
        _full_grads(m, grads)
        losses = [float(m.train_batch([ids], [ids])["loss"])
                  for _ in range(2)]
        if name == "mesh":
            path = os.path.join(d, "moe_ep_saved")
            m.save(path)
            state = m._sync.full_tree(
                {k: v.detach() for k, v in net.state_dict().items()},
                fsdp=False)
        else:
            state = net.state_dict()
        res[name] = (losses, grads, {k: v.detach().numpy().copy()
                                     for k, v in state.items()})
    parallel.barrier()
    if rank == 0:
        net = moe_net(nn)
        m = Model(net)
        m.prepare(optimizer.AdamW(1e-3, parameters=net),
                  nn.CrossEntropyLoss())
        m.load(os.path.join(d, "moe_ep_saved"))
        res["reloaded"] = _state(net)
    return res


if __name__ == "__main__":
    W.main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           namespace=globals())
