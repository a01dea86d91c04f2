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


if __name__ == "__main__":
    W.main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           namespace=globals())
