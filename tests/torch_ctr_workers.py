"""Rank bodies of the port's key-sharded host table
(``tests/test_torch_sharded_embedding.py``), run by ``torch_dist_workers``'
harness (one fresh interpreter a rank, gloo over a ``FileStore`` in the
test's directory). Imports no JAX.

    python tests/torch_ctr_workers.py <fn> <rank> <world> <dir>
"""

import os
import sys

import numpy as np

import torch_dist_workers as W


def sharded(rank, world, d, args):
    """``ShardedHostEmbedding`` on a dp=world mesh installed with
    ``init_mesh``: each rank looks up its rows of the global ids. Returns
    the pulled rows, the rows it owns after one backward of ``sum`` (sgd,
    lr 1), the combiners' outputs, the anchor's gradient, a spill-dir
    run's rows, the budget's refusal and its shard snapshot's path."""
    import torch
    parallel = W._init(rank, world, d)
    from paddle_tpu_torch.nn import ShardedHostEmbedding
    parallel.init_mesh(dp=world)
    ids = np.asarray(args["ids"])
    rows = ids.shape[0] // world
    mine = ids[rank * rows:(rank + 1) * rows]
    res = {}

    sh = ShardedHostEmbedding(100_000, 8, seed=5, optimizer="sgd",
                              learning_rate=1.0, padding_idx=None)
    out = sh(mine)
    res["pulled"] = out.detach().numpy().copy()
    out.sum().backward()
    res["anchor_grad"] = sh.push_anchor.grad.numpy().copy()
    flat = np.unique(ids.reshape(-1))
    owned = flat[flat % world == rank]
    res["owned_ids"] = owned
    res["owned_after_push"] = sh._local._pull(owned).copy()
    res["touched_local"] = sh.touched_rows_local
    res["shard"] = sh.snapshot_shard(os.path.join(d, "table"))

    pads = np.asarray(args["pad_ids"])
    prow = pads.shape[0] // world
    res["combiners"] = {}
    for combiner in ("sum", "mean", "sqrtn"):
        t = ShardedHostEmbedding(1000, 4, seed=2, combiner=combiner)
        res["combiners"][combiner] = t(
            pads[rank * prow:(rank + 1) * prow]).detach().numpy()

    spill = {}
    for tag in ("ram", "spill"):
        t = ShardedHostEmbedding(
            100_000, 8, seed=5, optimizer="adagrad", learning_rate=0.5,
            spill_dir=os.path.join(d, f"spill{rank}") if tag == "spill"
            else None)
        first = t(mine)
        (first ** 2).sum().backward()
        spill[tag] = (first.detach().numpy().copy(),
                      t(mine).detach().numpy().copy())
    res["spill"] = spill
    res["spill_files"] = sorted(os.listdir(os.path.join(d, f"spill{rank}")))

    capped = ShardedHostEmbedding(100_000, 4, host_budget_rows=4)
    try:
        capped(mine)
        res["budget"] = "no error"
    except RuntimeError as e:
        res["budget"] = str(e)
    torch.distributed.barrier()
    return res


if __name__ == "__main__":
    W.main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           namespace=globals())
