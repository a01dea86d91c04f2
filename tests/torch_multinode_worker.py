"""Rank body of tests/test_torch_multinode.py: data-parallel training of
a small classifier over two gloo CPU ranks under the multi-node
``NodeAgent`` launcher, ``Model.fit`` checkpointing every step into one
shared directory (rank 0 writes) and resuming from the newest verified
step after a restart.

Run (by the NodeAgent): python torch_multinode_worker.py <workdir> <steps>

Environment (set by the test):
  MN_PREEMPT  "s@g[,s@g...]": after step s's checkpoint in generation g,
              the last rank exits RESTART_EXIT_CODE through a
              PreemptionGuard (the agent restarts budget-free).
  MN_CRASH    "s@g": every rank crashes (exit 3) before step s in
              generation g (burns the failure budget).

Rank 0 appends "step loss generation" per completed step to
<workdir>/losses.txt; the last line per step is the authoritative one.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def _points(spec):
    out = set()
    for part in (spec or "").split(","):
        if part.strip():
            s, g = part.split("@")
            out.add((int(s), int(g)))
    return out


def main(workdir: str, total_steps: int):
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer, parallel
    from paddle_tpu_torch.callbacks import Callback
    from paddle_tpu_torch.distributed import elastic
    from paddle_tpu_torch.io import Dataset

    import torch_dist_workers as W

    torch.set_num_threads(1)
    parallel.init_parallel_env(backend="gloo", device="cpu")
    rank, world = parallel.get_rank(), parallel.get_world_size()
    gen = elastic.restart_count()
    preempt_at = _points(os.environ.get("MN_PREEMPT"))
    crash_at = _points(os.environ.get("MN_CRASH"))

    mesh = parallel.init_mesh(dp=world)
    net = W._classifier()
    model = ptt.Model(net)
    model.prepare(optimizer=optimizer.AdamW(1e-2, parameters=net),
                  loss=W._CE())
    parallel.distributed_model(model, mesh=mesh)
    x, y = W._cls_data(8 * total_steps)

    class Rows(Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]

    guard = elastic.PreemptionGuard(install=False) \
        if rank == world - 1 else None
    loss_path = os.path.join(workdir, "losses.txt")

    class Script(Callback):
        def on_train_batch_begin(self, step, logs=None):
            if (model._step_count, gen) in crash_at:
                os._exit(3)

        def on_train_batch_end(self, step, logs=None):
            s = model._step_count - 1
            if rank == 0:
                with open(loss_path, "a") as f:
                    f.write(f"{s} {float(logs['loss'])!r} {gen}\n")
            if guard is not None and (s, gen) in preempt_at:
                guard.trigger()   # exits 67 after this step's checkpoint

    model.fit(Rows(), batch_size=8, epochs=1, shuffle=False, verbose=0,
              callbacks=[Script()],
              checkpoint_dir=os.path.join(workdir, "ckpt"),
              checkpoint_freq=1, resume="auto", async_checkpoint=False,
              preemption_guard=guard)
    print("done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
