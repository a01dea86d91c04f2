"""Rank bodies of the port's sequence-parallel CPU tests
(``tests/test_torch_ring_attention.py``), run by ``torch_dist_workers``'
harness (one fresh interpreter a rank, gloo over a ``FileStore`` in the
test's directory). Imports no JAX; the inputs are drawn from numpy seeds
that the JAX side (``tests/torch_mp_reference.py``) draws alike.

    python tests/torch_sp_workers.py <fn> <rank> <world> <dir>
"""

import os
import pickle
import sys
import weakref

import numpy as np

import torch_dist_workers as W

STEPS = 3

# ring-op cases of tests/test_ring_attention.py: the inputs' shape and
# seed, causal, chunk_size, a key-padding mask, attention dropout (p, key)
OP_CASES = {
    "full-c0": dict(causal=False),
    "full-c1": dict(causal=True),
    "chunk-c0": dict(causal=False, chunk=4),
    "chunk-c1": dict(causal=True, chunk=4),
    "kpm-c0": dict(causal=False, kpm=True),
    "kpm-c1": dict(causal=True, kpm=True),
    "kpm-chunk-c0": dict(causal=False, kpm=True, chunk=8),
    "kpm-chunk-c1": dict(causal=True, kpm=True, chunk=8),
    "drop0": dict(causal=True, shape=(2, 64, 4, 8), dropout=0.0),
    "nodrop": dict(causal=True, shape=(2, 64, 4, 8)),
    "drop5-k7": dict(causal=True, shape=(2, 64, 4, 8), dropout=0.5),
    "drop5-k8": dict(causal=True, shape=(2, 64, 4, 8), dropout=0.5, key=8),
    "drop5-chunk": dict(causal=True, shape=(2, 64, 4, 8), dropout=0.5,
                        chunk=8),
}
# gradient cases: test_ring_grads_match_full (loss sum(o cos o)) and
# test_chunked_ring_gradients_match (loss sum(o^2))
GRAD_CASES = {
    "grad-c1": dict(causal=True, shape=(2, 32, 2, 16), loss="cos"),
    "cgrad-c0": dict(causal=False, shape=(1, 32, 2, 8), seed=1),
    "cgrad-c1": dict(causal=True, shape=(1, 32, 2, 8), seed=1),
    "cgrad-chunk-c0": dict(causal=False, shape=(1, 32, 2, 8), seed=1,
                           chunk=4),
    "cgrad-chunk-c1": dict(causal=True, shape=(1, 32, 2, 8), seed=1,
                           chunk=4),
}
# the GPT runs of test_gpt_sequence_parallel_* on a mesh: the config's
# kind, its dropouts, whether the feed carries the key-padding mask
GPT_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              max_position_embeddings=32, use_flash=False)
LLAMA_KW = dict(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                vocab_size=64, max_position_embeddings=32, use_flash=False,
                scan_layers=True, remat=True)
GPT_RUNS = {
    "plain": dict(),
    "masked": dict(mask=True),
    "dropped": dict(mask=True, attn=0.3, hidden=0.1),
    "llama": dict(kind="llama"),
}
JAX_GPT_RUNS = ("plain", "dropped", "llama")   # on sp=2 x dp=2


def qkv(shape=(2, 64, 2, 16), seed=0, **_):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(*shape).astype(np.float32) for _ in range(3))


def key_padding(shape=(2, 64, 2, 16), **_):
    return np.random.RandomState(1).rand(shape[0], shape[1]) > 0.3


def gpt_ids():
    return np.random.RandomState(0).randint(0, 64, (4, 32))


def gpt_kpm():
    kpm = np.ones((4, 32), bool)
    kpm[:, 28:] = False   # a padded tail
    return kpm


def gpt_cfg_kw(kind="gpt", attn=0.0, hidden=0.0, **_):
    """The config of a GPT run (either package's GPTConfig takes it)."""
    if kind == "llama":
        return dict(LLAMA_KW, sequence_parallel=True, ring_chunk_size=8)
    return dict(GPT_KW, hidden_dropout=hidden, attention_dropout=attn,
                sequence_parallel=True, ring_chunk_size=4)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# the ring op
# ---------------------------------------------------------------------------

def _piece(x, mesh):
    import torch
    sp, r = mesh.axis_size("sp"), mesh.local_rank("sp")
    n = x.shape[1] // sp
    return torch.from_numpy(np.ascontiguousarray(x[:, r * n:(r + 1) * n]))


def ring_case(mesh, case, grad_loss=None):
    """This rank's slice of the ring's output (and, with ``grad_loss``,
    of dq, dk and dv) on ``case``."""
    import torch
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.ops.ring_attention import ring_attention
    q, k, v = (_piece(x, mesh).requires_grad_(grad_loss is not None)
               for x in qkv(**case))
    kpm = _piece(key_padding(**case), mesh) if case.get("kpm") else None
    p = case.get("dropout", 0.0)
    o = ring_attention(
        q, k, v, causal=case["causal"], mesh=mesh,
        chunk_size=case.get("chunk"), key_padding_mask=kpm, dropout_p=p,
        dropout_key=threefry.prng_key(case.get("key", 7)) if p else None)
    if grad_loss is None:
        return o.detach().numpy()
    loss = (o * torch.cos(o)).sum() if grad_loss == "cos" else \
        (o ** 2).sum()
    loss.backward()
    return [t.grad.numpy() for t in (q, k, v)]


class PeakBytes:
    """Peak bytes of the tensors that ops allocate in scope (a dispatch
    mode that counts each new storage until its tensor is freed): the
    CPU's stand-in for XLA's temp bytes."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                outer._note(out)
                return out
        self.mode = _Mode()
        self.live, self.cur, self.peak = {}, 0, 0

    def _note(self, out):
        import torch
        from torch.utils._pytree import tree_flatten
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            ptr = st.data_ptr()
            if ptr and ptr not in self.live:
                self.live[ptr] = st.nbytes()
                self.cur += st.nbytes()
                self.peak = max(self.peak, self.cur)
                weakref.finalize(t, self._free, ptr)

    def _free(self, ptr):
        self.cur -= self.live.pop(ptr, 0)

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def ring_peak_bytes(mesh, s, chunk=256):
    """Peak bytes of one causal ring fwd + bwd at sequence ``s`` (b 1, h
    2, d 16) on the plain blocks streamed in ``chunk`` tiles (an
    all-True key-padding mask selects them)."""
    import torch
    from paddle_tpu_torch.ops.ring_attention import ring_attention
    sp = mesh.axis_size("sp")
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, s // sp, 2, 16, generator=g)
               .requires_grad_() for _ in range(3))
    kpm = torch.ones(1, s // sp, dtype=torch.bool)
    with PeakBytes() as pb:
        o = ring_attention(q, k, v, causal=True, mesh=mesh, chunk_size=chunk,
                           key_padding_mask=kpm)
        o.sum().backward()
    return pb.peak


def op_cases(mesh, names=None):
    res = {}
    for name, case in OP_CASES.items():
        if names is None or name in names:
            res[name] = ring_case(mesh, case)
    return res


# ---------------------------------------------------------------------------
# the sequence-parallel GPT
# ---------------------------------------------------------------------------

def gpt_model(weights, run):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.interop import load_reference_state
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             llama_config)
    ptt.seed(0)
    kw = gpt_cfg_kw(**run)
    cfg = llama_config(**kw) if run.get("kind") == "llama" \
        else GPTConfig(**kw)
    net = GPTForCausalLM(cfg, device="cpu")
    load_reference_state(net, weights)
    m = ptt.Model(net)
    m.prepare(optimizer=optimizer.AdamW(1e-3, parameters=net),
              loss=GPTPretrainingCriterion())
    return m


def gpt_feed(run):
    ids = gpt_ids()
    pos = np.broadcast_to(np.arange(32), (4, 32))
    return ([ids, pos, gpt_kpm()] if run.get("mask") else [ids]), [ids]


def gpt_losses(parallel, mesh, weights, run, steps=STEPS):
    """The losses of ``steps`` train_batch calls of a GPT run on ``mesh``,
    the B1-B3 launches, and the Model."""
    from paddle_tpu_torch.ops import flash_attention as fa
    m = gpt_model(weights, run)
    parallel.distributed_model(m, mesh=mesh)
    feed, labels = gpt_feed(run)
    for k in fa.launches:
        fa.launches[k] = 0
    losses = [float(m.train_batch(feed, labels)["loss"])
              for _ in range(steps)]
    return losses, dict(fa.launches), m


def full_state(model):
    with model._unsharded():
        sd = model.network.state_dict()
        return {k: v.detach().numpy().copy() for k, v in sd.items()}


def sp2(rank, world, d, args):
    """Two ranks on sp=2: the ring op's full cases, the memory of one
    fwd + bwd at two lengths, a GPT on sp alone (saved, evaluated,
    predicting; a K-step slab), and the left-padded ring forward of an
    installed mesh."""
    import torch
    parallel = W._init(rank, world, d)
    mesh = parallel.DeviceMesh(sp=2)
    res = {"ops": op_cases(mesh, ("full-c0", "full-c1")),
           "peak": {s: ring_peak_bytes(mesh, s) for s in (4096, 8192)}}
    w = _load(args["weights"])
    res["losses"], res["launches"], m = gpt_losses(
        parallel, mesh, w["plain"], GPT_RUNS["plain"])
    m.save(os.path.join(d, "sp2_saved"), training=False)
    res["state"] = full_state(m)
    # evaluate and predict on the trained model: the whole batch's
    ids = gpt_ids()
    res["eval_loss"] = float(m.eval_batch([ids], [ids])["loss"])
    res["predict"] = m.predict_batch([ids]).numpy()
    # the K-step loop: a slab of 2 equals 2 train_batch calls
    k = gpt_model(w["plain"], {})
    parallel.distributed_model(k, mesh=mesh)
    slab = np.stack([ids, ids])
    res["loop_losses"] = [float(x["loss"]) for x in
                          k.train_loop_batch([slab], [slab])]
    # left padding on the ring: the network called directly under the
    # installed sp mesh (the JAX package's _sp_mesh), eval mode
    net = gpt_model(w["plain"], {}).network
    net.eval()
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 16)))
    kpm = np.ones((2, 16), bool)
    kpm[:, :4] = False
    parallel.init_mesh(sp=2)
    try:
        with torch.no_grad():
            out = net(ids, None, torch.from_numpy(kpm))
        try:   # training needs the Model's MeshSync
            net(ids)
            res["installed_train_error"] = ""
        except NotImplementedError as e:
            res["installed_train_error"] = str(e)
    finally:
        parallel.set_mesh(None)
    res["left_padded"] = out.numpy()
    parallel.barrier()
    return res


def sp4(rank, world, d, args):
    """Four ranks: the ring op's cases and gradients on sp=4, then GPTs
    on sp=2 x dp=2 (dropout 0, a key-padding mask, attention and
    residual dropout, the LLaMA-style scan), sp=2 x fsdp=2 and sp=2 x
    tp=2."""
    parallel = W._init(rank, world, d)
    mesh = parallel.DeviceMesh(sp=4)
    res = {"ops": op_cases(mesh),
           "grads": {n: ring_case(mesh, c, c.get("loss", "sq"))
                     for n, c in GRAD_CASES.items()}}
    w = _load(args["weights"])
    res["gpt"] = {}
    for axis in ("dp", "fsdp", "tp"):
        m2 = parallel.DeviceMesh(sp=2, **{axis: 2})
        names = GPT_RUNS if axis == "dp" else ("plain",)
        for name in names:
            run = GPT_RUNS[name]
            losses, launches, _ = gpt_losses(
                parallel, m2, w["llama" if name == "llama" else "plain"],
                run)
            res["gpt"][(axis, name)] = {"losses": losses,
                                        "launches": launches}
    parallel.barrier()
    return res


if __name__ == "__main__":
    W.main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           globals())
