"""Tensor parallelism of the port on gloo CPU ranks against the JAX
package's tp meshes on the virtual CPU devices.

The tiny GPT of ``tests/torch_mp_workers.py`` (vocab 128, hidden 32, 4
layers, 4 heads on 2 kv heads, s 16, batch 4, the fused loss, AdamW
1e-3 / wd 0.01) on the JAX package's weights: ``tp=2`` (two ranks) and
``dp=2 x tp=2`` (four) against the JAX package's ``tp=2`` and ``dp=2 x
tp=2`` meshes at dropout 0 and 0.1 (the attention dropout draws the
rank's heads of the global mask) within 2e-4; the ranks bit for bit; the
gathered state equal to the JAX layout (the permuted qkv columns
round-trip exactly); ``Model.save`` on the mesh loading into one
process and into the JAX package; the vocab-parallel fused loss and its
gradient against ``paddle_tpu/ops/fused_xent.py``; Lamb, Adafactor,
LarsMomentum and ``ClipGradByNorm`` under tp=2 and fsdp=2 against one
process; remat under dp=2 at dropout 0.1; a resumed
fit; ``hybrid_configs.mp_degree`` reaching the mesh; the pp=2 x tp=2
mesh against ``tests/test_integration_e2e.py``'s."""

import os
import pickle

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

import torch_dist_workers as W
import torch_mp_reference as R

WORKERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_mp_workers.py")
RTOL, ATOL = 2e-4, 2e-5
TP2 = (("tp", 2),)
DPTP = (("dp", 2), ("tp", 2))
E2E = (("pp", 2), ("dp", 2), ("tp", 2))


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_parallel")
    args = {"weights": _dump(d / "w.pkl", R.weights()),
            "e2e_weights": _dump(d / "w_e2e.pkl",
                                 R.weights(pipe_v=1, seq=32)),
            "ids": R.ids().tolist(), "e2e_ids": R.e2e_ids().tolist()}
    two = W.start_ranks("tp2", 2, d / "two", args, script=WORKERS)
    four = W.start_ranks("dptp", 4, d / "four", args, script=WORKERS)
    jax_side = {(axes, p): R.run(axes, p) for axes in (TP2, DPTP)
                for p in (0.0, 0.1)}
    jax_side["e2e"] = R.run(E2E, pipe=(2, 1), fused=False, seq=32,
                            batches="e2e")
    return {"two": W.collect(two, timeout=400),
            "four": W.collect(four, timeout=400), "jax": jax_side,
            "dir": d / "two"}


def _close(got, want, msg, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want), msg
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{msg}: {k}")


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_tp2_losses_and_state_match_jax(runs, dropout):
    losses, state = runs["jax"][(TP2, dropout)]
    for r in runs["two"]:
        np.testing.assert_allclose(r[f"losses_{dropout}"], losses,
                                   rtol=RTOL, atol=ATOL)
        _close(r[f"state_{dropout}"], state, f"tp=2 dropout {dropout}")
    if dropout:
        assert losses != runs["jax"][(TP2, 0.0)][0]   # the masks acted


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_dp2_tp2_losses_and_state_match_jax(runs, dropout):
    losses, state = runs["jax"][(DPTP, dropout)]
    for r in runs["four"]:
        np.testing.assert_allclose(r[f"dptp_losses_{dropout}"], losses,
                                   rtol=RTOL, atol=ATOL)
        _close(r[f"dptp_state_{dropout}"], state, "dp=2 x tp=2")


@pytest.mark.parametrize("key", ["losses_0.0", "losses_0.1", "state_0.0"])
def test_tp_ranks_agree_bit_for_bit(runs, key):
    r0, r1 = runs["two"]
    if key.startswith("losses"):
        assert r0[key] == r1[key]
    else:
        for k, v in r0[key].items():
            np.testing.assert_array_equal(v, r1[key][k], err_msg=k)
    four = runs["four"]
    for r in four[1:]:
        assert r["dptp_losses_0.1"] == four[0]["dptp_losses_0.1"]
        assert r["pptp_losses"] == four[0]["pptp_losses"]


def test_tp_replicated_grads_are_equal_without_a_reduction(runs):
    """Every tp rank computes the same loss, so the gradients of the
    parameters tp leaves whole (norms, biases added after the
    all-reduce, positions) are equal across the ranks before any
    reduction: the reducer sums nothing over tp."""
    g0, g1 = (r["replicated_grads"] for r in runs["two"])
    assert "gpt.layers.0.ln_1.weight" in g0
    assert "gpt.layers.0.attn.out_proj.bias" in g0
    assert "gpt.layers.0.attn.qkv_proj.weight" not in g0   # a slice
    for k, v in g0.items():
        np.testing.assert_array_equal(v, g1[k], err_msg=k)


def test_local_slices_and_qkv_roundtrip(runs):
    """The rank's slices: qkv [32, (2 + 1 + 1) * 8] (its 2 q heads, its
    kv head's k and v), out_proj [16, 32], fc_in [32, 64], fc_out [64,
    32], the vocab half of the word embeddings; gathered back before
    any step they are the JAX weights exactly (the qkv permutation
    undone)."""
    want = R.weights()
    for r in runs["two"]:
        s = r["local_shapes"]
        assert s["gpt.layers.0.attn.qkv_proj.weight"] == (32, 32)
        assert s["gpt.layers.0.attn.qkv_proj.bias"] == (32,)
        assert s["gpt.layers.0.attn.out_proj.weight"] == (16, 32)
        assert s["gpt.layers.0.attn.out_proj.bias"] == (32,)
        assert s["gpt.layers.0.mlp.fc_in.weight"] == (32, 64)
        assert s["gpt.layers.0.mlp.fc_out.weight"] == (64, 32)
        assert s["gpt.embeddings.word_embeddings.weight"] == (64, 32)
        assert s["gpt.embeddings.position_embeddings.weight"] == (16, 32)
        for k, v in want.items():
            np.testing.assert_array_equal(r["roundtrip"][k], v, err_msg=k)


def test_save_on_the_mesh_loads_into_one_process_and_jax(runs):
    """``Model.save`` on the tp=2 mesh writes the JAX layout (rank 0):
    the file loads into a fresh Model on the mesh (its next step equal to
    the saved Model's), into one port process and into the JAX package,
    each holding the gathered state."""
    import torch_mp_workers as MW
    path = str(runs["dir"] / "tp2_saved")
    for r in runs["two"]:
        for k, v in r["state_0.0"].items():
            np.testing.assert_array_equal(r["reloaded"][k], v, err_msg=k)
        a, b = r["reloaded_next"]
        assert a == b
    want = runs["two"][0]["state_0.0"]
    jax_state = R.load_into_jax(path)
    net = MW.dense_net(R.weights())
    m = MW.model_of(net)
    m.load(path)
    for k, v in want.items():
        np.testing.assert_array_equal(jax_state[k], v, err_msg=k)
        np.testing.assert_array_equal(
            net.state_dict()[k].numpy(), v, err_msg=k)


def test_vocab_parallel_fused_loss_matches_jax(runs):
    """Each rank streams its vocab half in chunks of 24 (the last one
    padded): the loss, dh and each rank's dW slice equal the JAX fused
    loss's over the whole vocab, with labels on both slices and
    ``ignore_index``; no rank forms more than [tokens, 24] logits."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.fused_xent import fused_linear_cross_entropy
    h, full, labels = runs["two"][0]["fused"]["inputs"]
    loss, (dh, dw) = jax.value_and_grad(
        lambda a, b: fused_linear_cross_entropy(a, b, jnp.asarray(labels)),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(full))
    dws = np.split(np.asarray(dw), 2)
    for i, r in enumerate(runs["two"]):
        f = r["fused"]
        np.testing.assert_allclose(f["loss"], float(loss), rtol=1e-6)
        np.testing.assert_allclose(f["dh"], np.asarray(dh), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(f["dw"], dws[i], rtol=1e-5, atol=1e-7)
        assert f["max_width"] == 24


def _k_bias(state):
    """The key-bias columns of every qkv bias: softmax over the keys is
    invariant to a bias added to every key, so their gradient is zero
    up to rounding."""
    return {k: v[32:48] for k, v in state.items()
            if k.endswith("attn.qkv_proj.bias")}


@pytest.mark.parametrize("opt", ["lamb", "adafactor", "lars", "clip"])
@pytest.mark.parametrize("axis", ["tp", "fsdp"])
def test_per_tensor_norms_over_shards_match_one_process(runs, opt, axis):
    """Lamb's trust ratio, Adafactor's factored statistics and RMS,
    LarsMomentum's layer-wise rate and ``ClipGradByNorm`` take each
    tensor's norm over its tp slices or fsdp shards: the same losses and
    parameters as one process (LarsMomentum used the fsdp shard's own
    norms before: ROADMAP Queue C). The
    key-bias columns are left out of Adafactor's comparison: their
    gradient is rounding noise (``_k_bias``), which Adafactor's first
    step (no first moment: ``g / sqrt(g^2)``) turns into a full-size
    step of either sign, whatever the summation order."""
    one_losses, one_state = runs["two"][0][f"{opt}_one"]
    for r in runs["two"]:
        losses, state = r[f"{opt}_{axis}"]
        np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
        if opt == "adafactor":   # the key-bias columns: one process's
            state = dict(state)
            for k in _k_bias(state):
                state[k] = np.concatenate([state[k][:32],
                                           one_state[k][32:48],
                                           state[k][48:]])
        _close(state, one_state, f"{opt} {axis}", rtol=1e-5, atol=1e-6)
    k = "gpt.layers.0.attn.qkv_proj.weight"
    assert not np.array_equal(one_state[k], R.weights()[k])   # it trained


def test_fit_resumed_on_the_tp_mesh_equals_uninterrupted(runs):
    for r in runs["two"]:
        assert len(r["resume_full"]) == 4
        assert r["resume_parts"] == r["resume_full"]


def test_remat_under_dp_replays_the_rank_rows_of_the_masks(runs):
    """dp=2 at dropout 0.1 with ``remat``: the backward's recompute
    draws the rank's rows of each mask, as the forward did, so the run
    equals the one without remat (ROADMAP Queue C: the recompute used
    to draw rows 0.. of the global mask on every rank)."""
    for r in runs["two"]:
        (l0, s0), (l1, s1) = r["dp_remat_False"], r["dp_remat_True"]
        np.testing.assert_allclose(l1, l0, rtol=1e-6)
        _close(s1, s0, "remat", rtol=1e-6, atol=1e-7)


def test_fleet_hybrid_configs_reach_the_mesh(runs):
    for r in runs["two"]:
        assert r["fleet_axes"]["tp"] == 2 and r["fleet_axes"]["dp"] == 1
        assert r["fleet_loss"] == r["losses_0.0"][:1]


def test_pp2_tp2_matches_the_capstone_mesh(runs):
    """pp=2 x tp=2 on four ranks against the JAX package on
    tests/test_integration_e2e.py's pp=2 x tp=2 x dp=2 mesh (the same
    GPT, two microbatches, the dense criterion): dp only splits the
    rows, so the losses and the trained state agree."""
    losses, state = runs["jax"]["e2e"]
    for r in runs["four"]:
        np.testing.assert_allclose(r["pptp_losses"], losses, rtol=RTOL,
                                   atol=ATOL)
        _close(r["pptp_state"], state, "pp=2 x tp=2")
