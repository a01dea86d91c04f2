"""Ring attention and sequence parallelism of the port on gloo CPU ranks
against the JAX package's ring on meshes of the virtual CPU devices: a
counterpart of each of the 14 functions of ``tests/test_ring_attention.py``.

Ranks (``tests/torch_sp_workers.py``): two on ``sp=2`` (the full ring
cases, the memory of one fwd + bwd at two lengths, a GPT trained on sp
alone, saved, evaluated, predicting and on a K-step slab, the
left-padded ring forward under an installed mesh)
and four (every ring case and gradient on ``sp=4``, then GPTs on ``sp=2
x dp=2``: dropout 0, a padded key mask, attention dropout 0.3 and
residual dropout 0.1 with it, the LLaMA-style scan + remat + GQA + RoPE
trunk; and on ``sp=2 x fsdp=2`` and ``sp=2 x tp=2``). The JAX side's runs are cached in
``tests/torch_mp_reference.py``.

Tolerances: the ring's outputs and gradients in float32 within 2e-5 /
1e-4 of the JAX ring's (the JAX test's own bounds against full
attention: 1e-5 outputs, 1e-4 gradients, 2e-5 / 3e-5 chunked), which the
port reaches on different block arithmetic (the unmasked blocks run
kernel B1-B3's plain twins); dropout masks drawn bit-identically, so the
dropped outputs are held to the same bound; the GPT losses at the JAX
test's rtol 5e-4 / atol 5e-5."""

import os
import pickle

import numpy as np
import pytest
import torch
from torch_gc_barrier import collect_cycles  # noqa: F401

import torch_dist_workers as W
import torch_mp_reference as R
import torch_sp_workers as S
from paddle_tpu_torch import parallel as tpar
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import ring_attention as tra

WORKERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_sp_workers.py")
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
SPDP = (("sp", 2), ("dp", 2))
SPFSDP = (("sp", 2), ("fsdp", 2))


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_attention")
    args = {"weights": _dump(d / "w.pkl", {
        "plain": R.sp_weights(), "llama": R.sp_weights("llama")})}
    two = W.start_ranks("sp2", 2, d / "two", args, script=WORKERS)
    four = W.start_ranks("sp4", 4, d / "four", args, script=WORKERS)
    jax_side = {("op", sp, n): R.ring_op(sp, n) for sp, names in (
        (2, ("full-c0", "full-c1")), (4, tuple(S.OP_CASES))) for n in names}
    jax_side.update({("grad", n): R.ring_op(4, n, grad=True)
                     for n in S.GRAD_CASES})
    jax_side.update({("gpt", SPDP, n): R.sp_gpt(SPDP, n)
                     for n in S.JAX_GPT_RUNS})
    jax_side[("gpt", SPFSDP, "plain")] = R.sp_gpt(SPFSDP, "plain")
    return {"two": W.collect(two, timeout=400),
            "four": W.collect(four, timeout=400), "jax": jax_side,
            "dir": d / "two"}


def _joined(ranks, get):
    """The sequence (dim 1) joined from the ranks' slices."""
    return np.concatenate([get(r) for r in ranks], axis=1)


# -- test_ring_matches_full / test_ring_sp1_fallback ------------------------

@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_full(runs, sp, causal):
    name = f"full-c{int(causal)}"
    ranks = runs["two" if sp == 2 else "four"]
    np.testing.assert_allclose(_joined(ranks, lambda r: r["ops"][name]),
                               runs["jax"][("op", sp, name)], **OUT_TOL)


def test_ring_sp1_fallback():
    """One rank on the axis: full attention over q's sequence (through
    the flash twins), against the JAX package's fallback."""
    case = dict(S.OP_CASES["full-c1"], shape=(2, 16, 2, 16))
    q, k, v = (torch.from_numpy(x) for x in S.qkv(**case))
    out = tra.ring_attention(q, k, v, causal=True,
                             mesh=tpar.DeviceMesh(devices=1, dp=1))
    import jax.numpy as jnp
    from paddle_tpu import parallel as jpar
    from paddle_tpu.ops.ring_attention import ring_attention
    import jax
    want = ring_attention(*(jnp.asarray(x) for x in S.qkv(**case)),
                          causal=True,
                          mesh=jpar.DeviceMesh(devices=jax.devices()[:1],
                                               dp=1))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("d, use_flash", [(20, True), (16, False)])
def test_ring_blocks_the_kernels_do_not_take_run_plain(monkeypatch, d,
                                                       use_flash):
    """A head dim the flash kernels do not take (d 20: not a multiple of
    8), or ``use_flash=False`` (``GPTConfig.use_flash``), sends every
    block to the plain torch blocks, never to kernels B1-B3; the output
    still matches the JAX package's fallback."""
    def refuse(*a, **k):
        raise AssertionError("a flash kernel wrapper was called")
    monkeypatch.setattr(tfa, "flash_attention_fwd_kernel", refuse)
    monkeypatch.setattr(tfa, "flash_attention_fwd_torch", refuse)
    case = dict(S.OP_CASES["full-c1"], shape=(2, 16, 2, d))
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in S.qkv(**case))
    out = tra.ring_attention(q, k, v, causal=True, use_flash=use_flash,
                             mesh=tpar.DeviceMesh(devices=1, dp=1))
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    import jax
    import jax.numpy as jnp
    from paddle_tpu import parallel as jpar
    from paddle_tpu.ops.ring_attention import ring_attention
    want = ring_attention(*(jnp.asarray(x) for x in S.qkv(**case)),
                          causal=True,
                          mesh=jpar.DeviceMesh(devices=jax.devices()[:1],
                                               dp=1))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **OUT_TOL)


def test_installed_sp_mesh_refuses_training(runs):
    """The installed mesh's sp group serves a forward without gradients
    (the left-padded case below); training goes through a Model on the
    mesh, whose MeshSync sums the gradients over sp and gives the loss
    the same group as the layers."""
    for r in runs["two"]:
        assert "distributed_model" in r["installed_train_error"]


def test_ring_rejects_indivisible():
    """A sequence that does not split over sp raises the JAX package's
    error where the port slices it; a bad chunk_size raises its own."""
    mesh = tpar.DeviceMesh(devices=4, sp=4)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.with_logical_constraint(torch.zeros(2, 30, 8),
                                     ("batch", "seq", None), mesh)
    q = torch.zeros(1, 8, 2, 8)
    one = tpar.DeviceMesh(devices=1, dp=1)
    with pytest.raises(ValueError, match="must divide"):
        tra.ring_attention(q, q, q, mesh=one, chunk_size=3)
    with pytest.raises(ValueError, match="positive"):
        tra.ring_attention(q, q, q, mesh=one, chunk_size=0)
    with pytest.raises(ValueError, match="requires dropout_key"):
        tra.ring_attention(q, q, q, mesh=one, dropout_p=0.1)


# -- gradients ----------------------------------------------------------------

def test_ring_grads_match_full(runs):
    got = runs["jax"][("grad", "grad-c1")]
    for i, n in enumerate("qkv"):
        np.testing.assert_allclose(
            _joined(runs["four"], lambda r: r["grads"]["grad-c1"][i]),
            got[i], err_msg=f"d{n}", **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_ring_matches_unchunked(runs, causal):
    c = int(causal)
    chunked = _joined(runs["four"], lambda r: r["ops"][f"chunk-c{c}"])
    base = _joined(runs["four"], lambda r: r["ops"][f"full-c{c}"])
    np.testing.assert_allclose(chunked, base, **OUT_TOL)
    np.testing.assert_allclose(chunked, runs["jax"][("op", 4, f"chunk-c{c}")],
                               **OUT_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_ring_gradients_match(runs, causal):
    c = int(causal)
    for i in range(3):
        base = _joined(runs["four"], lambda r: r["grads"][f"cgrad-c{c}"][i])
        chunked = _joined(runs["four"],
                          lambda r: r["grads"][f"cgrad-chunk-c{c}"][i])
        np.testing.assert_allclose(chunked, base, **GRAD_TOL)
        np.testing.assert_allclose(
            chunked, runs["jax"][("grad", f"cgrad-chunk-c{c}")][i],
            **GRAD_TOL)


def test_chunked_ring_memory_linear_in_seq(runs):
    """With chunk_size fixed, doubling the sequence at sp=2 about doubles
    a rank's peak bytes in one fwd + bwd (the JAX test's bound, 2.6)."""
    for r in runs["two"]:
        assert r["peak"][8192] / r["peak"][4096] <= 2.6, r["peak"]


# -- the key-padding mask and dropout -----------------------------------------

@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_key_padding_mask_matches_full(runs, causal, chunk):
    name = f"kpm-{'chunk-' if chunk else ''}c{int(causal)}"
    np.testing.assert_allclose(
        _joined(runs["four"], lambda r: r["ops"][name]),
        runs["jax"][("op", 4, name)], **OUT_TOL)


def test_ring_dropout_deterministic_and_exact_at_zero(runs):
    """p=0 is the no-dropout path exactly; p=0.5 draws the JAX package's
    masks at the same key (so the dropped outputs agree within the
    float tolerance), on the unchunked and the chunked blocks; another
    key drops other entries."""
    four = runs["four"]

    def op(n):
        return _joined(four, lambda r: r["ops"][n])
    np.testing.assert_array_equal(op("drop0"), op("nodrop"))
    for n in ("drop5-k7", "drop5-k8", "drop5-chunk"):
        np.testing.assert_allclose(op(n), runs["jax"][("op", 4, n)],
                                   **OUT_TOL)
    assert not np.allclose(op("drop5-k7"), op("nodrop"))
    assert not np.allclose(op("drop5-k7"), op("drop5-k8"))
    assert abs(op("drop5-k7").mean() - op("nodrop").mean()) < 0.05


# -- the sequence-parallel GPT ------------------------------------------------

@pytest.mark.parametrize("data_axis", ["dp", "fsdp", "tp"])
def test_gpt_sequence_parallel_training_matches_dense(runs, data_axis):
    """sp=2 composed with dp and with fsdp against the JAX package's
    meshes, and with tp (the ranks' heads, vocab-parallel logits)
    against the JAX sp x dp mesh (the same global step); every rank
    reports the same losses. (On CPU tensors the blocks run B1-B3's
    plain twins, which count no launch.)"""
    axes = SPFSDP if data_axis == "fsdp" else SPDP
    want = runs["jax"][("gpt", axes, "plain")]
    got = [r["gpt"][(data_axis, "plain")] for r in runs["four"]]
    for g in got:
        assert g["losses"] == got[0]["losses"]
        np.testing.assert_allclose(g["losses"], want, **LOSS_TOL)
        assert not any(g["launches"].values())


def test_gpt_sequence_parallel_alone_saves_and_reloads(runs):
    """sp=2 alone: the JAX sp x dp losses (the same global batch and
    math); a Model.save on the mesh reloads into one process with the
    ranks' state."""
    two = runs["two"]
    assert two[0]["losses"] == two[1]["losses"]
    np.testing.assert_allclose(two[0]["losses"],
                               runs["jax"][("gpt", SPDP, "plain")],
                               **LOSS_TOL)
    for k in two[0]["state"]:
        np.testing.assert_array_equal(two[0]["state"][k], two[1]["state"][k])
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    net = GPTForCausalLM(GPTConfig(**S.gpt_cfg_kw()), device="cpu")
    m = ptt.Model(net)
    m.load(str(runs["dir"] / "sp2_saved"), reset_optimizer=True)
    got = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    assert sorted(got) == sorted(two[0]["state"])
    for k, v in got.items():
        np.testing.assert_array_equal(v, two[0]["state"][k], err_msg=k)


def test_evaluate_predict_and_the_k_loop_under_sp(runs):
    """On the sp=2 mesh: ``eval_batch``'s loss is the whole batch's (the
    ranks' counts weighted), ``predict_batch`` returns the whole
    sequence, both as one process computes them on the saved state; a
    K-step slab of 2 gives the two ``train_batch`` losses bit for
    bit."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTPretrainingCriterion)
    two = runs["two"]
    net = GPTForCausalLM(GPTConfig(**S.gpt_cfg_kw()), device="cpu")
    m = ptt.Model(net)
    m.prepare(loss=GPTPretrainingCriterion())
    m.load(str(runs["dir"] / "sp2_saved"), reset_optimizer=True)
    ids = S.gpt_ids()
    loss = float(m.eval_batch([ids], [ids])["loss"])
    logits = m.predict_batch([ids]).numpy()
    for r in two:
        np.testing.assert_allclose(r["eval_loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["predict"], logits, **OUT_TOL)
        assert r["loop_losses"] == r["losses"][:2]


def test_llama_style_scan_plus_sequence_parallel(runs):
    want = runs["jax"][("gpt", SPDP, "llama")]
    for r in runs["four"]:
        np.testing.assert_allclose(r["gpt"][("dp", "llama")]["losses"], want,
                                   **LOSS_TOL)


def test_gpt_sequence_parallel_trains_with_dropout_and_mask(runs):
    """A padded key mask, then attention dropout 0.3 with it, on sp=2 x
    dp=2: every rank's losses equal, the dropped run's the JAX
    package's; the mask and the dropout each change the loss."""
    g = {n: runs["four"][0]["gpt"][("dp", n)]["losses"]
         for n in ("plain", "masked", "dropped")}
    for n in ("masked", "dropped"):
        for r in runs["four"]:
            assert r["gpt"][("dp", n)]["losses"] == g[n]
    np.testing.assert_allclose(g["dropped"],
                               runs["jax"][("gpt", SPDP, "dropped")],
                               **LOSS_TOL)
    assert np.isfinite(g["dropped"]).all()
    assert not np.allclose(g["plain"], g["masked"])
    assert not np.allclose(g["masked"], g["dropped"])


def test_residual_dropout_under_sp_and_dp_matches_jax(runs):
    """The dropped run's residual dropout 0.1 on sp=2 x dp=2: each rank
    draws its rows (dp) and its sequence slice (sp) of the global masks
    (the embeddings' whole rows), as the JAX mesh does; with the masks
    of another step's key the losses would part at the first step."""
    want = runs["jax"][("gpt", SPDP, "dropped")]
    for r in runs["four"]:
        got = r["gpt"][("dp", "dropped")]["losses"]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got, want, **LOSS_TOL)


def _dense_net():
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.interop import load_reference_state
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    ptt.seed(0)
    cfg = dict(S.gpt_cfg_kw(), ring_chunk_size=None)
    net = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_reference_state(net, R.sp_weights())
    net.eval()
    return net


def _padded_forward(net, pad):
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 16)))
    kpm = np.ones((2, 16), bool)
    if pad == "left":
        kpm[:, :4] = False
    else:
        kpm[:, 12:] = False
    with torch.no_grad():
        return (net(ids, attn_mask=torch.from_numpy(kpm)).numpy(),
                net(ids).numpy())


def test_key_padding_mask_works_dense_single_device():
    """Off a mesh the sp config is dense attention: a [b, s] key mask
    is the JAX package's, and it changes the output."""
    out_m, out_p = _padded_forward(_dense_net(), "right")
    want_m, want_p = R.sp_dense_forward("right")
    assert np.isfinite(out_m).all()
    np.testing.assert_allclose(out_m, want_m, **OUT_TOL)
    np.testing.assert_allclose(out_p, want_p, **OUT_TOL)
    assert not np.allclose(out_m, out_p)


def test_left_padded_rows_zero_not_nan_dense(runs):
    """Left padding: rows whose whole causal window is padded are zero on
    the dense path, and the ring (the net called under an installed
    sp=2 mesh) gives the same output."""
    dense, _ = _padded_forward(_dense_net(), "left")
    assert np.isfinite(dense).all()
    np.testing.assert_allclose(dense, R.sp_dense_forward("left")[0],
                               **OUT_TOL)
    ring = _joined(runs["two"], lambda r: r["left_padded"])
    np.testing.assert_allclose(ring, dense, **OUT_TOL)


# -- B1's lse merges ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b1_lse_of_two_halves_merges_into_the_whole(dtype):
    """B1's lse is natural-log (the twin's base), so merging the (o,
    lse) of the two key halves gives the whole's: the ring's merge on a
    CPU tensor (kernel B1's plain twin; the card's case is
    tests/test_torch_flash_attention.py's ``cuda`` run)."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 64, generator=g).to(dt)
               for _ in range(3))
    o, lse = tfa.flash_attention_fwd_kernel(q, k, v, 0.125, False)
    o1, l1 = tfa.flash_attention_fwd_kernel(q, k[:, :32], v[:, :32], 0.125,
                                            False)
    o2, l2 = tfa.flash_attention_fwd_kernel(q, k[:, 32:], v[:, 32:], 0.125,
                                            False)
    om, lm = tra._merge(o1.float(), l1, o2.float(), l2)
    torch.testing.assert_close(lm, lse, rtol=1e-6, atol=1e-5)
    tol = 1e-5 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(om, o.float(), rtol=tol, atol=tol)
