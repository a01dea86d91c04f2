"""Multi-rank training of the port on gloo CPU ranks against the JAX
package's data-parallel and fully sharded meshes.

The tiny GPT of ``tests/dist_worker.py`` (vocab 64, hidden 32, 2 layers,
2 heads, s 16, batch 4, AdamW 1e-3 / wd 0.01) on the JAX package's
weights (``load_reference_state``): the port's ``dp=2`` and ``fsdp=2``
runs (two processes, every rank passing the global batch) against the
JAX package on a ``dp=2`` / ``fsdp=2`` mesh of two virtual devices,
within the JAX test's own tolerance (``tests/test_dist_multiprocess.py``:
rtol 2e-4, atol 2e-5); the ranks identical bit for bit; the fsdp shards
half of each sharded weight; residual dropout 0.1 drawing the rank's rows
of the global mask; ``dp=1`` equal to no mesh bit for bit; the K-step
fit, the numeric guard, ``Accuracy``, a stopped and resumed fit and
``DataParallel`` on a raw Layer. Every port scenario runs in one
two-rank job (``torch_dist_workers.train``) and one single-process job
(``train_one``), started together while the JAX side runs here."""

import functools
import pickle

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

import torch_dist_workers as W

RTOL, ATOL = 2e-4, 2e-5
STEPS = 6


def _ids():
    return np.random.RandomState(0).randint(0, 64, (STEPS, 4, 16))


def _masked_labels():
    """The ids with a loss mask (``ignore_index`` -100) over 11 of the 16
    positions of rows 0-1 and 2 of rows 2-3: under dp=2 the two ranks'
    means run over 10 and 28 targets."""
    labels = _ids().copy()
    labels[:, :2, :11] = -100
    labels[:, 2:, :2] = -100
    return labels


def _jax_tiny_gpt(dropout):
    import paddle_tpu as pt
    from paddle_tpu.models.gpt import (GPTConfig, GPTForCausalLM,
                                       GPTPretrainingCriterion)
    pt.seed(0)
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=2, max_position_embeddings=16,
                    hidden_dropout=dropout, attention_dropout=0.0,
                    use_flash=False)
    net = GPTForCausalLM(cfg)
    model = pt.Model(net)
    model.prepare(optimizer=pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=net, weight_decay=0.01),
        loss=GPTPretrainingCriterion())
    return model


@functools.lru_cache(maxsize=None)
def _jax_weights():
    net = _jax_tiny_gpt(0.0).network
    return {k: np.asarray(v) for k, v in net.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _jax_losses(axis, dropout=0.0, masked=False):
    import jax
    from paddle_tpu import parallel
    model = _jax_tiny_gpt(dropout)
    mesh = parallel.DeviceMesh(devices=jax.devices()[:2], **{axis: 2})
    parallel.distributed_model(model, mesh=mesh)
    ids = _ids()
    labels = _masked_labels() if masked else ids
    return [float(model.train_batch([ids[i]], [labels[i]])["loss"])
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    wpath = d / "weights.pkl"
    with open(wpath, "wb") as f:
        pickle.dump(_jax_weights(), f)
    args = {"weights": str(wpath), "ids": _ids().tolist(),
            "masked_labels": _masked_labels().tolist()}
    two = W.start_ranks("train", 2, d / "two", args)
    one = W.start_ranks("train_one", 1, d / "one", args)
    # the JAX side compiles while the ranks run
    jax_side = {k: _jax_losses(*k) for k in
                (("dp",), ("fsdp",), ("dp", 0.1), ("dp", 0.0, True))}
    return {"two": W.collect(two, timeout=300),
            "one": W.collect(one, timeout=300)[0], "jax": jax_side}


@pytest.mark.parametrize("axis", ["dp", "fsdp"])
def test_losses_match_jax_mesh(runs, axis):
    for r in (0, 1):
        np.testing.assert_allclose(
            runs["two"][r][f"{axis}_losses"], runs["jax"][(axis,)],
            rtol=RTOL, atol=ATOL, err_msg=f"{axis}=2 rank {r}")


@pytest.mark.parametrize("axis", ["dp", "fsdp"])
def test_ranks_agree_bit_for_bit(runs, axis):
    r0, r1 = runs["two"]
    assert r0[f"{axis}_losses"] == r1[f"{axis}_losses"]
    for k, v in r0[f"{axis}_params"].items():
        np.testing.assert_array_equal(v, r1[f"{axis}_params"][k],
                                      err_msg=k)


def test_fsdp_holds_half_of_each_sharded_weight(runs):
    for r in runs["two"]:
        # gpt.layers.0.mlp.fc_in.weight is [embed 32, mlp 128]: fsdp
        # shards embed (tests/test_dist_multiprocess.py:104-108)
        assert r["dp_local_shape"] == (32, 128)
        assert r["fsdp_local_shape"] == (16, 128)
        # the optimizer state is sharded like its parameter
        assert r["fsdp_opt_bytes"] <= 0.55 * r["dp_opt_bytes"]


@pytest.mark.parametrize("axis", ["dp", "fsdp"])
def test_save_and_load_on_the_mesh(runs, axis):
    """``Model.save`` writes the whole state from rank 0 (fsdp gathers
    its shards); ``load`` into a fresh Model on the mesh takes each
    rank's shards back, and the next step equals the saved Model's."""
    for r in runs["two"]:
        for k, v in r[f"{axis}_params"].items():
            np.testing.assert_array_equal(r[f"{axis}_reloaded_params"][k],
                                          v, err_msg=k)
        a, b = r[f"{axis}_reloaded_next"]
        assert a == b


def test_loss_mask_weights_each_rank_by_its_count(runs):
    """The ranks' means run over 10 and 28 targets: the global loss and
    gradient weight each by its count over 38, as the JAX package's one
    program does (an even average of the two means would not match)."""
    want = runs["jax"][("dp", 0.0, True)]
    for r in runs["two"]:
        np.testing.assert_allclose(r["masked_losses"], want, rtol=RTOL,
                                   atol=ATOL)
    assert runs["two"][0]["masked_losses"] == \
        runs["two"][1]["masked_losses"]


def test_fsdp_global_norms_sum_over_the_shards(runs):
    """``ClipGradByGlobalNorm`` (clipping every step here) and the
    numeric guard under fsdp take the whole gradient's norm, summed over
    the shards: the same norms, losses and parameters as under dp, up to
    summation order, and the ranks identical."""
    r0, r1 = runs["two"]
    for r in (r0, r1):
        assert max(r["clip_dp_gnorms"]) > 0.05   # the clip is active
        np.testing.assert_allclose(r["clip_fsdp_gnorms"],
                                   r["clip_dp_gnorms"], rtol=1e-5)
        np.testing.assert_allclose(r["clip_fsdp_losses"],
                                   r["clip_dp_losses"], rtol=1e-5)
        for k, v in r["clip_dp_params"].items():
            np.testing.assert_allclose(r["clip_fsdp_params"][k], v,
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert r0["clip_fsdp_gnorms"] == r1["clip_fsdp_gnorms"]
    assert r0["clip_fsdp_losses"] == r1["clip_fsdp_losses"]
    assert r0["clip_dp_losses"] != r0["dp_losses"]   # clipping changed them


def test_dropout_dp2_draws_the_rank_rows_of_the_global_mask(runs):
    want = runs["jax"][("dp", 0.1)]
    assert want != runs["jax"][("dp",)]    # the masks changed the losses
    for r in runs["two"]:
        np.testing.assert_allclose(r["dropout_losses"], want, rtol=RTOL,
                                   atol=ATOL)


def test_dp1_equals_no_mesh_bit_for_bit(runs):
    one = runs["one"]
    assert one["dp1_losses"] == one["plain_losses"]
    for k, v in one["plain_params"].items():
        np.testing.assert_array_equal(one["dp1_params"][k], v, err_msg=k)


def test_fit_k4_equals_k1_under_dp2(runs):
    for r in runs["two"]:
        assert r["fit_k4_losses"] == r["fit_k1_losses"]
        assert len(r["fit_k1_losses"]) == STEPS
        for k, v in r["fit_k1_params"].items():
            np.testing.assert_array_equal(r["fit_k4_params"][k], v)
    np.testing.assert_allclose(runs["two"][0]["fit_k1_losses"],
                               runs["jax"][("dp",)], rtol=RTOL, atol=ATOL)


def test_accuracy_under_dp2_equals_one_process(runs):
    one = runs["one"]["accuracy"]
    for r in runs["two"]:
        got = r["accuracy"]
        assert set(got) == set(one) and "acc_top1" in got
        assert got["acc_top1"] == one["acc_top1"]
        assert got["acc_top2"] == one["acc_top2"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)


def test_guard_skip_lands_on_both_ranks(runs):
    r0, r1 = runs["two"]
    assert r0["guard_skipped"] == r1["guard_skipped"] == 1
    assert np.isnan(r0["guard_losses"][1]) and np.isnan(
        r1["guard_losses"][1])
    for k, v in r0["guard_params"].items():
        np.testing.assert_array_equal(v, r1["guard_params"][k], err_msg=k)


def test_fit_resumed_under_dp2_equals_uninterrupted(runs):
    for r in runs["two"]:
        assert len(r["resume_full"]) == 2 * STEPS
        assert r["resume_parts"] == r["resume_full"]


def test_data_parallel_on_a_raw_layer(runs):
    one = runs["one"]["data_parallel"]
    r0, r1 = (r["data_parallel"] for r in runs["two"])
    assert r0["rows"] == r1["rows"] == 4 and one["rows"] == 8
    for k, v in one["params"].items():
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k])
        np.testing.assert_allclose(r0["params"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
