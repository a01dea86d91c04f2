"""The port's key streams and dropout against the JAX package's
(``paddle_tpu/core/rng.py``, ``paddle_tpu/nn/functional.py::dropout``,
the step key of ``Model.train_batch``).

Keys and masks are compared bit for bit: both packages run JAX's
threefry. The GPT run under dropout 0.1 is held to
tests/test_torch_train.py's O0 tolerance, per-step loss 1e-5 relative:
with the same masks the two runs differ in float32 summation order
only."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu_torch.core import rng as trng  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402

try:
    import jax
    import jax.numpy as jnp

    import paddle_tpu as jpt
    from paddle_tpu.core import rng as jrng
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu.nn import functional as JF
except ImportError:
    # the card's machine has no JAX; it runs only the cuda-marked test
    jax = jnp = jpt = jrng = jgpt = JF = None


def _bits(key):
    """A key of either package as two uint32 values."""
    if isinstance(key, torch.Tensor):
        return [int(v) for v in key.tolist()]
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return [int(v) for v in np.asarray(key)]


@pytest.mark.parametrize("seed", [0, 1234])
def test_key_streams_match_jax(seed):
    """seed, named sub-streams ("global", "local", draws interleaved),
    split_for_step and key_guard give JAX's keys."""
    jrng.seed(seed)
    trng.seed(seed)
    names = ["global", "local", "global", "global", "local", "sp_attn"]
    for name in names:
        assert _bits(trng.next_key(name)) == _bits(jrng.next_key(name))
    for step in (0, 1, 5, 1000):
        assert _bits(trng.split_for_step(step)) == \
            _bits(jrng.split_for_step(step))
    with jrng.key_guard(jrng.split_for_step(3)), \
            trng.key_guard(trng.split_for_step(3)):
        for name in names:
            assert _bits(trng.next_key(name)) == _bits(jrng.next_key(name))
    # the guard popped: draws continue on the global stream
    assert _bits(trng.next_key()) == _bits(jrng.next_key())


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_masks_match_jax(mode):
    """F.dropout under one key_guard: the same elements dropped, the
    same values kept (f32 and bf16 inputs, two draws per stream)."""
    jrng.seed(0)
    trng.seed(0)
    x = np.random.RandomState(0).randn(4, 33, 16).astype(np.float32)
    with jrng.key_guard(jrng.split_for_step(5)), \
            trng.key_guard(trng.split_for_step(5)):
        for dtype, name in ((jnp.float32, "global"),
                            (jnp.bfloat16, "global"),
                            (jnp.float32, "local")):
            want = np.asarray(JF.dropout(jnp.asarray(x, dtype), 0.1,
                                         mode=mode, rng_name=name),
                              np.float32)
            tx = torch.from_numpy(x).to(getattr(torch, jnp.dtype(dtype)
                                                .name))
            got = TF.dropout(tx, 0.1, mode=mode, rng_name=name)
            assert got.dtype == tx.dtype
            np.testing.assert_array_equal(got.float().numpy() == 0,
                                          want == 0)
            np.testing.assert_array_equal(got.float().numpy(), want)
    for training in (True, False):
        np.testing.assert_array_equal(
            TF.dropout(torch.from_numpy(x), 0.0, training=training).numpy(),
            x)
    np.testing.assert_allclose(
        TF.dropout(torch.from_numpy(x), 0.1, training=False,
                   mode=mode).numpy(),
        np.asarray(JF.dropout(jnp.asarray(x), 0.1, training=False,
                              mode=mode)), rtol=1e-7)


def test_dropout_layer_draws_from_the_stream():
    trng.seed(0)
    layer = tpt.nn.Dropout(0.5)
    x = torch.ones(64, 64)
    a = layer(x)
    b = layer(x)
    assert not torch.equal(a, b)            # two draws, two masks
    assert set(a.unique().tolist()) == {0.0, 2.0}
    trng.seed(0)
    assert torch.equal(layer(x), a)         # the seed replays them
    assert torch.equal(layer.eval()(x), x)


@pytest.mark.cuda
def test_dropout_mask_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(8, 128, 768)
    got = []
    for dev in ("cpu", "cuda"):
        trng.seed(3)
        with trng.key_guard(trng.split_for_step(2)):
            got.append(TF.dropout(x.to(dev), 0.1).cpu())
    assert torch.equal(got[0], got[1])


def _tiny(m):
    return m.gpt_config("gpt2-small", num_layers=2, hidden_size=64,
                        num_heads=2, vocab_size=97,
                        max_position_embeddings=64, hidden_dropout=0.1,
                        attention_dropout=0.1, fused_loss=True)


def test_gpt_train_steps_with_dropout_match_jax():
    """Two O0 Model.train_batch steps of a tiny GPT at hidden and
    attention dropout 0.1 (the eager attention path: flash takes no
    dropout) in both packages from one seed, weights and batch: the same
    step keys give the same masks, hence the same losses."""
    jpt.seed(0)
    tpt.seed(0)
    jnet = jgpt.GPTForCausalLM(_tiny(jgpt))
    tnet = tgpt.GPTForCausalLM(_tiny(tgpt), device="cpu")
    load_reference_state(tnet, {k: np.asarray(v)
                                for k, v in jnet.state_dict().items()})
    jm, tm = jpt.Model(jnet), tpt.Model(tnet)
    jm.prepare(jpt.optimizer.AdamW(1e-3, parameters=jnet),
               jgpt.GPTFusedPretrainingCriterion())
    tm.prepare(tpt.optimizer.AdamW(1e-3, parameters=tnet),
               tgpt.GPTFusedPretrainingCriterion())
    ids = np.random.RandomState(0).randint(0, 97, (2, 64))
    no_dropout = float(tm.eval_batch([ids], [ids])["loss"])
    for step in range(2):
        want = float(jm.train_batch([ids], [ids])["loss"])
        got = float(tm.train_batch([ids], [ids])["loss"])
        np.testing.assert_allclose(got, want, rtol=1e-5)
        if step == 0:   # dropout is live: not the loss without it
            assert abs(got - no_dropout) > 1e-4 * no_dropout
