"""The port's threefry sampling recipe against ``jax.random`` (threefry2x32,
partitionable), bit for bit, over a grid of (seed, nonce, position):
the per-token key chain of the engine's ``_sample``, the random bits,
``uniform`` and the sampled ``categorical`` index.

The one place bits differ: ``gumbel`` takes ``log(-log(u))``, and XLA's
CPU ``log`` and torch's differ in the last ulp on a few elements, so
gumbel noise is compared within 4 ulps of float32 (1e-6 relative) and
the categorical draws it decides are compared exactly."""

import importlib

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu_torch.core import threefry as tf  # noqa: E402
from paddle_tpu_torch.inference import llm as tllm  # noqa: E402

jllm = importlib.import_module("paddle_tpu.inference.llm")

GRID = [(s, n, p) for s in (0, 7, 2 ** 31 - 1) for n in (0, 3, 2 ** 31 - 1)
        for p in (0, 1, 1023)]
GRID_IDS = [f"s{s}-n{n}-p{p}" for s, n, p in GRID]


def _keys(seed, nonce, position):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                               nonce), position)
    tk = tf.fold_in(tf.fold_in(tf.prng_key(seed), nonce), position)
    return jk, tk


def _u32(jax_key):
    return np.asarray(jax.random.key_data(jax_key)
                      if jnp.issubdtype(jax_key.dtype, jax.dtypes.prng_key)
                      else jax_key).astype(np.int64)


@pytest.mark.parametrize("seed,nonce,position", GRID, ids=GRID_IDS)
def test_key_chain_and_bits_identical(seed, nonce, position):
    jk, tk = _keys(seed, nonce, position)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    jb = np.asarray(jax.random.bits(jk, (97,), jnp.uint32))
    np.testing.assert_array_equal(tf.random_bits(tk, (97,)).numpy(),
                                  jb.astype(np.int64))
    ju = np.asarray(jax.random.uniform(jk, (97,)))
    np.testing.assert_array_equal(tf.uniform(tk, (97,)).numpy().view(
        np.int32), ju.view(np.int32))


@pytest.mark.parametrize("seed,nonce,position", GRID, ids=GRID_IDS)
def test_gumbel_and_categorical_match(seed, nonce, position):
    jk, tk = _keys(seed, nonce, position)
    jg = np.asarray(jax.random.gumbel(jk, (97,)))
    np.testing.assert_allclose(tf.gumbel(tk, (97,)).numpy(), jg,
                               rtol=1e-6, atol=1e-6)
    logits = np.random.RandomState(position).randn(3, 97).astype(
        np.float32)
    jc = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    np.testing.assert_array_equal(
        tf.categorical(tk, torch.from_numpy(logits)).numpy(), jc)


def test_split_identical():
    for seed in (0, 5, 99):
        js = jax.random.split(jax.random.PRNGKey(seed))
        np.testing.assert_array_equal(tf.split(tf.prng_key(seed)).numpy(),
                                      _u32(js))


def test_engine_sample_identical_to_jax():
    """The engine's ``_sample``: a batch mixing greedy rows and
    temperature rows, each keyed on its own (nonce, position)."""
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 211).astype(np.float32) * 2
    temps = np.array([0.0, 0.8, 1.0, 0.0, 0.3, 2.0], np.float32)
    nonces = np.array([0, 1, 2, 3, 2 ** 31 - 1, 17], np.int32)
    positions = np.array([0, 4, 9, 12, 1000, 3], np.int32)
    want = np.asarray(jllm._sample(
        jnp.asarray(logits), jnp.asarray(temps), jax.random.PRNGKey(3),
        jnp.asarray(nonces), jnp.asarray(positions)))
    got = tllm._sample(torch.from_numpy(logits), torch.from_numpy(temps),
                       tf.prng_key(3), torch.from_numpy(nonces),
                       torch.from_numpy(positions))
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = tllm._sample(torch.from_numpy(logits), torch.zeros(6),
                          tf.prng_key(3), torch.from_numpy(nonces),
                          torch.from_numpy(positions), any_sampled=False)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_prng_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        tf.prng_key(-1)
