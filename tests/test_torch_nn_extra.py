"""The port's long-tail layers and their functional forms
(``paddle_tpu_torch/nn/layers/extra.py``) against the JAX package's, the
counterpart of ``tests/test_nn_extra.py``: the same numpy inputs and the
JAX layer's randomized weights (``Bilinear``), tolerance 1e-5 on outputs
and gradients (float32 on the CPU; summation order only). ``RReLU``'s
slopes and ``AlphaDropout``'s mask come from threefry on the same key:
the mask bit for bit, the slopes to one float32 ulp (XLA fuses the
draw's scale and shift into one multiply-add), so ``RReLU``'s outputs
to two."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.core import rng as jrng  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.core import rng as trng  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from torch_nn_common import both, check_layer, close, rand  # noqa: E402

LAYERS = [("CELU", (), (2, 3, 4)),
          ("CELU", (0.2,), (2, 3, 4)),
          ("ThresholdedReLU", (0.5,), (2, 3, 4)),
          ("Tanhshrink", (), (2, 3, 4)),
          ("Hardshrink", (0.4,), (2, 3, 4)),
          ("Softshrink", (0.4,), (2, 3, 4)),
          ("Hardtanh", (-2.0, 2.0), (2, 3, 4)),
          ("GLU", (), (2, 3, 4)),
          ("LocalResponseNorm", (5,), (2, 8, 4, 4)),
          ("LocalResponseNorm", (3, 1e-3, 0.5, 2.0), (2, 6, 5)),
          ("Maxout", (3,), (2, 6, 4, 4)),
          ("Maxout", (3, -1), (2, 4, 4, 6)),
          ("PixelShuffle", (2,), (2, 8, 3, 3)),
          ("PixelShuffle", (2, "NHWC"), (2, 3, 3, 8)),
          ("PixelUnshuffle", (2,), (2, 2, 6, 4)),
          ("Unfold", (3, 2, 1), (2, 3, 7, 7)),
          ("Fold", ((7, 7), 2, 2, 0, 2), (1, 8, 9)),
          ("Fold", ((5, 6), (3, 2), 1, 1), (2, 12, 35)),
          ("Pad1D", ([2, 1], "reflect"), (2, 3, 6)),
          ("Pad3D", ([1, 0, 2, 1, 0, 1], "replicate"), (1, 2, 3, 4, 5)),
          ("Pad3D", ([1, 1, 1, 1, 1, 1], "circular"), (1, 2, 3, 4, 5)),
          ("ZeroPad2D", ([1, 1, 2, 2],), (1, 2, 4, 4)),
          ("UpsamplingBilinear2D", (None, 2), (1, 2, 4, 5)),
          ("UpsamplingNearest2D", ((7, 3),), (1, 2, 4, 5)),
          ("Bilinear", (3, 4, 5), None),
          ("CosineSimilarity", (1,), None),
          ("PairwiseDistance", (), None),
          ("PairwiseDistance", (1.0, 1e-6, True), None)]


def _inputs(name, shape):
    if shape is not None:
        return [rand(*shape, scale=2)]
    if name == "Bilinear":
        return [rand(6, 3), rand(6, 4, seed=1)]
    return [rand(6, 5), rand(6, 5, seed=1)]


@pytest.mark.parametrize("name, args, shape", LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYERS)])
def test_extra_layers_match_jax(name, args, shape):
    jl, tl = both(name, *args)
    check_layer(jl, tl, _inputs(name, shape))


def test_fold_inverts_unfold_and_sums_overlaps():
    x = rand(2, 3, 6, 6)
    cols = TF.unfold(torch.from_numpy(x), 2, 2)
    back = TF.fold(cols, (6, 6), 2, 2)
    close(back, x)
    cols = rand(1, 2 * 9, 16)
    close(TF.fold(torch.from_numpy(cols), (6, 6), 3, 1),
          JF.fold(jnp.asarray(cols), (6, 6), 3, 1))


def test_rrelu_draws_jax_slopes():
    x = -np.abs(rand(4, 64)) - 0.1
    jl, tl = both("RReLU", 0.1, 0.3)
    jrng.seed(3)
    trng.seed(3)
    want = np.asarray(jl(jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    assert np.unique(got).size > 1
    jl.eval()
    tl.eval()
    close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))


@pytest.mark.parametrize("p", [0.3, 0.7])
def test_alpha_dropout_draws_jax_mask(p):
    x = rand(2000)
    jl, tl = both("AlphaDropout", p)
    jrng.seed(5)
    trng.seed(5)
    want = np.asarray(jl(jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got == got[np.argmin(np.abs(x))],
                                  want == want[np.argmin(np.abs(x))])
    close(got, want)
    jl.eval()
    tl.eval()
    np.testing.assert_array_equal(tl(torch.from_numpy(x)).numpy(), x)


FUNCTIONAL = {
    "celu": lambda F, x: F.celu(x, 0.5),
    "thresholded_relu": lambda F, x: F.thresholded_relu(x, 0.2),
    "maxout": lambda F, x: F.maxout(x, 2, 1),
    "pixel_shuffle": lambda F, x: F.pixel_shuffle(x, 2),
    "pixel_unshuffle": lambda F, x: F.pixel_unshuffle(x, 2),
    "local_response_norm": lambda F, x: F.local_response_norm(x, 3),
    "pairwise_distance": lambda F, x: F.pairwise_distance(x, x * 0.3, 3.0),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_extra_functionals_are_exported_and_match_jax(name):
    x = rand(2, 8, 4, 6, scale=2)
    close(FUNCTIONAL[name](TF, torch.from_numpy(x)),
          FUNCTIONAL[name](JF, jnp.asarray(x)))


def test_alpha_dropout_functional_identity_in_eval():
    x = torch.from_numpy(rand(10))
    assert TF.alpha_dropout(x, 0.5, training=False) is x
    assert isinstance(tnn.AlphaDropout(0.1), tnn.Layer)
    assert jnn.AlphaDropout(0.1).p == tnn.AlphaDropout(0.1).p
