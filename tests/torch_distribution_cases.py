"""The port's ``distribution`` (the ten distributions, the KL registry,
ExponentialFamily) and ``distribution.transform`` against the JAX
package's on the same parameters and seeds.

Densities, moments and transforms: float32 within ``1e-6 + 1e-5 |jax|``.
Samples: the closed forms (Normal, Uniform, Categorical, Bernoulli,
Laplace, Exponential, Gumbel, Multinomial) bit for bit. Beta and
Dirichlet go through JAX's gamma rejection sampler on the same keys; the
sampler's ``rsqrt`` starts from a processor-specific estimate on the JAX
side (``core/xla_math.py::rsqrt``), so the share of exactly equal draws
is measured and held to ``REJECTION_EQUAL_SHARE``, and the rest is held
to the distribution's mean and variance within 5 sigma.

The cases of ``tests/test_torch_distribution.py`` and
``tests/test_torch_distribution_p2.py``: each of those files installs
one part of ``TESTS`` (``tests/torch_parts.py``: at most 26 tests a
file)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parts import split

torch = pytest.importorskip("torch")

import paddle_tpu_torch as T  # noqa: E402
import paddle_tpu_torch.distribution as TD  # noqa: E402
from paddle_tpu_torch.core import device as tdev  # noqa: E402

import paddle_tpu as J  # noqa: E402
import paddle_tpu.distribution as JD  # noqa: E402
from torch_tensor_cases import _np, check  # noqa: E402

F32 = np.float32
# Beta / Dirichlet draws exactly equal to JAX's, over this file's
# parameters (measured 0.957 for the Beta set, 1.0 for the Dirichlet set)
REJECTION_EQUAL_SHARE = 0.9


@pytest.fixture(autouse=True)
def _on_cpu():
    T.set_device("cpu")
    yield
    tdev.set_current(None)


def a32(*v):
    return np.array(v, F32)


# name -> (constructor args, a value inside the support)
DISTS = {
    "Normal": (lambda D: D.Normal(a32(0.5, -1.0), a32(2.0, 0.3)),
               a32(0.1, -0.7)),
    "Uniform": (lambda D: D.Uniform(a32(-1.0, 0.0), a32(2.0, 0.5)),
                a32(0.3, 0.25)),
    "Categorical": (lambda D: D.Categorical(
        logits=np.array([[0.1, 0.5, 2.0], [1.0, -1.0, 0.0]], F32)),
        np.array([2, 0])),
    "Categorical_probs": (lambda D: D.Categorical(
        probs=a32(0.2, 0.3, 0.5)), np.array(1)),
    "Bernoulli": (lambda D: D.Bernoulli(a32(0.3, 0.8)), a32(1.0, 0.0)),
    "Beta": (lambda D: D.Beta(a32(0.5, 2.0), a32(3.0, 1.5)),
             a32(0.2, 0.7)),
    "Dirichlet": (lambda D: D.Dirichlet(a32(0.3, 1.0, 4.0)),
                  a32(0.2, 0.3, 0.5)),
    "Multinomial": (lambda D: D.Multinomial(10, a32(0.2, 0.3, 0.5)),
                    a32(2.0, 3.0, 5.0)),
    "Laplace": (lambda D: D.Laplace(a32(0.0, 1.0), a32(1.5, 0.5)),
                a32(0.4, 2.0)),
    "Exponential": (lambda D: D.Exponential(a32(2.0, 0.5)), a32(0.3, 4.0)),
    "Gumbel": (lambda D: D.Gumbel(a32(0.0, 1.0), a32(1.0, 2.0)),
               a32(0.5, -1.0)),
}

_MOMENTS = ("mean", "variance")
_NO_VARIANCE = {"Categorical", "Categorical_probs", "Dirichlet",
                "Multinomial", "Gumbel"}
_NO_ENTROPY = {"Dirichlet", "Multinomial", "Gumbel"}


def _stats(D, name):
    build, value = DISTS[name]
    d = build(D)
    out = [list(d.batch_shape), list(d.event_shape)]
    if name not in ("Categorical", "Categorical_probs"):
        out.append(d.mean)
    if name not in _NO_VARIANCE:
        out.append(d.variance)
    v = J.to_tensor(value) if D is JD else T.to_tensor(value)
    out += [d.log_prob(v), d.prob(v)]
    if name not in _NO_ENTROPY:
        out.append(d.entropy())
    if name.startswith("Categorical"):
        out.append(d.probs)
    if name == "Exponential":
        out.append(d.cdf(v))
    return out


def test_densities_and_moments(name):
    check(_stats(TD, name), _stats(JD, name))


CLOSED_FORM = ["Normal", "Uniform", "Categorical", "Categorical_probs",
               "Bernoulli", "Multinomial", "Laplace", "Exponential",
               "Gumbel"]


def test_closed_form_samples_are_bit_equal(name):
    J.seed(21)
    T.seed(21)
    want = [DISTS[name][0](JD).sample([257]) for _ in range(2)]
    got = [DISTS[name][0](TD).sample([257]) for _ in range(2)]
    check(got, want, exact=True)


def test_rsample_carries_gradients(name):
    """A reparameterized sample's gradient with respect to the
    parameters, against jax.grad's through the same draw."""
    params = {"Normal": (a32(0.5, -1.0), a32(2.0, 0.3)),
              "Laplace": (a32(0.0, 1.0), a32(1.5, 0.5)),
              "Exponential": (a32(2.0, 0.5),),
              "Gumbel": (a32(0.0, 1.0), a32(1.0, 2.0)),
              "Uniform": (a32(-1.0, 0.0), a32(2.0, 0.5))}[name]

    def jloss(*ps):
        J.seed(4)
        return jnp.sum(getattr(JD, name)(*ps).rsample([64]) ** 2)
    want = jax.grad(jloss, argnums=tuple(range(len(params))))(
        *[jnp.asarray(p) for p in params])
    tps = [torch.tensor(p, requires_grad=True) for p in params]
    T.seed(4)
    (getattr(TD, name)(*tps).rsample([64]) ** 2).sum().backward()
    check([p.grad for p in tps], list(want))


def _share_and_moments(jdraw, tdraw, mean, var):
    j, t = np.asarray(jdraw), _np(tdraw)
    assert j.shape == t.shape
    n = t.shape[0]
    for got in (t, j):
        sigma = np.sqrt(var / n)
        assert np.all(np.abs(got.mean(0) - mean) <= 5 * sigma + 1e-7)
        # the sample variance's standard error, ~ var sqrt(2 / n) for
        # these near-normal sums
        assert np.all(np.abs(got.var(0) - var)
                      <= 5 * var * math.sqrt(2.0 / n) + 1e-7)
    return float((j == t).mean())


def test_beta_rejection_sampler_share_and_moments():
    a = a32(0.5, 2.0, 7.3, 0.2)
    b = a32(3.0, 1.5, 11.0, 0.7)
    J.seed(8)
    T.seed(8)
    want = JD.Beta(a, b).sample([4000])
    got = TD.Beta(a, b).sample([4000])
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1))
    share = _share_and_moments(want, got, mean, var)
    assert share >= REJECTION_EQUAL_SHARE, share


def test_dirichlet_rejection_sampler_share_and_moments():
    c = a32(0.3, 1.0, 4.0)
    J.seed(9)
    T.seed(9)
    want = JD.Dirichlet(c).sample([4000])
    got = TD.Dirichlet(c).sample([4000])
    s = c.sum()
    mean = c / s
    var = c * (s - c) / (s * s * (s + 1))
    share = _share_and_moments(want, got, mean, var)
    assert share >= REJECTION_EQUAL_SHARE, share


def test_poisson_rejection_and_knuth_draws_are_equal():
    """Poisson's loops end in an integer, and every draw is equal."""
    lam = np.concatenate([np.full(2000, 2.5, F32), np.full(2000, 37.0, F32)])
    J.seed(12)
    T.seed(12)
    want = J.poisson(J.to_tensor(lam))
    got = T.poisson(T.to_tensor(lam))
    check(got, want, exact=True)


# ---------------------------------------------------------------------------
# KL
# ---------------------------------------------------------------------------

KL = [
    ("normal_normal", lambda D: D.kl_divergence(
        D.Normal(a32(0.0, 1.0), a32(1.0, 2.0)),
        D.Normal(a32(0.5, -1.0), a32(2.0, 0.3)))),
    ("categorical", lambda D: D.kl_divergence(
        D.Categorical(logits=a32(0.1, 0.5, 2.0)),
        D.Categorical(logits=a32(1.0, -1.0, 0.0)))),
    ("uniform_normal_registered", lambda D: D.kl_divergence(
        D.Uniform(a32(-1.0, 0.0), a32(2.0, 0.5)),
        D.Normal(a32(0.5, -1.0), a32(2.0, 0.3)))),
]


def test_kl(name, fn):
    check(fn(TD), fn(JD))


def test_register_kl_and_missing_pair():
    for D in (JD, TD):
        class MyNormal(D.Normal):
            pass

        @D.register_kl(MyNormal, D.Laplace)
        def _kl(p, q):
            return p.loc * 0 + 7.0
        assert float(D.kl_divergence(MyNormal(0.0, 1.0),
                                     D.Laplace(0.0, 1.0))) == 7.0
        with pytest.raises(NotImplementedError):
            D.kl_divergence(D.Laplace(0.0, 1.0), D.Normal(0.0, 1.0))


def _exp_family(D, m):
    class Poissonish(D.ExponentialFamily):
        """An exponential-family Normal: natural parameters
        (mu / s^2, -1 / (2 s^2))."""

        def __init__(self, loc, scale):
            self.loc, self.scale = loc, scale
            super().__init__(tuple(loc.shape))

        @property
        def _natural_parameters(self):
            return (self.loc / self.scale ** 2,
                    -0.5 / self.scale ** 2)

        def _log_normalizer(self, x, y):
            return -0.25 * x ** 2 / y + 0.5 * m.log(-math.pi / y)

        @property
        def _mean_carrier_measure(self):
            return 0.0
    return Poissonish


def test_exponential_family_entropy_by_autodiff():
    loc, scale = a32(0.5, -1.0, 2.0), a32(2.0, 0.3, 1.0)
    want = _exp_family(JD, J)(J.to_tensor(loc), J.to_tensor(scale)).entropy()
    got = _exp_family(TD, T)(T.to_tensor(loc), T.to_tensor(scale)).entropy()
    check(got, want)
    check(got, TD.Normal(loc, scale).entropy())


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _transforms(D):
    return {
        "abs": D.AbsTransform(),
        "affine": D.AffineTransform(a32(0.5, -1.0), a32(2.0, -0.5)),
        "exp": D.ExpTransform(),
        "power": D.PowerTransform(a32(3.0)),
        "sigmoid": D.SigmoidTransform(),
        "tanh": D.TanhTransform(),
        "stick_breaking": D.StickBreakingTransform(),
        "reshape": D.ReshapeTransform((2,), (2, 1)),
        "chain": D.ChainTransform([D.AffineTransform(a32(0.1), a32(2.0)),
                                   D.TanhTransform()]),
        "independent": D.IndependentTransform(D.ExpTransform(), 1),
        "stack": D.StackTransform([D.ExpTransform(), D.SigmoidTransform()],
                                  axis=1),
    }


_X = np.array([[0.3, -0.6], [0.9, 0.2], [-0.4, 0.5]], F32)


def test_transform(name):
    def run(D, m):
        t = _transforms(D)[name]
        x = m.to_tensor(np.abs(_X) + 0.1 if name == "power" else _X)
        y = t.forward(x)
        out = [y, t.inverse(y), list(t.forward_shape((3, 2))),
               list(t.inverse_shape(t.forward_shape((3, 2)))),
               t.forward_log_det_jacobian(x)]
        if name not in ("stick_breaking", "reshape", "independent",
                        "stack"):
            out.append(t.inverse_log_det_jacobian(y))
        out.append(t(x))
        return out
    check(run(TD, T), run(JD, J))


def test_softmax_transform_and_its_refusal():
    x = np.array([[0.3, -0.6, 1.0]], F32)
    for D, m in ((JD, J), (TD, T)):
        t = D.SoftmaxTransform()
        with pytest.raises(NotImplementedError):
            t.forward_log_det_jacobian(m.to_tensor(x))
    check(TD.SoftmaxTransform().forward(T.to_tensor(x)),
          JD.SoftmaxTransform().forward(J.to_tensor(x)))
    check(TD.SoftmaxTransform().inverse(T.to_tensor(np.abs(x))),
          JD.SoftmaxTransform().inverse(J.to_tensor(np.abs(x))))


def _transformed(D, m):
    base = D.Normal(a32(0.0, 0.5), a32(1.0, 2.0))
    td = D.TransformedDistribution(base, [D.AffineTransform(1.0, 3.0),
                                          D.ExpTransform()])
    sb = D.TransformedDistribution(
        D.Normal(a32(0.0, 0.1, -0.2), a32(1.0, 1.0, 1.0)),
        [D.StickBreakingTransform()])
    ind = D.Independent(D.Normal(np.zeros((3, 2), F32),
                                 np.ones((3, 2), F32)), 1)
    v = m.to_tensor(a32(1.5, 0.7))
    s = m.to_tensor(a32(0.2, 0.3, 0.1, 0.4))
    x = m.to_tensor(np.full((3, 2), 0.3, F32))
    return [list(td.batch_shape), list(td.event_shape), td.log_prob(v),
            list(sb.batch_shape), list(sb.event_shape), sb.log_prob(s),
            list(ind.batch_shape), list(ind.event_shape), ind.log_prob(x),
            ind.entropy(), ind.mean, ind.variance]


def test_transformed_distribution_and_independent():
    check(_transformed(TD, T), _transformed(JD, J))
    J.seed(2)
    T.seed(2)
    jd = JD.TransformedDistribution(JD.Normal(0.0, 1.0),
                                    [JD.ExpTransform()])
    tdist = TD.TransformedDistribution(TD.Normal(0.0, 1.0),
                                       [TD.ExpTransform()])
    check([tdist.sample([5]), tdist.rsample([5])],
          [jd.sample([5]), jd.rsample([5])])


_RSAMPLE = ["Normal", "Laplace", "Exponential", "Gumbel", "Uniform"]
TESTS = [
    ("test_densities_and_moments", test_densities_and_moments,
     [(n,) for n in sorted(DISTS)], sorted(DISTS)),
    ("test_closed_form_samples_are_bit_equal",
     test_closed_form_samples_are_bit_equal, [(n,) for n in CLOSED_FORM],
     CLOSED_FORM),
    ("test_rsample_carries_gradients", test_rsample_carries_gradients,
     [(n,) for n in _RSAMPLE], _RSAMPLE),
    ("test_beta_rejection_sampler_share_and_moments",
     test_beta_rejection_sampler_share_and_moments, None, None),
    ("test_dirichlet_rejection_sampler_share_and_moments",
     test_dirichlet_rejection_sampler_share_and_moments, None, None),
    ("test_poisson_rejection_and_knuth_draws_are_equal",
     test_poisson_rejection_and_knuth_draws_are_equal, None, None),
    ("test_kl", test_kl, KL, [k[0] for k in KL]),
    ("test_register_kl_and_missing_pair", test_register_kl_and_missing_pair,
     None, None),
    ("test_exponential_family_entropy_by_autodiff",
     test_exponential_family_entropy_by_autodiff, None, None),
    ("test_transform", test_transform,
     [(n,) for n in sorted(_transforms(TD))], sorted(_transforms(TD))),
    ("test_softmax_transform_and_its_refusal",
     test_softmax_transform_and_its_refusal, None, None),
    ("test_transformed_distribution_and_independent",
     test_transformed_distribution_and_independent, None, None),
]
PARTS = split(TESTS, 2)
