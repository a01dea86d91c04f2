"""Probability distributions (the port's counterpart of
``paddle_tpu/distribution/__init__.py``): Normal, Uniform, Categorical,
Bernoulli, Beta, Dirichlet, Multinomial, Laplace, Exponential, Gumbel,
the KL registry and ExponentialFamily.

Sampling takes keys from the ``"distribution"`` sub-stream of the global
key stream (``core/rng.py``) and draws JAX's threefry bits
(``core/threefry.py``), so a seed gives the JAX package's samples: the
closed forms bit for bit, Beta and Dirichlet through the same gamma
rejection sampler on the same keys. Parameters are float32 tensors on
the device of the tensors passed in (the flat API's device for Python
numbers), and samples are drawn there. Reparameterized samples
(Normal, Uniform, Laplace, Exponential, Gumbel) carry gradients to
their parameters.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Type

import torch

from ..core import rng as rng_mod
from ..core import threefry as _tf
from ..core import xla_math as _xm
from ..core.device import current_device


def _shape(sample_shape, batch_shape):
    return tuple(sample_shape) + tuple(batch_shape)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=current_device())


def _bshape(*ts):
    return tuple(torch.broadcast_shapes(*(t.shape for t in ts)))


class Distribution:
    """ref: distribution/distribution.py Distribution."""

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError

    def sample(self, shape: Sequence[int] = ()):
        raise NotImplementedError

    def rsample(self, shape: Sequence[int] = ()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    def entropy(self):
        raise NotImplementedError

    def _key(self):
        return rng_mod.next_key("distribution")


class Normal(Distribution):
    """ref: distribution/normal.py."""

    def __init__(self, loc, scale):
        self.loc = _f32(loc)
        self.scale = _f32(scale)
        super().__init__(_bshape(self.loc, self.scale))

    @property
    def mean(self):
        return torch.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        return torch.broadcast_to(self.scale ** 2, self.batch_shape)

    def rsample(self, shape=()):
        eps = _tf.normal(self._key(), _shape(shape, self.batch_shape),
                         self.loc.device)
        return self.loc + self.scale * eps

    sample = rsample

    def log_prob(self, value):
        var = self.scale ** 2
        return (-((value - self.loc) ** 2) / (2 * var)
                - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return torch.broadcast_to(
            0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale),
            self.batch_shape)

    def kl_divergence(self, other: "Normal"):
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


class Uniform(Distribution):
    """ref: distribution/uniform.py."""

    def __init__(self, low, high):
        self.low = _f32(low)
        self.high = _f32(high)
        super().__init__(_bshape(self.low, self.high))

    @property
    def mean(self):
        return (self.low + self.high) / 2

    @property
    def variance(self):
        return (self.high - self.low) ** 2 / 12

    def rsample(self, shape=()):
        u = _tf.uniform(self._key(), _shape(shape, self.batch_shape),
                        device=self.low.device)
        return self.low + (self.high - self.low) * u

    sample = rsample

    def log_prob(self, value):
        inside = (value >= self.low) & (value < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def entropy(self):
        return torch.broadcast_to(torch.log(self.high - self.low),
                                  self.batch_shape)


class Categorical(Distribution):
    """ref: distribution/categorical.py (logits parameterization)."""

    def __init__(self, logits=None, probs=None):
        if (logits is None) == (probs is None):
            raise ValueError("pass exactly one of logits/probs")
        if probs is not None:
            logits = _xm.log(torch.clamp(_f32(probs), min=1e-37))
        self.logits = _f32(logits)
        super().__init__(self.logits.shape[:-1])

    @property
    def probs(self):
        return torch.softmax(self.logits, dim=-1)

    def sample(self, shape=()):
        return _tf.categorical_shaped(self._key(), self.logits,
                                      _shape(shape, self.batch_shape))

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, dim=-1)
        value = torch.as_tensor(value, device=logp.device).to(torch.int64)
        logp = torch.broadcast_to(logp, value.shape + logp.shape[-1:])
        return torch.take_along_dim(logp, value[..., None], dim=-1)[..., 0]

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(-1)

    def kl_divergence(self, other: "Categorical"):
        logp = torch.log_softmax(self.logits, dim=-1)
        logq = torch.log_softmax(other.logits, dim=-1)
        return (torch.exp(logp) * (logp - logq)).sum(-1)


class Bernoulli(Distribution):
    """ref: distribution/bernoulli.py."""

    def __init__(self, probs):
        self.probs_ = _f32(probs)
        super().__init__(self.probs_.shape)

    @property
    def mean(self):
        return self.probs_

    @property
    def variance(self):
        return self.probs_ * (1 - self.probs_)

    def sample(self, shape=()):
        return _tf.bernoulli(self._key(), self.probs_,
                             _shape(shape, self.batch_shape)).to(
            torch.float32)

    def log_prob(self, value):
        p = torch.clamp(self.probs_, 1e-7, 1 - 1e-7)
        return value * torch.log(p) + (1 - value) * torch.log1p(-p)

    def entropy(self):
        p = torch.clamp(self.probs_, 1e-7, 1 - 1e-7)
        return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Beta(Distribution):
    """ref: distribution/beta.py."""

    def __init__(self, alpha, beta):
        self.alpha = _f32(alpha)
        self.beta = _f32(beta)
        super().__init__(_bshape(self.alpha, self.beta))

    @property
    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    @property
    def variance(self):
        s = self.alpha + self.beta
        return self.alpha * self.beta / (s * s * (s + 1))

    def sample(self, shape=()):
        return _tf.beta(self._key(), self.alpha, self.beta,
                        _shape(shape, self.batch_shape))

    def log_prob(self, value):
        return ((self.alpha - 1) * torch.log(value)
                + (self.beta - 1) * torch.log1p(-value)
                - _betaln(self.alpha, self.beta))

    def entropy(self):
        a, b = self.alpha, self.beta
        return (_betaln(a, b) - (a - 1) * torch.digamma(a)
                - (b - 1) * torch.digamma(b)
                + (a + b - 2) * torch.digamma(a + b))


class Dirichlet(Distribution):
    """ref: distribution/dirichlet.py."""

    def __init__(self, concentration):
        self.concentration = _f32(concentration)
        super().__init__(self.concentration.shape[:-1],
                         self.concentration.shape[-1:])

    @property
    def mean(self):
        return self.concentration / self.concentration.sum(-1,
                                                           keepdim=True)

    def sample(self, shape=()):
        return _tf.dirichlet(self._key(), self.concentration,
                             _shape(shape, self.batch_shape))

    def log_prob(self, value):
        a = self.concentration
        return ((torch.log(value) * (a - 1)).sum(-1)
                + torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1))


class Multinomial(Distribution):
    """ref: distribution/multinomial.py."""

    def __init__(self, total_count: int, probs):
        self.total_count = int(total_count)
        self.probs_ = _f32(probs)
        super().__init__(self.probs_.shape[:-1], self.probs_.shape[-1:])

    @property
    def mean(self):
        return self.total_count * self.probs_

    def sample(self, shape=()):
        n = self.probs_.shape[-1]
        draws = _tf.categorical_shaped(
            self._key(), _xm.log(torch.clamp(self.probs_, min=1e-37)),
            _shape(shape, self.batch_shape) + (self.total_count,))
        return torch.nn.functional.one_hot(draws, n).to(
            torch.float32).sum(-2)

    def log_prob(self, value):
        logp = torch.log(torch.clamp(self.probs_, min=1e-37))
        return (math.lgamma(self.total_count + 1.0)
                - torch.lgamma(value + 1.0).sum(-1)
                + (value * logp).sum(-1))


class Laplace(Distribution):
    """ref: distribution/laplace.py."""

    def __init__(self, loc, scale):
        self.loc = _f32(loc)
        self.scale = _f32(scale)
        super().__init__(_bshape(self.loc, self.scale))

    @property
    def mean(self):
        return torch.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        return torch.broadcast_to(2 * self.scale ** 2, self.batch_shape)

    def rsample(self, shape=()):
        u = _tf.uniform(self._key(), _shape(shape, self.batch_shape),
                        -0.5, 0.5, self.loc.device)
        return self.loc - self.scale * torch.sign(u) * _xm.log1p(
            -2 * torch.abs(u))

    sample = rsample

    def log_prob(self, value):
        return (-torch.abs(value - self.loc) / self.scale
                - torch.log(2 * self.scale))

    def entropy(self):
        return torch.broadcast_to(1 + torch.log(2 * self.scale),
                                  self.batch_shape)


class Exponential(Distribution):
    """Rate parameterization, mean 1/rate (ref: kernel ``exponential_``)."""

    def __init__(self, rate):
        self.rate = _f32(rate)
        super().__init__(self.rate.shape)

    @property
    def mean(self):
        return 1.0 / self.rate

    @property
    def variance(self):
        return 1.0 / torch.square(self.rate)

    def rsample(self, shape=()):
        return _tf.exponential(self._key(), _shape(shape, self.batch_shape),
                               self.rate.device) / self.rate

    sample = rsample

    def log_prob(self, value):
        return torch.log(self.rate) - self.rate * value

    def cdf(self, value):
        return -torch.expm1(-self.rate * value)

    def entropy(self):
        return torch.broadcast_to(1.0 - torch.log(self.rate),
                                  self.batch_shape)


class Gumbel(Distribution):
    """ref: distribution/gumbel.py."""

    def __init__(self, loc, scale):
        self.loc = _f32(loc)
        self.scale = _f32(scale)
        super().__init__(_bshape(self.loc, self.scale))

    @property
    def mean(self):
        return self.loc + self.scale * 0.5772156649015329

    def rsample(self, shape=()):
        g = _tf.gumbel(self._key(), _shape(shape, self.batch_shape),
                       self.loc.device)
        return self.loc + self.scale * g

    sample = rsample

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -(z + torch.exp(-z)) - torch.log(self.scale)


# ---------------------------------------------------------------------------
# KL registry (ref: distribution/kl.py kl_divergence + register_kl)
# ---------------------------------------------------------------------------

_KL_REGISTRY: Dict[Tuple[Type, Type], callable] = {}


def register_kl(type_p: Type, type_q: Type):
    def deco(fn):
        _KL_REGISTRY[(type_p, type_q)] = fn
        return fn
    return deco


def kl_divergence(p: Distribution, q: Distribution):
    fn = _KL_REGISTRY.get((type(p), type(q)))
    if fn is not None:
        return fn(p, q)
    if type(p) is type(q) and hasattr(p, "kl_divergence"):
        return p.kl_divergence(q)
    raise NotImplementedError(
        f"no KL registered for ({type(p).__name__}, {type(q).__name__})")


@register_kl(Uniform, Normal)
def _kl_uniform_normal(p: Uniform, q: Normal):
    # E_p[log p - log q] in closed form
    width = p.high - p.low
    mean = (p.low + p.high) / 2
    e_x2 = (p.low ** 2 + p.low * p.high + p.high ** 2) / 3
    return (-torch.log(width)
            + torch.log(q.scale) + 0.5 * math.log(2 * math.pi)
            + (e_x2 - 2 * q.loc * mean + q.loc ** 2)
            / (2 * q.scale ** 2))


from .transform import (AbsTransform, AffineTransform,  # noqa: E402,F401
                        ChainTransform, ExpTransform, Independent,
                        IndependentTransform, PowerTransform,
                        ReshapeTransform, SigmoidTransform,
                        SoftmaxTransform, StackTransform,
                        StickBreakingTransform, TanhTransform,
                        Transform, TransformedDistribution)


class ExponentialFamily(Distribution):
    """Exponential-family base (ref: distribution/exponential_family.py):
    subclasses expose natural parameters and the log-normalizer A(η);
    entropy is A(η) - <η, ∇A(η)> + E[log h(x)], ∇A by autograd."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        raise NotImplementedError

    def entropy(self):
        """Batch-shaped: A is elementwise over the batch, so the gradient
        of sum(A) with respect to each natural parameter is the
        per-element ∇A."""
        nat = tuple(torch.as_tensor(p).detach().requires_grad_(True)
                    for p in self._natural_parameters)
        with torch.enable_grad():
            a_val = self._log_normalizer(*nat)
            grads = torch.autograd.grad(a_val.sum(), nat)
        ent = a_val.detach() - sum(n.detach() * g
                                   for n, g in zip(nat, grads))
        return ent + self._mean_carrier_measure
