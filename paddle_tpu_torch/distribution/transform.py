"""Probability transforms + TransformedDistribution + Independent.

The port's counterpart of ``paddle_tpu/distribution/transform.py``.

Reference being replaced: python/paddle/distribution/transform.py
(Transform base :50 with forward/inverse/*_log_det_jacobian and the
concrete transforms Abs:318, Affine:390, Chain:467, Exp:590,
Independent:639, Power:730, Reshape:793, Sigmoid:900, Softmax:943,
Stack:999, StickBreaking:1104, Tanh:1169),
transformed_distribution.py:22 ``TransformedDistribution`` and
independent.py:18 ``Independent``.

Each transform is a pair of torch expressions plus an analytic
log|det J|, differentiable through torch's autograd."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from . import Distribution


def _sum(x, dims):
    """``x.sum(axis=dims)`` as ``jnp`` does it: no dims, no reduction."""
    return x.sum(dim=tuple(dims)) if len(dims) else x


class Transform:
    """ref: transform.py:50."""

    _domain_event_dim = 0  # event dims consumed by forward

    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def forward_log_det_jacobian(self, x):
        raise NotImplementedError

    def inverse_log_det_jacobian(self, y):
        return -self.forward_log_det_jacobian(self.inverse(y))

    def forward_shape(self, shape):
        return tuple(shape)

    def inverse_shape(self, shape):
        return tuple(shape)

    def __call__(self, x):
        if isinstance(x, Distribution):
            return TransformedDistribution(x, [self])
        return self.forward(x)


class AbsTransform(Transform):
    """y = |x| (non-injective; inverse returns the positive branch,
    ref: transform.py:318 same convention)."""

    def forward(self, x):
        return torch.abs(x)

    def inverse(self, y):
        return y

    def forward_log_det_jacobian(self, x):
        return torch.zeros_like(x)


class AffineTransform(Transform):
    def __init__(self, loc, scale):
        self.loc = torch.as_tensor(loc)
        self.scale = torch.as_tensor(scale)

    def forward(self, x):
        return self.loc + self.scale * x

    def inverse(self, y):
        return (y - self.loc) / self.scale

    def forward_log_det_jacobian(self, x):
        return torch.broadcast_to(torch.log(torch.abs(self.scale)),
                                  x.shape)


class ExpTransform(Transform):
    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def forward_log_det_jacobian(self, x):
        return x


class PowerTransform(Transform):
    def __init__(self, power):
        self.power = torch.as_tensor(power)

    def forward(self, x):
        return torch.pow(x, self.power)

    def inverse(self, y):
        return torch.pow(y, 1.0 / self.power)

    def forward_log_det_jacobian(self, x):
        return torch.log(torch.abs(self.power * torch.pow(x,
                                                      self.power - 1)))


class SigmoidTransform(Transform):
    def forward(self, x):
        return torch.sigmoid(x)

    def inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def forward_log_det_jacobian(self, x):
        return -F.softplus(-x) - F.softplus(x)


class TanhTransform(Transform):
    def forward(self, x):
        return torch.tanh(x)

    def inverse(self, y):
        return torch.atanh(y)

    def forward_log_det_jacobian(self, x):
        # log(1 - tanh(x)^2) = 2(log2 - x - softplus(-2x))
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class SoftmaxTransform(Transform):
    """Not bijective (ref: transform.py:943 — same caveat); inverse is
    log, normalization dropped."""

    _domain_event_dim = 1

    def forward(self, x):
        return torch.softmax(x, dim=-1)

    def inverse(self, y):
        return torch.log(y)

    def forward_log_det_jacobian(self, x):
        raise NotImplementedError("softmax is not bijective")


class StickBreakingTransform(Transform):
    """R^{K-1} → simplex^K (ref: transform.py:1104)."""

    _domain_event_dim = 1

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    def forward(self, x):
        k = x.shape[-1]
        offset = torch.log(torch.arange(k, 0, -1, dtype=x.dtype,
                                        device=x.device))
        z = torch.sigmoid(x - offset)
        zpad = torch.cat([z, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype,
                                        device=x.device)], dim=-1)
        one_minus = torch.cat(
            [torch.ones(x.shape[:-1] + (1,), dtype=x.dtype,
                        device=x.device),
             torch.cumprod(1 - z, dim=-1)], dim=-1)
        return zpad * one_minus

    def inverse(self, y):
        k = y.shape[-1] - 1  # number of x components
        cum = torch.cumsum(y[..., :-1], dim=-1)
        rem = 1.0 - cum + y[..., :-1]  # remaining mass incl. current
        z = y[..., :-1] / rem
        offset = torch.log(torch.arange(k, 0, -1, dtype=y.dtype,
                                        device=y.device))
        return torch.log(z) - torch.log1p(-z) + offset

    def forward_log_det_jacobian(self, x):
        k = x.shape[-1]
        offset = torch.log(torch.arange(k, 0, -1, dtype=x.dtype,
                                        device=x.device))
        z = torch.sigmoid(x - offset)
        one_minus = torch.cat(
            [torch.ones(x.shape[:-1] + (1,), dtype=x.dtype,
                        device=x.device),
             torch.cumprod(1 - z, dim=-1)[..., :-1]], dim=-1)
        detj = torch.log(z) + torch.log1p(-z) + torch.log(one_minus)
        return detj.sum(-1)


class ReshapeTransform(Transform):
    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(in_event_shape)
        self.out_event_shape = tuple(out_event_shape)
        if math.prod(self.in_event_shape) != \
                math.prod(self.out_event_shape):
            raise ValueError("event sizes differ")
        self._domain_event_dim = len(self.in_event_shape)

    def forward_shape(self, shape):
        cut = len(shape) - len(self.in_event_shape)
        return tuple(shape[:cut]) + self.out_event_shape

    def inverse_shape(self, shape):
        cut = len(shape) - len(self.out_event_shape)
        return tuple(shape[:cut]) + self.in_event_shape

    def forward(self, x):
        batch = tuple(x.shape[:x.ndim - len(self.in_event_shape)])
        return x.reshape(batch + self.out_event_shape)

    def inverse(self, y):
        batch = tuple(y.shape[:y.ndim - len(self.out_event_shape)])
        return y.reshape(batch + self.in_event_shape)

    def forward_log_det_jacobian(self, x):
        batch = tuple(x.shape[:x.ndim - len(self.in_event_shape)])
        return torch.zeros(batch, dtype=x.dtype, device=x.device)


class ChainTransform(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)
        self._domain_event_dim = max(
            [t._domain_event_dim for t in self.transforms] or [0])

    def forward(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def inverse(self, y):
        for t in reversed(self.transforms):
            y = t.inverse(y)
        return y

    def forward_shape(self, shape):
        for t in self.transforms:
            shape = t.forward_shape(shape)
        return tuple(shape)

    def inverse_shape(self, shape):
        for t in reversed(self.transforms):
            shape = t.inverse_shape(shape)
        return tuple(shape)

    def forward_log_det_jacobian(self, x):
        # batch dims are fixed at entry; every member's jacobian is
        # reduced to them, so shape-changing members (Reshape,
        # StickBreaking) compose with elementwise ones correctly
        batch_ndim = x.ndim - self._domain_event_dim
        total = 0.0
        for t in self.transforms:
            j = t.forward_log_det_jacobian(x)
            if j.ndim > batch_ndim:
                j = _sum(j, range(batch_ndim, j.ndim))
            total = total + j
            x = t.forward(x)
        return total


class IndependentTransform(Transform):
    """Reinterprets batch dims of a base transform as event dims
    (ref: transform.py:639)."""

    def __init__(self, base: Transform, reinterpreted_batch_rank: int):
        self.base = base
        self.rank = reinterpreted_batch_rank
        self._domain_event_dim = base._domain_event_dim + self.rank

    def forward(self, x):
        return self.base.forward(x)

    def inverse(self, y):
        return self.base.inverse(y)

    def forward_log_det_jacobian(self, x):
        j = self.base.forward_log_det_jacobian(x)
        return _sum(j, range(j.ndim - self.rank, j.ndim))


class StackTransform(Transform):
    """Applies transforms[i] to slice i along ``axis``
    (ref: transform.py:999)."""

    def __init__(self, transforms: Sequence[Transform], axis: int = 0):
        self.transforms = list(transforms)
        self.axis = axis

    def _map(self, fn_name, x):
        parts = torch.tensor_split(x, len(self.transforms), dim=self.axis)
        outs = [getattr(t, fn_name)(p.squeeze(self.axis))
                for t, p in zip(self.transforms, parts)]
        return torch.stack(outs, dim=self.axis)

    def forward(self, x):
        return self._map("forward", x)

    def inverse(self, y):
        return self._map("inverse", y)

    def forward_log_det_jacobian(self, x):
        return self._map("forward_log_det_jacobian", x)


# ---------------------------------------------------------------------------

class TransformedDistribution(Distribution):
    """ref: transformed_distribution.py:22 — base distribution pushed
    through a chain of transforms; log_prob via the change of
    variables."""

    def __init__(self, base: Distribution, transforms):
        self.base = base
        self.transform = ChainTransform(list(transforms))
        bs = tuple(getattr(base, "batch_shape", ()))
        es = tuple(getattr(base, "event_shape", ()))
        # a transform consuming more event dims than the base declares
        # promotes trailing batch dims to event dims (torch-style)
        extra = max(self.transform._domain_event_dim - len(es), 0)
        if extra > len(bs):
            raise ValueError(
                f"transform needs {self.transform._domain_event_dim} "
                f"event dims; base has only {len(bs) + len(es)}")
        out = self.transform.forward_shape(bs + es)
        cut = len(bs) - extra
        super().__init__(out[:cut], out[cut:])

    def sample(self, shape: Sequence[int] = ()):
        return self.transform.forward(self.base.sample(shape))

    def rsample(self, shape: Sequence[int] = ()):
        base_rsample = getattr(self.base, "rsample", self.base.sample)
        return self.transform.forward(base_rsample(shape))

    def log_prob(self, value):
        x = self.transform.inverse(value)
        ldj = self.transform.forward_log_det_jacobian(x)
        base_lp = self.base.log_prob(x)
        # reduce whichever side carries extra (event) dims so the
        # change of variables subtracts like from like
        if ldj.ndim > base_lp.ndim:
            ldj = _sum(ldj, range(base_lp.ndim, ldj.ndim))
        elif base_lp.ndim > ldj.ndim:
            base_lp = _sum(base_lp, range(ldj.ndim, base_lp.ndim))
        return base_lp - ldj


class Independent(Distribution):
    """ref: independent.py:18 — reinterpret batch dims as event dims,
    summing log_prob over them."""

    def __init__(self, base: Distribution,
                 reinterpreted_batch_rank: int):
        self.base = base
        self.rank = reinterpreted_batch_rank
        bs = tuple(getattr(base, "batch_shape", ()))
        es = tuple(getattr(base, "event_shape", ()))
        if not 0 <= self.rank <= len(bs):
            raise ValueError(
                f"reinterpreted_batch_rank {self.rank} out of range "
                f"for batch_shape {bs}")
        super().__init__(bs[:len(bs) - self.rank],
                         bs[len(bs) - self.rank:] + es)

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance

    def sample(self, shape: Sequence[int] = ()):
        return self.base.sample(shape)

    def log_prob(self, value):
        lp = self.base.log_prob(value)
        return _sum(lp, range(lp.ndim - self.rank, lp.ndim))

    def entropy(self):
        ent = self.base.entropy()
        return _sum(ent, range(ent.ndim - self.rank, ent.ndim))
