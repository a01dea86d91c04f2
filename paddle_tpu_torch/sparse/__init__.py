"""paddle_tpu_torch.sparse — sparse COO tensors (the port's counterpart
of ``paddle_tpu/sparse/__init__.py``).

:class:`SparseCooTensor` keeps the JAX package's surface (``indices()``
``[ndim, nnz]``, ``values()``, ``shape``, ``nnz()``, ``to_dense()``),
backed by a torch COO tensor (``.coo``) built from its index and value
tensors; the values may carry gradients. Like a JAX BCOO it may hold
duplicate coordinates until :func:`coalesce`, which orders them row-major
and sums the duplicates, as ``sum_duplicates`` does. CSR inputs are
converted to COO.

SpMM (``matmul`` / ``mv`` / ``addmm``) runs ``torch.sparse.mm``
(cuSPARSE on the card) in a ``torch.autograd.Function`` whose backward
gives the dense operand ``A^T G`` and each stored value
``<G[row], B[col]>``, the gradients ``jax.grad`` gives through a BCOO
product. SDDMM (``masked_matmul``), the sparse softmax and the
value-wise unary set work on the value vector, pattern unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch


class SparseCooTensor:
    """ref: paddle.incubate.sparse.sparse_coo_tensor."""

    def __init__(self, indices, values, shape):
        self._idx = indices.to(torch.int64)      # [ndim, nnz]
        self._vals = values                      # [nnz]
        self._shape = tuple(int(s) for s in shape)

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_dense(cls, x, nse: Optional[int] = None):
        idx = torch.nonzero(x).T
        if nse is not None and nse > idx.shape[1]:
            pad = torch.zeros((x.ndim, nse - idx.shape[1]),
                              dtype=idx.dtype, device=x.device)
            vals = torch.cat([x[tuple(idx)], torch.zeros(
                nse - idx.shape[1], dtype=x.dtype, device=x.device)])
            return cls(torch.cat([idx, pad], dim=1), vals, x.shape)
        return cls(idx, x[tuple(idx)], x.shape)

    @property
    def coo(self) -> torch.Tensor:
        """The torch COO tensor of the same entries (not coalesced)."""
        return torch.sparse_coo_tensor(self._idx, self._vals, self._shape,
                                       check_invariants=True)

    # -- paddle-style accessors -----------------------------------------
    def indices(self):
        return self._idx  # [ndim, nnz] (paddle layout)

    def values(self):
        return self._vals

    @property
    def shape(self):
        return self._shape

    def nnz(self):
        return self._vals.shape[0]

    def to_dense(self):
        """Duplicates summed, as ``BCOO.todense``; differentiable in the
        values."""
        out = torch.zeros(self._shape, dtype=self._vals.dtype,
                          device=self._vals.device)
        return out.index_put(tuple(self._idx), self._vals, accumulate=True)

    # -- math ------------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, SparseCooTensor):
            # O(nnz): concatenate coordinate lists, merge duplicates
            return coalesce(SparseCooTensor(
                torch.cat([self._idx, other._idx], dim=1),
                torch.cat([self._vals, other._vals]), self._shape))
        return self.to_dense() + other

    def matmul(self, dense):
        return _SpMM.apply(self._idx, self._vals, dense, self._shape)

    __matmul__ = matmul


class _SpMM(torch.autograd.Function):
    """``A @ B`` for a 2-D COO ``A`` (indices, values) and a dense ``B``
    of 1 or 2 dims."""

    @staticmethod
    def forward(ctx, idx, vals, dense, shape):
        vec = dense.ndim == 1
        b = dense[:, None] if vec else dense
        # indices come from the caller: checked in bounds before cuSPARSE
        a = torch.sparse_coo_tensor(idx, vals, shape, check_invariants=True)
        out = torch.sparse.mm(a, b.to(vals.dtype))
        ctx.save_for_backward(idx, vals, b)
        ctx.vec, ctx.shape = vec, shape
        return out[:, 0] if vec else out

    @staticmethod
    def backward(ctx, g):
        idx, vals, b = ctx.saved_tensors
        g = g[:, None] if ctx.vec else g
        d_vals = d_b = None
        if ctx.needs_input_grad[1]:
            d_vals = (g[idx[0]] * b[idx[1]]).sum(-1)
        if ctx.needs_input_grad[2]:
            at = torch.sparse_coo_tensor(idx.flip(0), vals,
                                         ctx.shape[::-1],
                                         check_invariants=False)
            d_b = torch.sparse.mm(at, g)
            d_b = d_b[:, 0] if ctx.vec else d_b
        return None, d_vals, d_b, None


def sparse_coo_tensor(indices, values, shape):
    """ref: paddle.incubate.sparse.sparse_coo_tensor(indices [ndim, nnz],
    values [nnz], shape)."""
    return SparseCooTensor(torch.as_tensor(indices),
                           torch.as_tensor(values), shape)


def sparse_csr_tensor(crows, cols, values, shape):
    """ref: paddle.incubate.sparse.sparse_csr_tensor — converted to COO."""
    crows = torch.as_tensor(crows).to(torch.int64)
    cols = torch.as_tensor(cols).to(torch.int64)
    counts = crows[1:] - crows[:-1]
    rows = torch.repeat_interleave(
        torch.arange(len(crows) - 1, device=crows.device), counts,
        output_size=values.shape[0])
    return sparse_coo_tensor(torch.stack([rows, cols]), values, shape)


def matmul(sp, dense):
    """Sparse @ dense (ref: incubate/sparse matmul)."""
    if isinstance(sp, SparseCooTensor):
        return sp.matmul(dense)
    return sp @ dense


def masked_matmul(a, b, mask: "SparseCooTensor"):
    """SDDMM: (a @ b) sampled at mask's sparsity pattern
    (ref: incubate/sparse masked_matmul; phi sparse sddmm kernels)."""
    rows, cols = mask._idx[0], mask._idx[1]
    vals = (a[rows, :] * b[:, cols].T).sum(-1)
    return SparseCooTensor(mask._idx, vals, (a.shape[0], b.shape[1]))


# ---------------------------------------------------------------------------
# value-wise math (ref: python/paddle/incubate/sparse/unary.py — the op
# applies to the values, pattern unchanged)
# ---------------------------------------------------------------------------

def _unary(fn, sp: SparseCooTensor) -> SparseCooTensor:
    return SparseCooTensor(sp._idx, fn(sp._vals), sp._shape)


def relu(sp):
    return _unary(torch.relu, sp)


def tanh(sp):
    return _unary(torch.tanh, sp)


def sin(sp):
    return _unary(torch.sin, sp)


def asin(sp):
    return _unary(torch.asin, sp)


def sqrt(sp):
    return _unary(torch.sqrt, sp)


def square(sp):
    return _unary(torch.square, sp)


def abs(sp):  # noqa: A001 — reference name
    return _unary(torch.abs, sp)


def neg(sp):
    return _unary(torch.neg, sp)


def expm1(sp):
    return _unary(torch.expm1, sp)


def log1p(sp):
    return _unary(torch.log1p, sp)


def pow(sp, factor):  # noqa: A001 — reference name
    return _unary(lambda v: torch.pow(v, factor), sp)


def cast(sp, dtype):
    from ..core import dtype as dtype_mod
    return _unary(lambda v: v.to(dtype_mod.dtype(dtype)), sp)


def scale(sp, scale_, bias: float = 0.0, bias_after_scale: bool = True):
    if bias_after_scale:
        return _unary(lambda v: v * scale_ + bias, sp)
    return _unary(lambda v: (v + bias) * scale_, sp)


def transpose(sp: SparseCooTensor, perm) -> SparseCooTensor:
    """ref: incubate/sparse transpose — permute coordinate rows."""
    perm = list(perm)
    return SparseCooTensor(sp._idx[perm], sp._vals,
                           tuple(sp._shape[p] for p in perm))


def _linear(idx, shape):
    lin = torch.zeros_like(idx[0])
    for d, n in enumerate(shape):
        lin = lin * n + idx[d]
    return lin


def _unravel(lin, shape):
    out = []
    for n in reversed(shape):
        out.append(lin % n)
        lin = lin // n
    return torch.stack(out[::-1])


def coalesce(sp: SparseCooTensor) -> SparseCooTensor:
    """Merge duplicate coordinates (ref: sparse_coo_tensor coalesce):
    row-major order, duplicates summed, differentiable in the values."""
    uniq, inv = torch.unique(_linear(sp._idx, sp._shape), sorted=True,
                             return_inverse=True)
    vals = torch.zeros(uniq.shape[0], dtype=sp._vals.dtype,
                       device=sp._vals.device).index_add(0, inv, sp._vals)
    return SparseCooTensor(_unravel(uniq, sp._shape), vals, sp._shape)


def mv(sp: SparseCooTensor, vec):
    """Sparse matrix @ dense vector (ref: incubate/sparse mv)."""
    return sp.matmul(vec)


def is_sparse_coo(x) -> bool:
    return isinstance(x, SparseCooTensor)


def add(a, b):
    """Sparse + sparse / sparse + dense (ref: incubate/sparse add)."""
    if isinstance(a, SparseCooTensor):
        return a + b
    return b + a


# ---------------------------------------------------------------------------
# sparse-yaml surface fills (ref: phi/api/yaml/sparse_api.yaml)
# ---------------------------------------------------------------------------

def cos(sp):
    return _unary(torch.cos, sp)


def acos(sp):
    return _unary(torch.acos, sp)


def acosh(sp):
    return _unary(torch.acosh, sp)


def asinh(sp):
    return _unary(torch.asinh, sp)


def atan(sp):
    return _unary(torch.atan, sp)


def atanh(sp):
    return _unary(torch.atanh, sp)


def sinh(sp):
    return _unary(torch.sinh, sp)


def tan(sp):
    return _unary(torch.tan, sp)


def relu6(sp):
    return _unary(lambda v: torch.clamp(v, 0, 6), sp)


def leaky_relu(sp, negative_slope: float = 0.01):
    return _unary(lambda v: torch.where(v >= 0, v, negative_slope * v), sp)


def subtract(a: SparseCooTensor, b):
    """sparse - sparse/dense (ref: sparse_api.yaml subtract)."""
    if isinstance(b, SparseCooTensor):
        return a + _unary(torch.neg, b)
    return a.to_dense() - b


def multiply(a: SparseCooTensor, b):
    """Elementwise product; the sparse pattern is kept (zero * x = 0), so
    a dense operand is gathered at the stored coordinates and two sparse
    operands multiply on the intersection of their patterns."""
    if isinstance(b, SparseCooTensor):
        a, b = coalesce(a), coalesce(b)
        la, lb = _linear(a._idx, a._shape), _linear(b._idx, b._shape)
        pos = torch.searchsorted(lb, la).clamp(max=max(lb.numel() - 1, 0))
        hit = (lb[pos] == la) if lb.numel() else torch.zeros_like(
            la, dtype=torch.bool)
        return SparseCooTensor(a._idx[:, hit],
                               a._vals[hit] * b._vals[pos[hit]], a._shape)
    b = torch.as_tensor(b, device=a._vals.device)
    if b.ndim == 0:
        return _unary(lambda v: v * b, a)
    return SparseCooTensor(a._idx, a._vals * b[tuple(a._idx)], a._shape)


def divide(a: SparseCooTensor, b):
    """ref: sparse_api.yaml divide / divide_scalar."""
    b = b.to_dense() if isinstance(b, SparseCooTensor) else \
        torch.as_tensor(b, device=a._vals.device)
    if b.ndim == 0:
        return _unary(lambda v: v / b, a)
    return SparseCooTensor(a._idx, a._vals / b[tuple(a._idx)], a._shape)


divide_scalar = divide


def softmax(sp: SparseCooTensor, axis: int = -1) -> SparseCooTensor:
    """Softmax over the stored entries of each row (ref: sparse_api.yaml
    softmax — the sparse-attention normalizer: absent entries are -inf,
    not 0). 2-D, last axis; duplicates are merged first."""
    if axis not in (-1, len(sp.shape) - 1):
        raise NotImplementedError("sparse softmax: last axis only")
    if len(sp.shape) != 2:
        raise NotImplementedError(
            "sparse softmax: 2-D only (batched rows would need segment "
            "ids built from all leading index columns)")
    b = coalesce(sp)
    vals = segment_softmax(b._vals, b._idx[0], b._shape[0])
    return SparseCooTensor(b._idx, vals, b._shape)


def segment_softmax(vals, rows, n_rows):
    """Softmax over the value groups sharing a row id — the shared core
    of sparse ``softmax`` and ``nn.functional.attention``. Slots whose
    row is out of range (``rows >= n_rows``) come out zero; the mask is
    applied before the exp, so no such slot poisons the backward."""
    rows = rows.to(torch.int64)
    valid = rows < n_rows
    safe = torch.clamp(rows, 0, max(n_rows - 1, 0))
    lead = vals.shape[:-1]
    idx = safe.expand(lead + safe.shape)
    row_max = torch.full(lead + (n_rows,), -torch.inf, dtype=vals.dtype,
                         device=vals.device).scatter_reduce(
        -1, idx, torch.where(valid, vals, torch.full_like(vals, -torch.inf)),
        "amax", include_self=True)
    gm = torch.gather(row_max, -1, idx)
    shifted = torch.where(valid & torch.isfinite(gm), vals - gm,
                          torch.zeros_like(vals))
    e = torch.exp(shifted) * valid
    den = torch.zeros(lead + (n_rows,), dtype=vals.dtype,
                      device=vals.device).scatter_add(-1, idx, e)
    dg = torch.gather(den, -1, idx)
    return torch.where(valid & (dg > 0), e / torch.clamp(dg, min=1e-37),
                       torch.zeros_like(e))


def addmm(input, x: SparseCooTensor, y, beta: float = 1.0,
          alpha: float = 1.0):
    """beta*input + alpha*(x @ y) (ref: sparse_api.yaml addmm)."""
    return beta * input + alpha * x.matmul(y)


def full_like(sp: SparseCooTensor, fill_value) -> SparseCooTensor:
    return _unary(lambda v: torch.full_like(v, fill_value), sp)


def values(sp: SparseCooTensor):
    return sp.values()


def to_dense(sp: SparseCooTensor):
    return sp.to_dense()


coo_to_dense = to_dense


def to_sparse_coo(x, sparse_dim=None):
    if sparse_dim is not None and sparse_dim != x.ndim:
        raise NotImplementedError(
            "hybrid COO (sparse_dim < ndim: dense inner values) is not "
            "supported; use sparse_dim=None for fully-sparse")
    return SparseCooTensor.from_dense(x)


dense_to_coo = to_sparse_coo
create_sparse_coo_tensor = sparse_coo_tensor


def to_sparse_csr(x):
    """CSR interchange form: a ``(crows, cols, values)`` tuple of 2-D
    ``x``'s nonzeros, row-major."""
    xs = x.to_dense() if isinstance(x, SparseCooTensor) else x
    if xs.ndim != 2:
        raise ValueError("to_sparse_csr expects a 2-D tensor")
    rows, cols = torch.nonzero(xs, as_tuple=True)
    crows = torch.zeros(xs.shape[0] + 1, dtype=torch.int64,
                        device=xs.device)
    crows[1:] = torch.cumsum(torch.bincount(rows, minlength=xs.shape[0]), 0)
    return crows, cols, xs[rows, cols]


def deg2rad(x, name=None):
    """Elementwise on sparse values (ref: incubate/sparse unary rule:
    value-only ops preserve the sparsity pattern)."""
    return _unary(torch.deg2rad, x)


def rad2deg(x, name=None):
    return _unary(torch.rad2deg, x)


# imported last: nn.functional pulls SparseCooTensor from this module
from . import nn  # noqa: E402,F401
