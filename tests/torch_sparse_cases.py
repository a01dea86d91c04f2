"""The port's ``sparse`` and ``sparse.nn.functional`` against the JAX
package's on the same inputs, gradients included.

float32 results within ``1e-6 + 1e-5 |jax|``; indices, patterns and
counts exactly. A JAX BCOO keeps its indices as ``[nnz, ndim]`` and the
port's COO as ``[ndim, nnz]``; both surfaces return ``indices()`` as
``[ndim, nnz]``. Gradients of SpMM, SDDMM, the sparse softmax and the
pattern attention with respect to the stored values and the dense
operands are held to ``jax.grad``'s.

The cases of ``tests/test_torch_sparse.py`` and
``tests/test_torch_sparse_p2.py``: each of those files installs one part
of ``TESTS`` (``tests/torch_parts.py``: at most 26 tests a file)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parts import split

torch = pytest.importorskip("torch")

import paddle_tpu_torch as T  # noqa: E402
from paddle_tpu_torch.core import device as tdev  # noqa: E402

import paddle_tpu as J  # noqa: E402
from torch_tensor_cases import _np, _rs, check, u  # noqa: E402

F32 = np.float32


@pytest.fixture(autouse=True)
def _on_cpu():
    T.set_device("cpu")
    yield
    tdev.set_current(None)


def coo(rs, shape=(5, 6), nnz=9, dup=True):
    """Random coordinates of ``shape`` (with a duplicate and row 4 left
    empty when ``dup``), values in [-1, 1)."""
    rows = rs.randint(0, shape[0] - (1 if dup else 0), nnz)
    cols = rs.randint(0, shape[1], nnz)
    if dup:
        rows[-1], cols[-1] = rows[0], cols[0]
    return np.stack([rows, cols]).astype(np.int64), u(rs, nnz)


def both(name, fn, *extra):
    """fn(module, indices, values, *dense) in both packages."""
    rs = _rs(name)
    idx, vals = coo(rs)
    dense = [a(rs) for a in extra]
    want = fn(J, J.to_tensor(idx), J.to_tensor(vals),
              *[J.to_tensor(d) for d in dense])
    got = fn(T, T.to_tensor(idx), T.to_tensor(vals),
             *[T.to_tensor(d) for d in dense])
    return got, want


def sp(m, idx, vals, shape=(5, 6)):
    return m.sparse.sparse_coo_tensor(idx, vals, shape)


def dense_of(x):
    return x.to_dense() if hasattr(x, "to_dense") else x


_UNARY = ["relu", "tanh", "sin", "sqrt", "square", "abs", "neg", "expm1",
          "log1p", "cos", "atan", "sinh", "tan", "relu6", "leaky_relu",
          "asinh", "deg2rad", "rad2deg"]
_UNIT = ["asin", "atanh", "acos"]

CASES = (
    [(f, lambda m, i, v, f=f: dense_of(getattr(m.sparse, f)(
        sp(m, i, m.abs(v) if f in ("sqrt", "log1p") else v))))
     for f in _UNARY]
    + [(f, lambda m, i, v, f=f: dense_of(getattr(m.sparse, f)(
        sp(m, i, v * 0.9)))) for f in _UNIT]
    + [
        ("acosh", lambda m, i, v: dense_of(m.sparse.acosh(
            sp(m, i, m.abs(v) + 1.5)))),
        ("pow", lambda m, i, v: dense_of(m.sparse.pow(sp(m, i, v), 3))),
        ("cast", lambda m, i, v: dense_of(m.sparse.cast(
            sp(m, i, v * 9), "int32"))),
        ("scale", lambda m, i, v: [
            dense_of(m.sparse.scale(sp(m, i, v), 2.0, 0.5)),
            dense_of(m.sparse.scale(sp(m, i, v), 2.0, 0.5, False))]),
        ("full_like", lambda m, i, v: dense_of(
            m.sparse.full_like(sp(m, i, v), 3.0))),
        ("accessors", lambda m, i, v: [
            sp(m, i, v).indices(), sp(m, i, v).values(),
            list(sp(m, i, v).shape), sp(m, i, v).nnz(),
            m.sparse.values(sp(m, i, v)), m.sparse.to_dense(sp(m, i, v)),
            m.sparse.coo_to_dense(sp(m, i, v))]),
        ("coalesce_orders_and_sums", lambda m, i, v: [
            m.sparse.coalesce(sp(m, i, v)).indices(),
            m.sparse.coalesce(sp(m, i, v)).values()]),
        ("transpose", lambda m, i, v: dense_of(
            m.sparse.transpose(sp(m, i, v), [1, 0]))),
        ("add_sparse", lambda m, i, v: [
            (sp(m, i, v) + sp(m, i, v * 2)).indices(),
            (sp(m, i, v) + sp(m, i, v * 2)).values(),
            dense_of(m.sparse.add(sp(m, i, v), sp(m, i, -v)))]),
        ("subtract", lambda m, i, v, d: [
            dense_of(m.sparse.subtract(sp(m, i, v), sp(m, i, v * 3))),
            dense_of(m.sparse.subtract(sp(m, i, v), d))]),
        ("multiply_dense_and_scalar", lambda m, i, v, d: [
            dense_of(m.sparse.multiply(sp(m, i, v), d)),
            dense_of(m.sparse.multiply(sp(m, i, v), 2.5))]),
        ("multiply_sparse", lambda m, i, v: dense_of(m.sparse.multiply(
            sp(m, i, v), sp(m, m.flip(i, [1]), v + 2.0)))),
        ("divide", lambda m, i, v, d: [
            dense_of(m.sparse.divide(sp(m, i, v), d + 2.0)),
            dense_of(m.sparse.divide_scalar(sp(m, i, v), 4.0))]),
        ("matmul_spmm", lambda m, i, v, d: m.sparse.matmul(sp(m, i, v), d)),
        ("matmul_dense_dense", lambda m, i, v, d: m.sparse.matmul(
            dense_of(sp(m, i, v)), d)),
        ("mv", lambda m, i, v, d: m.sparse.mv(sp(m, i, v), d[:, 0])),
        ("addmm", lambda m, i, v, d: m.sparse.addmm(
            d[:5, :3] * 0 + 1.0, sp(m, i, v), d[:, :3], 0.5, 2.0)),
        ("masked_matmul_sddmm", lambda m, i, v, d: dense_of(
            m.sparse.masked_matmul(d[:5, :4], m.t(d[:6, :4]),
                                   sp(m, i, v)))),
        ("softmax_rows_empty_and_dup", lambda m, i, v: dense_of(
            m.sparse.softmax(sp(m, i, v)))),
        ("segment_softmax_out_of_range", lambda m, i, v: m.sparse.
         segment_softmax(v, m.where(i[0] > 2, i[0] * 0 + 5, i[0]), 5)),
        ("is_sparse_coo", lambda m, i, v: [
            m.sparse.is_sparse_coo(sp(m, i, v)),
            m.sparse.is_sparse_coo(v)]),
    ]
)

_DENSE = {"subtract": lambda rs: u(rs, 5, 6),
          "multiply_dense_and_scalar": lambda rs: u(rs, 5, 6),
          "divide": lambda rs: u(rs, 5, 6),
          "matmul_spmm": lambda rs: u(rs, 6, 4),
          "matmul_dense_dense": lambda rs: u(rs, 6, 4),
          "mv": lambda rs: u(rs, 6, 4), "addmm": lambda rs: u(rs, 6, 4),
          "masked_matmul_sddmm": lambda rs: u(rs, 6, 6)}


def test_sparse(name, fn):
    extra = [_DENSE[name]] if name in _DENSE else []
    got, want = both(name, fn, *extra)
    check(got, want)


def test_from_dense_and_conversions():
    rs = _rs("from_dense")
    x = u(rs, 4, 5) * (rs.rand(4, 5) > 0.6)
    jt, tt = J.sparse.to_sparse_coo(J.to_tensor(x)), \
        T.sparse.to_sparse_coo(T.to_tensor(x))
    check([tt.indices(), tt.values(), tt.to_dense()],
          [jt.indices(), jt.values(), jt.to_dense()])
    check(list(T.sparse.to_sparse_csr(T.to_tensor(x))),
          list(J.sparse.to_sparse_csr(J.to_tensor(x))))
    check(list(T.sparse.to_sparse_csr(tt)), list(J.sparse.to_sparse_csr(jt)))
    crows, cols, vals = J.sparse.to_sparse_csr(J.to_tensor(x))
    jc = J.sparse.sparse_csr_tensor(crows, cols, vals, x.shape)
    tc = T.sparse.sparse_csr_tensor(T.to_tensor(np.asarray(crows)),
                                    T.to_tensor(np.asarray(cols)),
                                    T.to_tensor(np.asarray(vals)), x.shape)
    check([tc.indices(), tc.values(), tc.to_dense()],
          [jc.indices(), jc.values(), jc.to_dense()])
    tn = T.sparse.SparseCooTensor.from_dense(T.to_tensor(x), nse=12)
    jn = J.sparse.SparseCooTensor.from_dense(J.to_tensor(x), nse=12)
    assert tn.nnz() == jn.nnz() == 12
    check(tn.to_dense(), jn.to_dense())
    check(tt.coo.to_dense(), jt.to_dense())
    with pytest.raises(NotImplementedError):
        T.sparse.to_sparse_coo(T.to_tensor(x), sparse_dim=1)


# ---------------------------------------------------------------------------
# gradients against jax.grad
# ---------------------------------------------------------------------------

def _grads(name, jfn, tfn, dense_shapes):
    """d/d(values, dense...) of sum(out * w) in both packages."""
    rs = _rs(name)
    idx, vals = coo(rs)
    dense = [u(rs, *s) for s in dense_shapes]

    def jloss(v, *ds):
        out = jfn(jnp.asarray(idx), v, *ds)
        return jnp.sum(out * wj)
    probe = jfn(jnp.asarray(idx), jnp.asarray(vals),
                *[jnp.asarray(d) for d in dense])
    w = u(rs, *probe.shape)
    wj = jnp.asarray(w)
    want = jax.grad(jloss, argnums=tuple(range(1 + len(dense))))(
        jnp.asarray(vals), *[jnp.asarray(d) for d in dense])
    tv = torch.tensor(vals, requires_grad=True)
    td = [torch.tensor(d, requires_grad=True) for d in dense]
    (tfn(torch.as_tensor(idx), tv, *td) * torch.as_tensor(w)).sum().backward()
    # torch leaves a gradient that does not flow (the mask's values under
    # SDDMM) as None, where jax.grad gives zeros
    got = [t.grad if t.grad is not None else torch.zeros_like(t)
           for t in [tv] + td]
    check(got, list(want))


def _jsp(i, v):
    return J.sparse.sparse_coo_tensor(i, v, (5, 6))


def _tsp(i, v):
    return T.sparse.sparse_coo_tensor(i, v, (5, 6))


GRADS = [
    ("spmm", lambda i, v, d: J.sparse.matmul(_jsp(i, v), d),
     lambda i, v, d: T.sparse.matmul(_tsp(i, v), d), [(6, 4)]),
    ("spmv", lambda i, v, d: J.sparse.mv(_jsp(i, v), d),
     lambda i, v, d: T.sparse.mv(_tsp(i, v), d), [(6,)]),
    ("sddmm", lambda i, v, a, b: J.sparse.masked_matmul(
        a, b, _jsp(i, v)).values(),
     lambda i, v, a, b: T.sparse.masked_matmul(a, b, _tsp(i, v)).values(),
     [(5, 3), (3, 6)]),
    ("softmax", lambda i, v: J.sparse.softmax(_jsp(i, v)).to_dense(),
     lambda i, v: T.sparse.softmax(_tsp(i, v)).to_dense(), []),
    ("coalesce_to_dense", lambda i, v: J.sparse.coalesce(
        _jsp(i, v)).to_dense(),
     lambda i, v: T.sparse.coalesce(_tsp(i, v)).to_dense(), []),
]


def test_gradients_match_jax_grad(name, jfn, tfn, shapes):
    _grads(name, jfn, tfn, shapes)


def _attention_inputs(seed):
    rs = np.random.RandomState(seed)
    b, h, s, d = 2, 2, 6, 4
    qkv = [u(rs, b, h, s, d) for _ in range(3)]
    rows, cols = np.nonzero(np.abs(np.subtract.outer(np.arange(s),
                                                     np.arange(s))) <= 1)
    keep = rows != 5                                  # row 5 admits nothing
    idx = np.stack([rows[keep], cols[keep]]).astype(np.int64)
    return qkv, idx, np.ones(idx.shape[1], F32)


def test_pattern_attention_and_its_gradients():
    qkv, idx, ones = _attention_inputs(0)
    jmask = J.sparse.sparse_coo_tensor(idx, ones, (6, 6))
    tmask = T.sparse.sparse_coo_tensor(T.to_tensor(idx), T.to_tensor(ones),
                                       (6, 6))
    w = np.random.RandomState(1).uniform(-1, 1, (2, 2, 6, 4)).astype(F32)

    def jloss(q, k, v):
        return jnp.sum(J.sparse.nn.functional.attention(q, k, v, jmask) * w)
    want_out = J.sparse.nn.functional.attention(*[jnp.asarray(a)
                                                  for a in qkv], jmask)
    want_grads = jax.grad(jloss, argnums=(0, 1, 2))(*[jnp.asarray(a)
                                                      for a in qkv])
    tq = [torch.tensor(a, requires_grad=True) for a in qkv]
    out = T.sparse.nn.functional.attention(*tq, tmask, scaling=None)
    (out * torch.as_tensor(w)).sum().backward()
    check([out, *[t.grad for t in tq]], [want_out, *want_grads])
    assert float(_np(out)[:, :, 5].__abs__().max()) == 0.0


TESTS = [
    ("test_sparse", test_sparse, [c for c in CASES], [c[0] for c in CASES]),
    ("test_from_dense_and_conversions", test_from_dense_and_conversions,
     None, None),
    ("test_gradients_match_jax_grad", test_gradients_match_jax_grad, GRADS,
     [g[0] for g in GRADS]),
    ("test_pattern_attention_and_its_gradients",
     test_pattern_attention_and_its_gradients, None, None),
]
PARTS = split(TESTS, 2)
