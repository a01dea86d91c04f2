"""The port's flat tensor API (``paddle_tpu_torch.tensor``) against the
JAX package's (``paddle_tpu.tensor``) on the same inputs.

Inputs are made with numpy from a seed per case; the port runs on the
CPU (``set_device("cpu")``). float32 results are held to
``1e-6 + 1e-5 |jax|``; integer, index, bool, sort and mask results are
exactly equal (the port's indices are int64 where the JAX package's,
with x64 off, are int32: values are compared). Random draws take the
same keys in the same order: closed forms are bit-equal, and so are the
Poisson draws (an integer result of a rejection loop).

The cases of ``tests/test_torch_tensor.py`` and
``tests/test_torch_tensor_p2.py`` .. ``_p12.py``: each of those files
installs one part of ``TESTS`` (``tests/torch_parts.py``: at most 26
tests a file)."""

import zlib

import numpy as np
import pytest
from torch_parts import split

torch = pytest.importorskip("torch")

import paddle_tpu_torch as T  # noqa: E402
from paddle_tpu_torch.core import device as tdev  # noqa: E402

import paddle_tpu as J  # noqa: E402

F32 = np.float32
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    T.set_device("cpu")
    yield
    tdev.set_current(None)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check(got, want, exact=False):
    """``got`` (port) against ``want`` (JAX): floats within the stated
    limit (or bit for bit with ``exact``), everything else equal."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            check(g, w, exact)
        return
    w, g = np.asarray(want), _np(got)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype.kind in "fc" and not exact:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(g, w)


def _rs(name):
    return np.random.RandomState(zlib.crc32(name.encode()))


def u(rs, *shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, shape).astype(F32)


def pos(rs, *shape):
    return rs.uniform(0.1, 2.0, shape).astype(F32)


def ints(rs, *shape, lo=0, hi=5):
    return rs.randint(lo, hi, shape).astype(np.int64)


def run(name, inputs, fn):
    """fn(module, *tensors) through both packages on the same inputs."""
    arrs = inputs(_rs(name))
    want = fn(J, *[J.to_tensor(a) for a in arrs])
    got = fn(T, *[T.to_tensor(a) for a in arrs])
    return got, want



# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

CREATION = [
    ("zeros", lambda rs: [], lambda m: m.zeros([2, 3])),
    ("ones", lambda rs: [], lambda m: m.ones([2, 3], "int32")),
    ("full", lambda rs: [], lambda m: m.full([2, 3], 1.5)),
    ("zeros_like", lambda rs: [u(rs, 2, 3)], lambda m, x: m.zeros_like(x)),
    ("ones_like", lambda rs: [u(rs, 2, 3)],
     lambda m, x: m.ones_like(x, "int32")),
    ("full_like", lambda rs: [u(rs, 2, 3)],
     lambda m, x: m.full_like(x, -2.0)),
    ("arange", lambda rs: [], lambda m: m.arange(2, 11, 3)),
    ("arange_float", lambda rs: [], lambda m: m.arange(0.0, 1.0, 0.25)),
    ("linspace", lambda rs: [], lambda m: m.linspace(-1, 2, 7)),
    ("logspace", lambda rs: [], lambda m: m.tensor.logspace(0, 2, 5)),
    ("eye", lambda rs: [], lambda m: m.eye(3, 4)),
    ("diag_vec", lambda rs: [u(rs, 4)], lambda m, x: m.diag(x, 1)),
    ("diag_mat", lambda rs: [u(rs, 4, 4)], lambda m, x: m.diag(x, -1)),
    ("tril", lambda rs: [u(rs, 4, 5)], lambda m, x: m.tril(x, 1)),
    ("triu", lambda rs: [u(rs, 4, 5)], lambda m, x: m.triu(x, -1)),
    ("meshgrid", lambda rs: [u(rs, 3), u(rs, 4)],
     lambda m, x, y: m.meshgrid(x, y)),
    ("assign", lambda rs: [u(rs, 3)], lambda m, x: m.assign(x)),
    ("clone", lambda rs: [u(rs, 3)], lambda m, x: m.clone(x)),
    ("empty", lambda rs: [], lambda m: m.empty([2, 2])),
    ("empty_like", lambda rs: [u(rs, 2, 3)], lambda m, x: m.empty_like(x)),
    ("tril_indices", lambda rs: [], lambda m: m.tril_indices(4, 5, 1)),
    ("triu_indices", lambda rs: [], lambda m: m.triu_indices(4, None, -1)),
    ("to_tensor_list", lambda rs: [],
     lambda m: m.to_tensor([[1.0, 2.0], [3.0, 4.0]], dtype="float32")),
    ("diagflat", lambda rs: [u(rs, 2, 2)],
     lambda m, x: m.tensor.diagflat(x, 1)),
    ("diag_embed", lambda rs: [u(rs, 2, 3)],
     lambda m, x: m.diag_embed(x, 1)),
    ("diag_embed_dims", lambda rs: [u(rs, 2, 3)],
     lambda m, x: m.diag_embed(x, -1, 0, 2)),
]


def test_creation(name, inputs, fn):
    check(*run(name, inputs, fn))


def test_creation_lands_on_the_chosen_device():
    assert T.zeros([2]).device.type == "cpu"
    assert T.randn([2]).device.type == "cpu"
    assert T.device.get_device() == "cpu"


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

_UNARY = ["exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh",
          "tanh", "asinh", "abs", "sign", "floor", "ceil", "round",
          "trunc", "square", "erf", "reciprocal", "erfinv", "neg", "frac",
          "deg2rad", "rad2deg", "stanh"]
_POSITIVE = ["log", "log2", "log10", "log1p", "sqrt", "rsqrt", "lgamma",
             "digamma", "acosh"]
_BINARY = ["add", "subtract", "multiply", "divide", "maximum", "minimum",
           "fmax", "fmin", "logaddexp", "hypot", "atan2", "pow",
           "floor_divide", "mod", "remainder", "floor_mod"]

MATH = (
    [(f, lambda rs: [u(rs, 3, 4, lo=-0.9, hi=0.9)],
      lambda m, x, f=f: getattr(m.tensor, f)(x)) for f in _UNARY]
    + [(f, lambda rs: [pos(rs, 3, 4) + 1.0],
        lambda m, x, f=f: getattr(m, f)(x)) for f in _POSITIVE]
    + [(f, lambda rs: [pos(rs, 3, 4), pos(rs, 3, 4)],
        lambda m, x, y, f=f: getattr(m.tensor, f)(x, y)) for f in _BINARY]
    + [
        ("asin", lambda rs: [u(rs, 5, lo=-0.9, hi=0.9)],
         lambda m, x: m.asin(x)),
        ("acos", lambda rs: [u(rs, 5, lo=-0.9, hi=0.9)],
         lambda m, x: m.acos(x)),
        ("atanh", lambda rs: [u(rs, 5, lo=-0.9, hi=0.9)],
         lambda m, x: m.atanh(x)),
        ("int_floor_divide", lambda rs: [ints(rs, 6, lo=-9, hi=9),
                                         ints(rs, 6, lo=1, hi=4)],
         lambda m, x, y: m.floor_divide(x, y)),
        ("int_mod", lambda rs: [ints(rs, 6, lo=-9, hi=9),
                                ints(rs, 6, lo=1, hi=4)],
         lambda m, x, y: m.mod(x, y)),
        ("gcd", lambda rs: [ints(rs, 6, lo=1, hi=40),
                            ints(rs, 6, lo=1, hi=40)],
         lambda m, x, y: m.tensor.gcd(x, y)),
        ("lcm", lambda rs: [ints(rs, 6, lo=1, hi=12),
                            ints(rs, 6, lo=1, hi=12)],
         lambda m, x, y: m.tensor.lcm(x, y)),
        ("heaviside", lambda rs: [np.array([-1, 0, 2], F32)],
         lambda m, x: m.tensor.heaviside(x, 0.5)),
        ("nan_to_num", lambda rs: [np.array([np.nan, np.inf, -np.inf, 1],
                                            F32)],
         lambda m, x: m.nan_to_num(x)),
        ("lerp", lambda rs: [u(rs, 4), u(rs, 4), pos(rs, 4)],
         lambda m, x, y, w: m.lerp(x, y, w)),
        ("clip", lambda rs: [u(rs, 8)], lambda m, x: m.clip(x, -0.3, 0.4)),
        ("scale", lambda rs: [u(rs, 4)],
         lambda m, x: m.scale(x, 2.0, 0.5, False)),
        ("sum_axes", lambda rs: [u(rs, 2, 3, 4)],
         lambda m, x: m.sum(x, axis=[0, 2], keepdim=True)),
        ("sum_all", lambda rs: [u(rs, 2, 3)], lambda m, x: m.sum(x)),
        ("sum_int", lambda rs: [ints(rs, 2, 3)],
         lambda m, x: m.sum(x, axis=1)),
        ("mean", lambda rs: [u(rs, 2, 3, 4)],
         lambda m, x: m.mean(x, axis=1)),
        ("mean_keepdim_all", lambda rs: [u(rs, 2, 3)],
         lambda m, x: m.mean(x, keepdim=True)),
        ("prod", lambda rs: [pos(rs, 2, 3, 4)],
         lambda m, x: m.prod(x, axis=[0, 2])),
        ("prod_all_keepdim", lambda rs: [pos(rs, 2, 3)],
         lambda m, x: m.prod(x, keepdim=True)),
        ("max", lambda rs: [u(rs, 3, 4)], lambda m, x: m.max(x, axis=0)),
        ("min", lambda rs: [u(rs, 3, 4)],
         lambda m, x: m.min(x, axis=-1, keepdim=True)),
        ("amax", lambda rs: [u(rs, 3, 4)], lambda m, x: m.amax(x)),
        ("amin", lambda rs: [u(rs, 3, 4)], lambda m, x: m.amin(x, 1)),
        ("std_unbiased", lambda rs: [u(rs, 3, 5)],
         lambda m, x: m.std(x, axis=1)),
        ("std_biased", lambda rs: [u(rs, 3, 5)],
         lambda m, x: m.std(x, axis=1, unbiased=False)),
        ("var_unbiased", lambda rs: [u(rs, 3, 5)],
         lambda m, x: m.var(x)),
        ("var_biased", lambda rs: [u(rs, 3, 5)],
         lambda m, x: m.var(x, axis=0, unbiased=False, keepdim=True)),
        ("median_even", lambda rs: [u(rs, 3, 6)],
         lambda m, x: m.median(x, axis=1)),
        ("median_odd_all", lambda rs: [u(rs, 5, 3)],
         lambda m, x: m.median(x)),
        ("quantile", lambda rs: [u(rs, 4, 7)],
         lambda m, x: m.quantile(x, 0.3, axis=1)),
        ("quantile_list", lambda rs: [u(rs, 9)],
         lambda m, x: m.quantile(x, m.to_tensor(np.array([0.1, 0.5, 0.9],
                                                         F32)))),
        ("cumsum", lambda rs: [u(rs, 3, 4)], lambda m, x: m.cumsum(x, 1)),
        ("cumsum_flat", lambda rs: [u(rs, 3, 4)], lambda m, x: m.cumsum(x)),
        ("cumprod", lambda rs: [pos(rs, 3, 4)],
         lambda m, x: m.cumprod(x, 0)),
        ("logsumexp", lambda rs: [u(rs, 3, 4)],
         lambda m, x: m.logsumexp(x, axis=1)),
        ("logcumsumexp", lambda rs: [u(rs, 3, 4)],
         lambda m, x: m.logcumsumexp(x, axis=1)),
        ("addmm", lambda rs: [u(rs, 2, 4), u(rs, 2, 3), u(rs, 3, 4)],
         lambda m, a, x, y: m.addmm(a, x, y, 0.5, 2.0)),
        ("matmul_t", lambda rs: [u(rs, 2, 3, 4), u(rs, 2, 5, 4)],
         lambda m, x, y: m.matmul(x, y, transpose_y=True)),
        ("mm", lambda rs: [u(rs, 4, 3), u(rs, 4, 5)],
         lambda m, x, y: m.mm(x, y, transpose_x=True)),
        ("bmm", lambda rs: [u(rs, 2, 3, 4), u(rs, 2, 4, 2)],
         lambda m, x, y: m.bmm(x, y)),
        ("dot", lambda rs: [u(rs, 3, 4), u(rs, 3, 4)],
         lambda m, x, y: m.dot(x, y)),
        ("outer", lambda rs: [u(rs, 3), u(rs, 4)],
         lambda m, x, y: m.outer(x, y)),
        ("inner", lambda rs: [u(rs, 2, 4), u(rs, 3, 4)],
         lambda m, x, y: m.inner(x, y)),
        ("kron", lambda rs: [u(rs, 2, 2), u(rs, 2, 3)],
         lambda m, x, y: m.kron(x, y)),
        ("trace", lambda rs: [u(rs, 4, 4)],
         lambda m, x: m.trace(x, offset=1)),
        ("diff", lambda rs: [u(rs, 3, 6)], lambda m, x: m.diff(x, n=2)),
        ("einsum", lambda rs: [u(rs, 2, 3), u(rs, 3, 4)],
         lambda m, x, y: m.einsum("ij,jk->ik", x, y)),
        ("allclose", lambda rs: [u(rs, 4), u(rs, 4)],
         lambda m, x, y: m.allclose(x, x + 1e-9)),
        ("isclose", lambda rs: [u(rs, 4), u(rs, 4)],
         lambda m, x, y: m.isclose(x, y)),
        ("isnan_isinf_isfinite",
         lambda rs: [np.array([np.nan, np.inf, 1.0], F32)],
         lambda m, x: [m.isnan(x), m.isinf(x), m.isfinite(x)]),
        ("nansum", lambda rs: [np.array([[1, np.nan], [2, 3]], F32)],
         lambda m, x: m.tensor.nansum(x, axis=1)),
        ("nanmean", lambda rs: [np.array([[1, np.nan], [2, 3]], F32)],
         lambda m, x: m.tensor.nanmean(x)),
        ("nanmedian", lambda rs: [np.array([[1, np.nan, 5, 2], [2, 3, 4, 9]],
                                           F32)],
         lambda m, x: m.tensor.nanmedian(x, axis=1)),
        ("nanquantile", lambda rs: [np.array([1, np.nan, 5, 2, 7], F32)],
         lambda m, x: m.tensor.nanquantile(x, 0.25)),
        ("renorm", lambda rs: [u(rs, 3, 4)],
         lambda m, x: m.tensor.renorm(x, 2, 0, 0.5)),
        ("add_n", lambda rs: [u(rs, 3), u(rs, 3), u(rs, 3)],
         lambda m, a, b, c: m.add_n([a, b, c])),
        ("clip_by_norm", lambda rs: [u(rs, 6)],
         lambda m, x: m.clip_by_norm(x, 0.5)),
        ("logit", lambda rs: [pos(rs, 5) / 3], lambda m, x: m.logit(x)),
        ("logit_eps", lambda rs: [np.array([0.0, 0.5, 1.0], F32)],
         lambda m, x: m.logit(x, eps=1e-3)),
        ("norm_fro", lambda rs: [u(rs, 3, 4)], lambda m, x: m.norm(x)),
        ("norm_inf", lambda rs: [u(rs, 3, 4)],
         lambda m, x: m.norm(x, p=float("inf"), axis=1)),
        ("norm_p3", lambda rs: [u(rs, 3, 4)],
         lambda m, x: m.norm(x, p=3, axis=0, keepdim=True)),
        ("dist", lambda rs: [u(rs, 3, 4), u(rs, 3, 4)],
         lambda m, x, y: m.dist(x, y, 1)),
        ("mv", lambda rs: [u(rs, 3, 4), u(rs, 4)],
         lambda m, x, v: m.mv(x, v)),
        ("inverse", lambda rs: [u(rs, 3, 3) + 3 * np.eye(3, dtype=F32)],
         lambda m, x: m.inverse(x)),
        ("frobenius_norm", lambda rs: [u(rs, 3, 4)],
         lambda m, x: m.frobenius_norm(x, axis=[0, 1])),
        ("p_norm", lambda rs: [u(rs, 3, 4)],
         lambda m, x: m.p_norm(x, 1.5, axis=1)),
        ("cross_default_axis", lambda rs: [u(rs, 3, 2), u(rs, 3, 2)],
         lambda m, x, y: m.cross(x, y)),
        ("cross_axis9", lambda rs: [u(rs, 2, 3, 3), u(rs, 2, 3, 3)],
         lambda m, x, y: m.cross(x, y, axis=9)),
        ("cross_axis", lambda rs: [u(rs, 3, 3), u(rs, 3, 3)],
         lambda m, x, y: m.cross(x, y, axis=-1)),
        ("tensordot", lambda rs: [u(rs, 2, 3, 4), u(rs, 3, 4, 5)],
         lambda m, x, y: m.tensor.tensordot(x, y, axes=2)),
        ("tensordot_lists", lambda rs: [u(rs, 2, 3), u(rs, 3, 2)],
         lambda m, x, y: m.tensor.tensordot(x, y, axes=[[0], [1]])),
    ]
)


def test_math(name, inputs, fn):
    check(*run(name, inputs, fn))


# ---------------------------------------------------------------------------
# logic / compare
# ---------------------------------------------------------------------------

_COMPARE = ["equal", "not_equal", "greater_than", "greater_equal",
            "less_than", "less_equal"]
_LOGICAL = ["logical_and", "logical_or", "logical_xor"]
_BITWISE = ["bitwise_and", "bitwise_or", "bitwise_xor"]

LOGIC = (
    [(f, lambda rs: [ints(rs, 8), ints(rs, 8)],
      lambda m, x, y, f=f: getattr(m, f)(x, y)) for f in _COMPARE]
    + [(f, lambda rs: [ints(rs, 8, hi=2) > 0, ints(rs, 8, hi=2) > 0],
        lambda m, x, y, f=f: getattr(m, f)(x, y)) for f in _LOGICAL]
    + [(f, lambda rs: [ints(rs, 8, hi=16), ints(rs, 8, hi=16)],
        lambda m, x, y, f=f: getattr(m, f)(x, y)) for f in _BITWISE]
    + [
        ("logical_not", lambda rs: [ints(rs, 5, hi=2) > 0],
         lambda m, x: m.logical_not(x)),
        ("bitwise_not", lambda rs: [ints(rs, 5, hi=9)],
         lambda m, x: m.bitwise_not(x)),
        ("equal_all", lambda rs: [ints(rs, 5)],
         lambda m, x: [m.equal_all(x, x), m.equal_all(x, x + 1)]),
        ("all_any", lambda rs: [ints(rs, 3, 4, hi=2)],
         lambda m, x: [m.all(x, axis=1), m.any(x, axis=0, keepdim=True),
                       m.all(x), m.any(x)]),
        ("is_empty_rank", lambda rs: [u(rs, 2, 0)],
         lambda m, x: [m.tensor.is_empty(x), m.tensor.rank(x)]),
    ]
)


def test_logic(name, inputs, fn):
    check(*run(name, inputs, fn))


# ---------------------------------------------------------------------------
# manipulation
# ---------------------------------------------------------------------------

MANIP = [
    ("cast", lambda rs: [u(rs, 4) * 5], lambda m, x: m.cast(x, "int32")),
    ("reshape", lambda rs: [u(rs, 2, 6)],
     lambda m, x: m.reshape(x, [3, -1])),
    ("transpose", lambda rs: [u(rs, 2, 3, 4)],
     lambda m, x: m.transpose(x, [2, 0, 1])),
    ("moveaxis", lambda rs: [u(rs, 2, 3, 4)],
     lambda m, x: m.moveaxis(x, 0, -1)),
    ("swapaxes", lambda rs: [u(rs, 2, 3, 4)],
     lambda m, x: m.swapaxes(x, 0, 2)),
    ("t", lambda rs: [u(rs, 2, 3)], lambda m, x: m.t(x)),
    ("t_3d", lambda rs: [u(rs, 2, 3, 4)], lambda m, x: m.t(x)),
    ("concat", lambda rs: [u(rs, 2, 3), u(rs, 1, 3)],
     lambda m, x, y: m.concat([x, y], axis=0)),
    ("stack", lambda rs: [u(rs, 2, 3), u(rs, 2, 3)],
     lambda m, x, y: m.stack([x, y], axis=1)),
    ("unstack", lambda rs: [u(rs, 2, 3)], lambda m, x: m.unstack(x, 1)),
    ("unbind", lambda rs: [u(rs, 2, 3)], lambda m, x: m.unbind(x)),
    ("split_num", lambda rs: [u(rs, 6, 2)], lambda m, x: m.split(x, 3)),
    ("split_sections", lambda rs: [u(rs, 6, 2)],
     lambda m, x: m.split(x, [1, 2, 3])),
    ("chunk_uneven", lambda rs: [u(rs, 7, 2)], lambda m, x: m.chunk(x, 3)),
    ("squeeze", lambda rs: [u(rs, 1, 3, 1)], lambda m, x: m.squeeze(x)),
    ("squeeze_axis", lambda rs: [u(rs, 1, 3, 1)],
     lambda m, x: m.squeeze(x, axis=2)),
    ("unsqueeze", lambda rs: [u(rs, 3, 4)],
     lambda m, x: m.unsqueeze(x, [0, -1])),
    ("flatten", lambda rs: [u(rs, 2, 3, 4)],
     lambda m, x: m.flatten(x, 1, 2)),
    ("tile", lambda rs: [u(rs, 2, 3)], lambda m, x: m.tile(x, [2, 1])),
    ("expand", lambda rs: [u(rs, 1, 3)], lambda m, x: m.expand(x, [4, 3])),
    ("broadcast_to", lambda rs: [u(rs, 3)],
     lambda m, x: m.broadcast_to(x, [2, 3])),
    ("broadcast_tensors", lambda rs: [u(rs, 3), u(rs, 2, 1)],
     lambda m, x, y: m.broadcast_tensors([x, y])),
    ("broadcast_shape", lambda rs: [],
     lambda m: m.tensor.broadcast_shape([2, 1, 3], [4, 1])),
    ("expand_as", lambda rs: [u(rs, 1, 3), u(rs, 2, 3)],
     lambda m, x, y: m.expand_as(x, y)),
    ("flip", lambda rs: [u(rs, 2, 3)], lambda m, x: m.flip(x, [0, 1])),
    ("reverse", lambda rs: [u(rs, 2, 3)], lambda m, x: m.tensor.reverse(x, 1)),
    ("roll", lambda rs: [u(rs, 2, 5)], lambda m, x: m.roll(x, 2, axis=1)),
    ("roll_flat", lambda rs: [u(rs, 2, 5)], lambda m, x: m.roll(x, 3)),
    ("rot90", lambda rs: [u(rs, 2, 3)], lambda m, x: m.rot90(x, 3)),
    ("gather", lambda rs: [u(rs, 5, 3), ints(rs, 4)],
     lambda m, x, i: m.gather(x, i, axis=0)),
    ("gather_2d_index", lambda rs: [u(rs, 3, 5), ints(rs, 2, 2)],
     lambda m, x, i: m.gather(x, i, axis=1)),
    ("gather_nd", lambda rs: [u(rs, 4, 5), ints(rs, 3, 2, hi=4)],
     lambda m, x, i: m.gather_nd(x, i)),
    ("take_along_axis", lambda rs: [u(rs, 3, 5), ints(rs, 3, 2)],
     lambda m, x, i: m.take_along_axis(x, i, 1)),
    ("put_along_axis", lambda rs: [u(rs, 3, 5), ints(rs, 3, 1)],
     lambda m, x, i: m.put_along_axis(x, i, 9.0, 1)),
    ("scatter_overwrite", lambda rs: [u(rs, 5, 2),
                                      np.array([3, 1], np.int64),
                                      u(rs, 2, 2)],
     lambda m, x, i, v: m.scatter(x, i, v)),
    ("scatter_add", lambda rs: [u(rs, 5, 2), np.array([3, 1, 3], np.int64),
                                u(rs, 3, 2)],
     lambda m, x, i, v: m.scatter(x, i, v, overwrite=False)),
    ("scatter_nd_add", lambda rs: [u(rs, 4, 3), ints(rs, 5, 2, hi=3),
                                   u(rs, 5)],
     lambda m, x, i, v: m.scatter_nd_add(x, i, v)),
    ("scatter_nd", lambda rs: [ints(rs, 5, 1, hi=4), u(rs, 5, 2)],
     lambda m, i, v: m.tensor.scatter_nd(i, v, [4, 2])),
    ("index_select", lambda rs: [u(rs, 3, 5), ints(rs, 4)],
     lambda m, x, i: m.index_select(x, i, axis=1)),
    ("index_sample", lambda rs: [u(rs, 3, 5), ints(rs, 3, 2)],
     lambda m, x, i: m.index_sample(x, i)),
    ("masked_select", lambda rs: [u(rs, 3, 4)],
     lambda m, x: m.masked_select(x, x > 0)),
    ("masked_fill", lambda rs: [u(rs, 3, 4)],
     lambda m, x: m.masked_fill(x, x > 0, -1.0)),
    ("where", lambda rs: [u(rs, 3, 4), u(rs, 3, 4)],
     lambda m, x, y: m.where(x > y, x, y)),
    ("where_nonzero", lambda rs: [u(rs, 3, 4)],
     lambda m, x: m.where(x > 0)),
    ("nonzero", lambda rs: [u(rs, 3, 4)], lambda m, x: m.nonzero(x > 0)),
    ("nonzero_tuple", lambda rs: [u(rs, 3, 4)],
     lambda m, x: m.nonzero(x > 0, as_tuple=True)),
    ("unique", lambda rs: [ints(rs, 12)],
     lambda m, x: m.unique(x, return_index=True, return_counts=True)),
    ("unique_inverse", lambda rs: [ints(rs, 3, 4)],
     lambda m, x: m.unique(x, return_inverse=True)),
    ("unique_axis", lambda rs: [ints(rs, 6, 2, hi=2)],
     lambda m, x: m.unique(x, return_index=True, axis=0)),
    ("unique_consecutive", lambda rs: [np.array([1, 1, 2, 2, 2, 3, 1, 1])],
     lambda m, x: m.unique_consecutive(x, True, True)),
    ("unique_consecutive_axis",
     lambda rs: [np.array([[1, 2], [1, 2], [3, 4], [3, 4], [1, 2]])],
     lambda m, x: m.unique_consecutive(x, True, True, axis=0)),
    ("repeat_interleave", lambda rs: [u(rs, 2, 3)],
     lambda m, x: m.repeat_interleave(x, 2, axis=1)),
    ("as_complex_as_real", lambda rs: [u(rs, 3, 2)],
     lambda m, x: m.as_real(m.as_complex(x))),
    ("numel_shape", lambda rs: [u(rs, 2, 3)],
     lambda m, x: [m.numel(x), m.shape(x)]),
    ("shard_index", lambda rs: [ints(rs, 8, hi=20)],
     lambda m, x: m.shard_index(x, 20, 4, 1)),
    ("slice", lambda rs: [u(rs, 4, 5)],
     lambda m, x: m.slice(x, [0, 1], [1, -3], [3, 100])),
    ("strided_slice_negative", lambda rs: [u(rs, 6, 5)],
     lambda m, x: m.strided_slice(x, [0, 1], [5, 4], [0, 0], [-2, -1])),
    ("crop", lambda rs: [u(rs, 4, 5)],
     lambda m, x: m.tensor.crop(x, [2, -1], [1, 2])),
    ("multiplex", lambda rs: [u(rs, 3, 2), u(rs, 3, 2),
                              np.array([[1], [0], [1]], np.int64)],
     lambda m, a, b, i: m.multiplex([a, b], i)),
    ("gather_tree", lambda rs: [ints(rs, 4, 2, 3, hi=9),
                                ints(rs, 4, 2, 3, hi=3)],
     lambda m, i, p: m.gather_tree(i, p)),
    ("increment", lambda rs: [u(rs, 3)], lambda m, x: m.increment(x, 2.0)),
    ("conj_real_imag_angle",
     lambda rs: [u(rs, 3), u(rs, 3)],
     lambda m, x, y: [m.conj(m.complex(x, y)), m.real(m.complex(x, y)),
                      m.imag(m.complex(x, y)), m.angle(m.complex(x, y)),
                      m.imag(x), m.real(x)]),
]


def test_manipulation(name, inputs, fn):
    check(*run(name, inputs, fn))


# ---------------------------------------------------------------------------
# search / sort, with the tie and index conventions of the JAX package
# ---------------------------------------------------------------------------

TIES = np.array([[3, 1, 3, 2, 1, 3], [0, 0, 5, 5, 0, 1]], F32)

SEARCH = [
    ("argmax", lambda rs: [TIES], lambda m, x: m.argmax(x, axis=1)),
    ("argmax_flat_keepdim", lambda rs: [TIES],
     lambda m, x: m.argmax(x, keepdim=True)),
    ("argmin", lambda rs: [TIES], lambda m, x: m.argmin(x, axis=0)),
    ("argsort_ties", lambda rs: [TIES], lambda m, x: m.argsort(x)),
    ("argsort_descending_ties", lambda rs: [TIES],
     lambda m, x: m.argsort(x, descending=True)),
    ("argsort_axis0", lambda rs: [TIES.T.copy()],
     lambda m, x: m.argsort(x, axis=0, descending=True)),
    ("sort", lambda rs: [TIES], lambda m, x: m.sort(x, descending=True)),
    ("topk_ties", lambda rs: [TIES], lambda m, x: m.topk(x, 3)),
    ("topk_smallest_ties", lambda rs: [TIES],
     lambda m, x: m.topk(x, 3, largest=False)),
    ("topk_axis0", lambda rs: [TIES.T.copy()],
     lambda m, x: m.topk(x, 2, axis=0)),
    ("kthvalue_ties", lambda rs: [TIES], lambda m, x: m.kthvalue(x, 2)),
    ("kthvalue_keepdim", lambda rs: [u(rs, 3, 5)],
     lambda m, x: m.kthvalue(x, 2, axis=0, keepdim=True)),
    ("mode_ties", lambda rs: [TIES], lambda m, x: m.mode(x)),
    ("mode_axis0_keepdim", lambda rs: [ints(rs, 7, 3, hi=3)],
     lambda m, x: m.mode(x, axis=0, keepdim=True)),
    ("searchsorted", lambda rs: [np.arange(0, 10, 2).astype(F32),
                                 np.array([-1, 2, 3, 8, 11], F32)],
     lambda m, s, v: [m.searchsorted(s, v), m.searchsorted(s, v, True)]),
    ("bincount", lambda rs: [ints(rs, 10, hi=6), pos(rs, 10)],
     lambda m, x, w: [m.bincount(x, minlength=8), m.bincount(x, w)]),
    ("histogram_own_range", lambda rs: [u(rs, 50)],
     lambda m, x: m.histogram(x, bins=7)),
    ("histogram_range", lambda rs: [u(rs, 50)],
     lambda m, x: m.histogram(x, bins=5, min=-0.5, max=0.5)),
]


def test_search_sort(name, inputs, fn):
    check(*run(name, inputs, fn))


# ---------------------------------------------------------------------------
# segment ops
# ---------------------------------------------------------------------------

SEG_IDS = np.array([0, 0, 1, 3, 3, 3], np.int64)   # segment 2 is empty

SEGMENT = [
    (f, lambda rs: [u(rs, 6, 3), SEG_IDS],
     lambda m, d, s, f=f: getattr(m, f)(d, s))
    for f in ("segment_sum", "segment_mean", "segment_max", "segment_min")
] + [
    ("segment_sum_num", lambda rs: [u(rs, 6), SEG_IDS],
     lambda m, d, s: m.segment_sum(d, s, num_segments=6)),
    ("segment_max_int32", lambda rs: [ints(rs, 6, hi=9).astype(np.int32),
                                      SEG_IDS],
     lambda m, d, s: m.segment_max(d, s)),
]


def test_segment(name, inputs, fn):
    check(*run(name, inputs, fn))


# ---------------------------------------------------------------------------
# the *_ family: same values, input left as it was
# ---------------------------------------------------------------------------

_INPLACE = {
    "add_": lambda m, x: m.add_(x, x), "ceil_": lambda m, x: m.ceil_(x),
    "clip_": lambda m, x: m.clip_(x, -0.2, 0.2),
    "exp_": lambda m, x: m.exp_(x), "floor_": lambda m, x: m.floor_(x),
    "reshape_": lambda m, x: m.reshape_(x, [4, 3]),
    "squeeze_": lambda m, x: m.squeeze_(x[None]),
    "unsqueeze_": lambda m, x: m.unsqueeze_(x, 0),
    "tanh_": lambda m, x: m.tanh_(x),
    "sqrt_": lambda m, x: m.sqrt_(m.abs(x)),
    "round_": lambda m, x: m.round_(x * 3),
    "rsqrt_": lambda m, x: m.rsqrt_(m.abs(x) + 1),
    "scale_": lambda m, x: m.scale_(x, 2.0, 1.0),
    "scatter_": lambda m, x: m.scatter_(x, m.to_tensor(
        np.array([0, 2], np.int64)), x[:2] * 0),
    "subtract_": lambda m, x: m.subtract_(x, x * 0.5),
    "lerp_": lambda m, x: m.lerp_(x, x * 2, 0.25),
    "erfinv_": lambda m, x: m.erfinv_(x * 0.9),
    "reciprocal_": lambda m, x: m.reciprocal_(x + 2),
    "flatten_": lambda m, x: m.flatten_(x),
    "put_along_axis_": lambda m, x: m.put_along_axis_(
        x, m.to_tensor(np.zeros((3, 1), np.int64)), 5.0, 1),
}


def test_inplace_family_is_functional(name):
    a = _rs(name).uniform(-1, 1, (3, 4)).astype(F32)
    want = _INPLACE[name](J, J.to_tensor(a))
    x = T.to_tensor(a)
    got = _INPLACE[name](T, x)
    check(got, want)
    np.testing.assert_array_equal(x.numpy(), a)   # the input is unchanged


def test_tensor_namespace_reexports_linalg():
    for name in ("cholesky", "lstsq", "lu", "qr", "solve", "cov"):
        assert getattr(T.tensor, name) is getattr(T.linalg, name)


# ---------------------------------------------------------------------------
# random draws: the same keys, the same bits
# ---------------------------------------------------------------------------

RANDOM = [
    ("rand", lambda m: m.rand([64, 3])),
    ("randn", lambda m: m.randn([4096])),
    ("uniform", lambda m: m.uniform([4096], min=-2.0, max=3.0)),
    ("normal", lambda m: m.normal(1.0, 2.0, [4096])),
    ("standard_normal", lambda m: m.tensor.standard_normal([512])),
    ("randint", lambda m: m.randint(-5, 17, [4096])),
    ("randint_one_arg", lambda m: m.randint(7, shape=[100])),
    ("randint_like", lambda m: m.tensor.randint_like(m.zeros([64]), 3, 9)),
    ("randperm", lambda m: m.randperm(1000)),
    ("randperm_two_rounds", lambda m: m.randperm(70000)),
    ("bernoulli", lambda m: m.bernoulli(m.full([4096], 0.3))),
    ("multinomial_replacement", lambda m: m.multinomial(
        m.to_tensor(np.array([[0.1, 0.2, 0.3, 0.4]] * 1, F32)), 50, True)),
    ("multinomial_no_replacement", lambda m: m.multinomial(
        m.to_tensor(np.array([[0.1, 0.2, 0.3, 0.4], [0.4, 0.3, 0.2, 0.1]],
                             F32)), 3)),
    ("multinomial_one", lambda m: m.multinomial(
        m.to_tensor(np.array([[0.1, 0.2, 0.7], [0.5, 0.3, 0.2]], F32)))),
    ("exponential_", lambda m: m.tensor.exponential_(m.zeros([4096]), 2.0)),
    ("uniform_", lambda m: m.tensor.uniform_(m.zeros([4096]), -1.0, 4.0)),
    ("poisson_knuth", lambda m: m.poisson(m.full([4096], 3.0))),
    ("poisson_rejection", lambda m: m.poisson(m.full([4096], 40.0))),
    ("poisson_mixed", lambda m: m.poisson(m.to_tensor(
        np.array([0.0, 0.5, 9.9, 10.0, 250.0] * 40, F32)))),
    ("draws_in_sequence", lambda m: [m.rand([3]), m.randn([3]),
                                     m.randint(0, 9, [3]), m.rand([3])]),
]


def test_random_draws_are_bit_equal(name, fn):
    J.seed(11)
    T.seed(11)
    want = fn(J)
    got = fn(T)
    check(got, want, exact=True)


def test_random_int_dtype_rule():
    """The port returns the dtype the caller names (int64 here); JAX with
    x64 off returns int32. The values are the same."""
    J.seed(3)
    T.seed(3)
    want = J.randint(0, 100, [16], dtype="int64")
    got = T.randint(0, 100, [16], dtype="int64")
    assert got.dtype == torch.int64 and str(want.dtype) == "int32"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert T.randperm(5, dtype="int32").dtype == torch.int32


def test_creation_without_a_card_raises():
    """No set_device and no card: a creation call raises rather than
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: creation lands on it")
    tdev.set_current(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.zeros([2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.randn([2])


TESTS = [
    ("test_creation", test_creation, CREATION, [c[0] for c in CREATION]),
    ("test_creation_lands_on_the_chosen_device",
     test_creation_lands_on_the_chosen_device, None, None),
    ("test_math", test_math, MATH, [c[0] for c in MATH]),
    ("test_logic", test_logic, LOGIC, [c[0] for c in LOGIC]),
    ("test_manipulation", test_manipulation, MANIP, [c[0] for c in MANIP]),
    ("test_search_sort", test_search_sort, SEARCH, [c[0] for c in SEARCH]),
    ("test_segment", test_segment, SEGMENT, [c[0] for c in SEGMENT]),
    ("test_inplace_family_is_functional", test_inplace_family_is_functional,
     [(n,) for n in sorted(_INPLACE)], sorted(_INPLACE)),
    ("test_tensor_namespace_reexports_linalg",
     test_tensor_namespace_reexports_linalg, None, None),
    ("test_random_draws_are_bit_equal", test_random_draws_are_bit_equal,
     RANDOM, [c[0] for c in RANDOM]),
    ("test_random_int_dtype_rule", test_random_int_dtype_rule, None, None),
    ("test_creation_without_a_card_raises",
     test_creation_without_a_card_raises, None, None),
]
PARTS = split(TESTS, 12)
