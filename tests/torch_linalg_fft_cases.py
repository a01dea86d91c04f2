"""The port's ``linalg``, ``fft`` and ``signal`` against the JAX
package's on the same inputs.

float32 results are held to ``1e-6 + 1e-5 |jax|``, index and rank
results exactly. Eigenvectors and singular vectors are unique only up to
sign (or phase) and LAPACK's and XLA's choices differ, so a factorization
is compared by its values, its reconstruction of the input and the
magnitudes of its vectors' entries, never by the raw vectors.

The cases of ``tests/test_torch_linalg_fft.py`` and
``tests/test_torch_linalg_fft_p2.py`` .. ``_p5.py``: each of those files
installs one part of ``TESTS`` (``tests/torch_parts.py``: at most 26
tests a file)."""

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


def spd(rs, n):
    a = u(rs, n, n)
    return (a @ a.T + n * np.eye(n, dtype=F32)).astype(F32)


def run(name, inputs, fn):
    arrs = inputs(_rs(name))
    want = fn(J, *[J.to_tensor(a) for a in arrs])
    got = fn(T, *[T.to_tensor(a) for a in arrs])
    return got, want



def _recon_svd(m, x, full):
    uu, s, vt = m.linalg.svd(x, full_matrices=full)
    k = s.shape[-1]
    return [s, (uu[..., :k] * s[..., None, :]) @ vt[..., :k, :],
            m.abs(uu[..., :k]), m.abs(vt[..., :k, :]),
            list(uu.shape), list(vt.shape)]


def _recon_qr(m, x, mode):
    q, r = m.linalg.qr(x, mode=mode)
    return [q @ r, m.abs(r), list(q.shape), list(r.shape)]


def _eigh(m, x):
    w, v = m.linalg.eigh(x)
    return [w, (v * w[..., None, :]) @ m.t(v), m.abs(v)]


def _eig(m, x):
    w, v = m.linalg.eig(x)
    order = m.argsort(m.real(w))
    w = m.take_along_axis(w, order, -1)
    return [m.real(w), m.imag(w), m.linalg.eigvals(x).shape[0]]


def _lu(m, x):
    lu, piv, info = m.linalg.lu(x)
    p, l, uu = m.linalg.lu_unpack(lu, piv)
    return [lu, piv, info, p, l, uu, p @ l @ uu]


def _lstsq(m, a, b):
    x, resid, rank, sv = m.linalg.lstsq(a, b)
    return [x, resid, rank, sv]


def _pca(m, x):
    uu, s, v = m.linalg.pca_lowrank(x, q=3)
    return [s, m.abs(uu), m.abs(v)]


LINALG = [
    ("cholesky", lambda rs: [spd(rs, 4)], lambda m, x: m.linalg.cholesky(x)),
    ("cholesky_upper", lambda rs: [spd(rs, 4)],
     lambda m, x: m.linalg.cholesky(x, upper=True)),
    ("cholesky_batched", lambda rs: [np.stack([spd(rs, 3), spd(rs, 3)])],
     lambda m, x: m.linalg.cholesky(x)),
    ("det", lambda rs: [spd(rs, 4)], lambda m, x: m.linalg.det(x)),
    ("slogdet", lambda rs: [u(rs, 4, 4)],
     lambda m, x: list(m.linalg.slogdet(x))),
    ("inv", lambda rs: [spd(rs, 4)], lambda m, x: m.linalg.inv(x)),
    ("pinv", lambda rs: [u(rs, 5, 3)], lambda m, x: m.linalg.pinv(x)),
    ("matrix_power", lambda rs: [u(rs, 3, 3)],
     lambda m, x: [m.linalg.matrix_power(x, 3),
                   m.linalg.matrix_power(x, 0)]),
    ("matrix_rank_full", lambda rs: [u(rs, 4, 6)],
     lambda m, x: m.linalg.matrix_rank(x)),
    ("matrix_rank_deficient", lambda rs: [u(rs, 5, 2) @ u(rs, 2, 5)],
     lambda m, x: m.linalg.matrix_rank(x)),
    ("multi_dot", lambda rs: [u(rs, 2, 3), u(rs, 3, 4), u(rs, 4, 2)],
     lambda m, a, b, c: m.linalg.multi_dot([a, b, c])),
    ("qr_reduced", lambda rs: [u(rs, 5, 3)],
     lambda m, x: _recon_qr(m, x, "reduced")),
    ("qr_complete", lambda rs: [u(rs, 5, 3)],
     lambda m, x: _recon_qr(m, x, "complete")),
    ("qr_r", lambda rs: [u(rs, 5, 3)],
     lambda m, x: m.abs(m.linalg.qr(x, mode="r"))),
    ("svd_full_matrices_default", lambda rs: [u(rs, 5, 3)],
     lambda m, x: _recon_svd(m, x, True)),
    ("svd_thin", lambda rs: [u(rs, 3, 5)],
     lambda m, x: _recon_svd(m, x, False)),
    ("svd_values_only", lambda rs: [u(rs, 4, 3)],
     lambda m, x: m.linalg.svd(x, compute_uv=False)),
    ("svdvals", lambda rs: [u(rs, 2, 4, 3)],
     lambda m, x: m.linalg.svdvals(x)),
    ("eig", lambda rs: [spd(rs, 4) + np.triu(u(rs, 4, 4), 1)],
     _eig),
    ("eigh", lambda rs: [spd(rs, 4)], _eigh),
    ("eigvalsh", lambda rs: [spd(rs, 4)], lambda m, x: m.linalg.eigvalsh(x)),
    ("solve", lambda rs: [spd(rs, 4), u(rs, 4, 2)],
     lambda m, a, b: m.linalg.solve(a, b)),
    ("solve_vector", lambda rs: [spd(rs, 4), u(rs, 4)],
     lambda m, a, b: m.linalg.solve(a, b)),
    ("lstsq_full_rank", lambda rs: [u(rs, 6, 3), u(rs, 6, 2)], _lstsq),
    ("lstsq_vector", lambda rs: [u(rs, 6, 3), u(rs, 6)], _lstsq),
    ("lstsq_rank_deficient", lambda rs: [u(rs, 6, 2) @ u(rs, 2, 4),
                                         u(rs, 6, 2)], _lstsq),
    ("cond", lambda rs: [spd(rs, 4)],
     lambda m, x: [m.linalg.cond(x), m.linalg.cond(x, "fro")]),
    ("norm_default", lambda rs: [u(rs, 3, 4)], lambda m, x: m.linalg.norm(x)),
    ("norm_ord", lambda rs: [u(rs, 3, 4)],
     lambda m, x: [m.linalg.norm(x, 1), m.linalg.norm(x, "fro"),
                   m.linalg.norm(x, 2, axis=1),
                   m.linalg.norm(x, float("inf"), axis=0, keepdims=True)]),
    ("cov", lambda rs: [u(rs, 3, 8)],
     lambda m, x: [m.linalg.cov(x), m.linalg.cov(x, rowvar=False),
                   m.linalg.cov(x, bias=True), m.linalg.cov(x, ddof=2)]),
    ("cov_1d_and_y", lambda rs: [u(rs, 8), u(rs, 8)],
     lambda m, x, y: [m.linalg.cov(x), m.linalg.cov(x, y)]),
    ("corrcoef", lambda rs: [u(rs, 3, 8)],
     lambda m, x: [m.linalg.corrcoef(x), m.linalg.corrcoef(x, x * 2.0)]),
    ("cholesky_solve", lambda rs: [spd(rs, 4), u(rs, 4, 2)],
     lambda m, a, b: m.linalg.cholesky_solve(b, m.linalg.cholesky(a))),
    ("cholesky_solve_upper", lambda rs: [spd(rs, 4), u(rs, 4, 2)],
     lambda m, a, b: m.linalg.cholesky_solve(
         b, m.linalg.cholesky(a, upper=True), upper=True)),
    ("triangular_solve", lambda rs: [spd(rs, 4), u(rs, 4, 3)],
     lambda m, a, b: [m.linalg.triangular_solve(m.triu(a), b),
                      m.linalg.triangular_solve(m.tril(a), b, upper=False),
                      m.linalg.triangular_solve(m.triu(a), b,
                                                transpose=True),
                      m.linalg.triangular_solve(m.triu(a), b,
                                                unitriangular=True)]),
    ("lu_lu_unpack_pivots_one_based", lambda rs: [u(rs, 4, 4)], _lu),
    ("lu_batched", lambda rs: [u(rs, 2, 3, 3)], _lu),
    ("householder_product", lambda rs: [u(rs, 4, 3), u(rs, 3)],
     lambda m, x, tau: m.linalg.householder_product(x, tau)),
    ("pca_lowrank_exact", lambda rs: [u(rs, 8, 5)], _pca),
    ("linalg_reexports", lambda rs: [u(rs, 3, 3), u(rs, 3, 3)],
     lambda m, x, y: [m.linalg.cross(x, y), m.linalg.dist(x, y),
                      m.linalg.dot(x, y), m.linalg.matmul(x, y)]),
]


def test_linalg(name, inputs, fn):
    check(*run(name, inputs, fn))


def test_lstsq_of_a_rank_deficient_matrix_is_the_svd_solution():
    """The port's lstsq goes through an SVD on every device, so a rank
    deficient system gets the minimum-norm solution (torch's CUDA gels
    assumes full rank)."""
    rs = np.random.RandomState(0)
    a = (u(rs, 6, 2) @ u(rs, 2, 4)).astype(F32)
    b = u(rs, 6, 1)
    x, resid, rank, sv = T.linalg.lstsq(T.to_tensor(a), T.to_tensor(b))
    assert int(rank) == 2
    np.testing.assert_allclose(_np(x), np.linalg.pinv(a, rcond=1e-5) @ b,
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# fft
# ---------------------------------------------------------------------------

def c64(rs, *shape):
    return (u(rs, *shape) + 1j * u(rs, *shape)).astype(np.complex64)


_NORMS = ["backward", "ortho", "forward"]

FFT = [
    (f"{f}_{norm}", lambda rs, f=f: [c64(rs, 4, 8)],
     lambda m, x, f=f, norm=norm: getattr(m.fft, f)(x, norm=norm))
    for f in ("fft", "ifft", "fft2", "ifft2", "fftn", "ifftn")
    for norm in _NORMS
] + [
    (f"{f}_{norm}", lambda rs, f=f: [u(rs, 4, 8)],
     lambda m, x, f=f, norm=norm: getattr(m.fft, f)(x, norm=norm))
    for f in ("rfft", "rfft2", "rfftn", "ihfft", "ihfft2", "ihfftn")
    for norm in _NORMS
] + [
    (f"{f}_{norm}", lambda rs, f=f: [c64(rs, 4, 5)],
     lambda m, x, f=f, norm=norm: getattr(m.fft, f)(x, norm=norm))
    for f in ("irfft", "irfft2", "irfftn", "hfft", "hfft2", "hfftn")
    for norm in _NORMS
] + [
    ("fft_n_axis", lambda rs: [c64(rs, 4, 6)],
     lambda m, x: m.fft.fft(x, n=8, axis=0)),
    ("irfft_n", lambda rs: [c64(rs, 3, 5)],
     lambda m, x: m.fft.irfft(x, n=9)),
    ("rfftn_s_axes", lambda rs: [u(rs, 3, 4, 6)],
     lambda m, x: m.fft.rfftn(x, s=[4, 8], axes=[0, 2])),
    ("hfftn_s", lambda rs: [c64(rs, 3, 4, 5)],
     lambda m, x: m.fft.hfftn(x, s=[4, 8])),
    ("ihfftn_axes", lambda rs: [u(rs, 3, 4, 6)],
     lambda m, x: m.fft.ihfftn(x, axes=[0, 1])),
    ("hfft2_s", lambda rs: [c64(rs, 4, 5)],
     lambda m, x: m.fft.hfft2(x, s=[4, 8])),
    ("freqs", lambda rs: [],
     lambda m: [m.fft.fftfreq(8, 0.5), m.fft.rfftfreq(9)]),
    ("shifts", lambda rs: [u(rs, 4, 5)],
     lambda m, x: [m.fft.fftshift(x), m.fft.ifftshift(x, axes=[1])]),
]


def test_fft(name, inputs, fn):
    check(*run(name, inputs, fn))


# ---------------------------------------------------------------------------
# signal: the JAX package's frame / stft / istft formulas
# ---------------------------------------------------------------------------

def _hann(m, n):
    return m.to_tensor((0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n))
                       .astype(F32))


SIGNAL = [
    ("frame_last", lambda rs: [u(rs, 2, 20)],
     lambda m, x: m.signal.frame(x, 6, 3)),
    ("frame_axis0", lambda rs: [u(rs, 20, 2)],
     lambda m, x: m.signal.frame(x, 6, 4, axis=0)),
    ("stft_defaults", lambda rs: [u(rs, 2, 64)],
     lambda m, x: m.signal.stft(x, 16)),
    ("stft_window_hop", lambda rs: [u(rs, 64)],
     lambda m, x: m.signal.stft(x, 16, 4, window=_hann(m, 16))),
    ("stft_short_window", lambda rs: [u(rs, 64)],
     lambda m, x: m.signal.stft(x, 16, 5, win_length=10)),
    ("stft_no_center_twosided", lambda rs: [u(rs, 2, 64)],
     lambda m, x: m.signal.stft(x, 16, center=False, onesided=False)),
    ("stft_constant_pad", lambda rs: [u(rs, 64)],
     lambda m, x: m.signal.stft(x, 16, pad_mode="constant")),
    ("istft_roundtrip", lambda rs: [u(rs, 2, 80)],
     lambda m, x: m.signal.istft(m.signal.stft(x, 16, 4,
                                               window=_hann(m, 16)),
                                 16, 4, window=_hann(m, 16))),
    ("istft_length", lambda rs: [u(rs, 80)],
     lambda m, x: m.signal.istft(m.signal.stft(x, 16), 16, length=70)),
    ("istft_twosided_nocenter", lambda rs: [u(rs, 80)],
     lambda m, x: m.signal.istft(
         m.signal.stft(x, 16, center=False, onesided=False), 16,
         center=False, onesided=False)),
]


def test_signal(name, inputs, fn):
    check(*run(name, inputs, fn))


TESTS = [
    ("test_linalg", test_linalg, LINALG, [c[0] for c in LINALG]),
    ("test_lstsq_of_a_rank_deficient_matrix_is_the_svd_solution",
     test_lstsq_of_a_rank_deficient_matrix_is_the_svd_solution, None, None),
    ("test_fft", test_fft, FFT, [c[0] for c in FFT]),
    ("test_signal", test_signal, SIGNAL, [c[0] for c in SIGNAL]),
]
PARTS = split(TESTS, 5)
