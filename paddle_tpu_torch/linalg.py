"""paddle_tpu_torch.linalg — dense linear algebra (the port's counterpart
of ``paddle_tpu/linalg.py``), on ``torch.linalg`` (cuSOLVER and cuBLAS
on the card, LAPACK on the CPU).

The signatures and defaults are ``jnp.linalg``'s, which the JAX package
re-exports: ``svd`` returns full matrices unless asked otherwise,
``cholesky`` and ``eigh`` symmetrize their input first, ``matrix_rank``
and ``pinv`` use numpy's tolerances, ``lu`` returns 1-based pivots and
an ``info`` of zeros, and ``lstsq`` returns ``(x, residuals, rank, sv)``
computed through an SVD, as ``jnp.linalg.lstsq`` does (torch's CUDA
``lstsq`` has only the full-rank ``gels`` solver). Every SVD on the card
(``svd``, ``svdvals``, ``lstsq``, ``pinv``, ``matrix_rank``, ``cond``,
``pca_lowrank``) takes cuSOLVER's QR-iteration method ``gesvd``:
torch's default there, Jacobi (``gesvdj``), stops at ~1e-3 relative
reconstruction error on a 4096 x 4096 float32 matrix (H100), where
``gesvd`` reaches ~1e-5. Eigenvectors and singular vectors are unique
only up to sign (or phase); the factors reconstruct the same matrices.
"""

from __future__ import annotations

import torch


def _sym(a):
    return (a + a.transpose(-1, -2).conj()) / 2


def _svd_method(a):
    return "gesvd" if a.is_cuda else None


def cholesky(a, *, upper: bool = False, symmetrize_input: bool = True):
    return torch.linalg.cholesky(_sym(a) if symmetrize_input else a,
                                 upper=upper)


def det(a):
    return torch.linalg.det(a)


def slogdet(a):
    return torch.linalg.slogdet(a)


def inv(a):
    return torch.linalg.inv(a)


def pinv(a, rtol=None, hermitian: bool = False):
    """``jnp.linalg.pinv``: singular values at most ``rtol * s_max`` are
    dropped (``rtol`` defaults to ``10 max(m, n) eps``)."""
    if rtol is None:
        rtol = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    if hermitian:
        return torch.linalg.pinv(a, rtol=rtol, hermitian=True)
    u, s, vh = svd(a, full_matrices=False)
    keep = s > rtol * s[..., :1]
    s_inv = torch.where(keep, 1 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return (vh.transpose(-1, -2).conj() * s_inv[..., None, :].to(
        vh.dtype)) @ u.transpose(-1, -2).conj()


def matrix_power(a, n):
    return torch.linalg.matrix_power(a, n)


def matrix_rank(M, rtol=None, *, tol=None):
    """numpy's rank: singular values above ``S.max() * max(m, n) * eps``
    (an ``rtol`` / ``tol`` given is that threshold, as in ``jnp``)."""
    if tol is not None:
        rtol = tol
    if not (M.is_floating_point() or M.is_complex()):
        M = M.to(torch.float32)
    if M.ndim < 2:
        return (M != 0).any().to(torch.int32)
    S = svdvals(M)
    if rtol is None:
        rtol = S.amax(-1) * max(M.shape[-2:]) * torch.finfo(S.dtype).eps
    rtol = torch.as_tensor(rtol, dtype=S.dtype, device=S.device)
    return (S > rtol.unsqueeze(-1)).sum(-1)


def multi_dot(arrays):
    return torch.linalg.multi_dot(list(arrays))


def qr(a, mode: str = "reduced"):
    q, r = torch.linalg.qr(a, mode=mode)
    return r if mode == "r" else (q, r)


def svd(a, full_matrices: bool = True, compute_uv: bool = True,
        hermitian: bool = False):
    if not compute_uv:
        return svdvals(a)
    return torch.linalg.svd(a, full_matrices=full_matrices,
                            driver=_svd_method(a))


def svdvals(a):
    return torch.linalg.svdvals(a, driver=_svd_method(a))


def eig(a):
    return torch.linalg.eig(a)


def eigvals(a):
    return torch.linalg.eigvals(a)


def eigh(a, UPLO=None, symmetrize_input: bool = True):
    return torch.linalg.eigh(_sym(a) if symmetrize_input else a,
                             UPLO=UPLO or "L")


def eigvalsh(a, UPLO="L"):
    return torch.linalg.eigvalsh(a, UPLO=UPLO)


def solve(a, b):
    return torch.linalg.solve(a, b)


def lstsq(a, b, rcond=None, *, numpy_resid: bool = False):
    """``jnp.linalg.lstsq`` for a 2-D ``a``: the minimum-norm solution
    through an SVD, singular values below ``rcond * s[0]`` dropped;
    returns ``(x, resid, rank, s)``, ``resid`` the squared residual norm
    of each column (an empty tensor under ``numpy_resid`` when numpy
    would return one)."""
    if not a.is_floating_point() and not a.is_complex():
        a = a.to(torch.float32)
    b = b.to(a.dtype)
    if a.ndim != 2:
        raise TypeError(
            f"{a.ndim}-dimensional array given. Array must be "
            "two-dimensional")
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(n, m)
    elif rcond < 0:
        rcond = torch.finfo(a.dtype).eps
    u, s, vt = svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    safe_s = torch.where(mask, s, torch.ones_like(s)).to(a.dtype)
    s_inv = torch.where(mask, 1 / safe_s, torch.zeros_like(safe_s))[:, None]
    x = vt.conj().T @ (s_inv * (u.conj().T @ b))
    if numpy_resid and (int(rank) < n or m <= n):
        resid = torch.zeros(0, dtype=s.dtype, device=a.device)
    else:
        resid = torch.linalg.vector_norm(b - a @ x, dim=0) ** 2
    return (x.reshape(-1) if vec else x), resid, rank, s


def cond(x, p=None):
    """The 2-norm condition number from the singular values (``p`` None,
    2 or -2), else torch's."""
    if p in (None, 2, -2):
        s = svdvals(x)
        hi, lo = s[..., 0], s[..., -1]
        return hi / lo if p != -2 else lo / hi
    return torch.linalg.cond(x, p)


def norm(x, ord=None, axis=None, keepdims: bool = False):
    return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)


def _stack_obs(m, y, rowvar):
    m = m if m.ndim > 1 else m[None]
    if not rowvar and m.shape[0] != 1:
        m = m.T
    if y is not None:
        y = y if y.ndim > 1 else y[None]
        if not rowvar and y.shape[0] != 1:
            y = y.T
        m = torch.cat([m, y], dim=0)
    if not (m.is_floating_point() or m.is_complex()):
        m = m.to(torch.float32)
    return m


def cov(m, y=None, rowvar: bool = True, bias: bool = False, ddof=None,
        fweights=None, aweights=None):
    """numpy's ``cov``: rows are variables unless ``rowvar`` is False."""
    one_var = m.ndim == 1 and y is None
    x = _stack_obs(m, y, rowvar)
    correction = ddof if ddof is not None else (0 if bias else 1)
    out = torch.cov(x, correction=correction, fweights=fweights,
                    aweights=aweights)
    return out.reshape(()) if one_var else out


def corrcoef(x, y=None, rowvar: bool = True):
    one_var = x.ndim == 1 and y is None
    out = torch.corrcoef(_stack_obs(x, y, rowvar))
    return out.reshape(()) if one_var else out


def cholesky_solve(b, l, upper: bool = False):  # noqa: E741
    """Solve A x = b given A's Cholesky factor (ref: linalg.py
    cholesky_solve): two triangular solves."""
    lt = l.transpose(-1, -2).conj()
    if upper:
        y = torch.linalg.solve_triangular(lt, b, upper=False)
        return torch.linalg.solve_triangular(l, y, upper=True)
    y = torch.linalg.solve_triangular(l, b, upper=False)
    return torch.linalg.solve_triangular(lt, y, upper=True)


def triangular_solve(a, b, upper: bool = True, transpose: bool = False,
                     unitriangular: bool = False):
    """ref: linalg.py triangular_solve."""
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def lu(a, pivot: bool = True):
    """ref: linalg.py lu → (LU packed, 1-based pivots, info); info is
    zeros (torch raises on a failed factorization)."""
    lu_, piv = torch.linalg.lu_factor(a)
    info = torch.zeros(a.shape[:-2], dtype=torch.int32, device=a.device)
    return lu_, piv.to(torch.int32), info


def lu_unpack(lu_data, lu_pivots, unpack_ludata: bool = True,
              unpack_pivots: bool = True):
    """ref: linalg.py lu_unpack → (P, L, U) with A = P L U."""
    return torch.lu_unpack(lu_data, lu_pivots.to(torch.int32),
                           unpack_data=unpack_ludata,
                           unpack_pivots=unpack_pivots)


# paddle.linalg re-exports the paddle.tensor implementations — alias
# them rather than duplicating (tensor.dot is paddle's row-wise dot)
from .tensor import cross, dist, dot, matmul  # noqa: E402,F401


def householder_product(x, tau):
    """ref: linalg.py householder_product (orgqr)."""
    return torch.linalg.householder_product(x, tau)


def pca_lowrank(x, q=None, center: bool = True, niter: int = 2):
    """ref: linalg.py pca_lowrank → (U, S, V) of the (centered) data,
    from an exact SVD (not torch's randomized one), as the JAX package
    computes it."""
    if q is None:
        q = min(6, *x.shape[-2:])
    if center:
        x = x - x.mean(dim=-2, keepdim=True)
    u, s, vt = svd(x, full_matrices=False)
    return u[..., :q], s[..., :q], vt.transpose(-1, -2)[..., :q]
