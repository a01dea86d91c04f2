"""paddle_tpu_torch.fft — the spectral API (the port's counterpart of
``paddle_tpu/fft.py``) on ``torch.fft`` (cuFFT on the card).

Signatures are ``jnp.fft``'s (``n`` / ``s``, ``axis`` / ``axes``,
``norm``), which the JAX package re-exports; ``hfft2``, ``ihfft2``,
``hfftn`` and ``ihfftn`` are the JAX package's own compositions, ported
as they are. ``fftfreq`` / ``rfftfreq`` create on the flat API's device.
"""

from __future__ import annotations

import torch

from .core.device import current_device


def _norm(norm):
    return norm or "backward"


def fft(x, n=None, axis=-1, norm=None):
    return torch.fft.fft(x, n=n, dim=axis, norm=_norm(norm))


def ifft(x, n=None, axis=-1, norm=None):
    return torch.fft.ifft(x, n=n, dim=axis, norm=_norm(norm))


def rfft(x, n=None, axis=-1, norm=None):
    return torch.fft.rfft(x, n=n, dim=axis, norm=_norm(norm))


def irfft(x, n=None, axis=-1, norm=None):
    return torch.fft.irfft(x, n=n, dim=axis, norm=_norm(norm))


def hfft(x, n=None, axis=-1, norm=None):
    return torch.fft.hfft(x, n=n, dim=axis, norm=_norm(norm))


def ihfft(x, n=None, axis=-1, norm=None):
    return torch.fft.ihfft(x, n=n, dim=axis, norm=_norm(norm)).resolve_conj()


def _axes_of(x, s, axes):
    if axes is None:  # numpy/reference default: last len(s) axes
        axes = tuple(range(x.ndim - (len(s) if s is not None else x.ndim),
                           x.ndim))
    return tuple(a % x.ndim for a in axes)


def fft2(x, s=None, axes=(-2, -1), norm=None):
    return torch.fft.fft2(x, s=s, dim=axes, norm=_norm(norm))


def ifft2(x, s=None, axes=(-2, -1), norm=None):
    return torch.fft.ifft2(x, s=s, dim=axes, norm=_norm(norm))


def rfft2(x, s=None, axes=(-2, -1), norm=None):
    return torch.fft.rfft2(x, s=s, dim=axes, norm=_norm(norm))


def irfft2(x, s=None, axes=(-2, -1), norm=None):
    return torch.fft.irfft2(x, s=s, dim=axes, norm=_norm(norm))


def fftn(x, s=None, axes=None, norm=None):
    return torch.fft.fftn(x, s=s, dim=_axes_of(x, s, axes),
                          norm=_norm(norm))


def ifftn(x, s=None, axes=None, norm=None):
    return torch.fft.ifftn(x, s=s, dim=_axes_of(x, s, axes),
                           norm=_norm(norm))


def rfftn(x, s=None, axes=None, norm=None):
    return torch.fft.rfftn(x, s=s, dim=_axes_of(x, s, axes),
                           norm=_norm(norm))


def irfftn(x, s=None, axes=None, norm=None):
    return torch.fft.irfftn(x, s=s, dim=_axes_of(x, s, axes),
                            norm=_norm(norm))


def fftfreq(n, d=1.0, dtype=None):
    return torch.fft.fftfreq(n, d, dtype=dtype or torch.float32,
                             device=current_device())


def rfftfreq(n, d=1.0, dtype=None):
    return torch.fft.rfftfreq(n, d, dtype=dtype or torch.float32,
                              device=current_device())


def fftshift(x, axes=None):
    return torch.fft.fftshift(x, dim=axes)


def ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, dim=axes)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """2-D Hermitian FFT (ref: paddle fft.py hfft2 — hfftn over the
    last two axes)."""
    return hfftn(x, s=s, axes=axes, norm=norm)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return ihfftn(x, s=s, axes=axes, norm=norm)


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    """N-D Hermitian FFT: complex-to-real with Hermitian-even input —
    FORWARD FFT over the leading axes + hfft on the last, all under the
    same norm (the JAX package's composition)."""
    axes = _axes_of(x, s, axes)
    lead, last = axes[:-1], axes[-1]
    if lead:
        x = fftn(x, s=None if s is None else s[:-1], axes=lead, norm=norm)
    return hfft(x, n=None if s is None else s[-1], axis=last, norm=norm)


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    """Inverse of :func:`hfftn`: ihfft on the last axis + INVERSE FFT
    over the leading axes, same norm throughout."""
    axes = _axes_of(x, s, axes)
    lead, last = axes[:-1], axes[-1]
    out = ihfft(x, n=None if s is None else s[-1], axis=last, norm=norm)
    if lead:
        out = ifftn(out, s=None if s is None else s[:-1], axes=lead,
                    norm=norm)
    return out
