"""paddle_tpu_torch.signal — framing, STFT and ISTFT (the port's
counterpart of ``paddle_tpu/signal.py``).

These are the JAX package's formulas, not ``torch.stft``'s defaults:
``stft`` centre-pads with ``pad_mode`` (reflect), frames with
``unfold``, windows and takes ``rfft`` (or ``fft``) over each frame and
returns ``[..., n_fft // 2 + 1, frames]`` complex; ``istft`` overlap-adds
the inverse frames with one ``index_add_`` and divides by the summed
squared window.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# jnp.pad's mode names -> F.pad's
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular"}


def frame(x, frame_length: int, hop_length: int, axis: int = -1):
    """Slide overlapping frames over the time axis (ref: signal.py frame
    op). axis=-1 → [..., frame_length, num_frames]; axis=0 →
    [num_frames, frame_length, ...] (reference layouts)."""
    if axis not in (0, -1):
        raise ValueError("frame supports axis=0 or axis=-1")
    if axis == 0:
        x = torch.movedim(x, 0, -1)
    n = x.shape[-1]
    if n < frame_length:
        raise ValueError(
            f"input length {n} < frame_length {frame_length}")
    out = x.unfold(-1, frame_length, hop_length)      # [..., num, frame]
    out = torch.swapaxes(out, -1, -2)                 # [..., frame, num]
    if axis == 0:
        out = torch.movedim(out, -1, 0)               # [num, ..., frame]
        out = torch.movedim(out, -1, 1)               # [num, frame, ...]
    return out


def _window(window, win_length, n_fft, device):
    if window is None:
        window = torch.ones(win_length, dtype=torch.float32, device=device)
    window = torch.as_tensor(window, dtype=torch.float32, device=device)
    if win_length < n_fft:  # center-pad the window to n_fft
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def stft(x, n_fft: int, hop_length: Optional[int] = None,
         win_length: Optional[int] = None, window=None,
         center: bool = True, pad_mode: str = "reflect",
         onesided: bool = True):
    """ref: paddle.signal.stft — returns [..., n_fft//2+1, frames]."""
    x = x.to(torch.float32)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = _window(window, win_length, n_fft, x.device)
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                  mode=_PAD_MODES[pad_mode]).reshape(lead + (-1,))
    frames = frame(x, n_fft, hop_length)             # [..., n_fft, num]
    if onesided:  # real input: rfft does half the work directly
        return torch.fft.rfft(frames * window[:, None], dim=-2)
    return torch.fft.fft(frames * window[:, None], dim=-2)


def istft(spec, n_fft: int, hop_length: Optional[int] = None,
          win_length: Optional[int] = None, window=None,
          center: bool = True, length: Optional[int] = None,
          onesided: bool = True):
    """ref: paddle.signal.istft — overlap-add inverse."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = _window(window, win_length, n_fft, spec.device)
    if onesided:
        frames = torch.fft.irfft(spec, n=n_fft, dim=-2)
    else:
        frames = torch.fft.ifft(spec, dim=-2).real
    frames = frames * window[:, None]
    num = frames.shape[-1]
    out_len = n_fft + hop_length * (num - 1)
    batch_shape = frames.shape[:-2]
    # vectorized overlap-add: one scatter-add over flat positions
    pos = (hop_length * torch.arange(num, device=spec.device)[:, None]
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    flat = torch.swapaxes(frames, -1, -2).reshape(
        batch_shape + (num * n_fft,))
    out = torch.zeros(batch_shape + (out_len,), dtype=frames.dtype,
                      device=spec.device).index_add_(-1, pos, flat)
    norm = torch.zeros(out_len, dtype=torch.float32,
                       device=spec.device).index_add_(
        0, pos, torch.tile(window ** 2, (num,)))
    out = out / torch.clamp(norm, min=1e-8)
    if center:
        pad = n_fft // 2
        out = out[..., pad:]  # drop left pad; right region still holds
        if length is None:    # valid overlap — keep it when length asks
            out = out[..., : max(out_len - 2 * pad, 0)]
    if length is not None:
        out = out[..., :length]
    return out
