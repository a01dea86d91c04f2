"""Ring attention: exact attention over sequence-sharded activations (the
port's counterpart of ``paddle_tpu/ops/ring_attention.py``).

Each rank of the mesh's ``sp`` axis holds its slice ``[b, s/sp, h, d]``
of Q, K and V (the JAX package's ring takes global arrays that
``shard_map`` splits; a port rank holds its piece). The K/V chunks pass
from rank to rank+1 through ``parallel.collective.exchange`` (the JAX
package's ``lax.ppermute``) while every rank accumulates its queries'
attention over the whole sequence, merging the blocks' ``(o, lse)`` in
float32 log-space (Ring Attention, Liu et al. 2023).

The ring is one ``torch.autograd.Function``. Its forward takes P steps:
one block a step, merged into the running ``(o, lse)``, and the chunk
passed on. Its backward takes P steps again: the K/V chunks travel the
same way, float32 dK/dV accumulators travel with them and reach their
owner after the last step, and dQ accumulates in float32; each output is
cast once at the end. With the merged ``o`` and ``lse`` a block's
backward is exact: ``exp(S_j - lse)`` is the global softmax restricted
to block j, so no gradient flows through ``lse``, and ``delta =
rowsum(o * do)`` is one buffer for every block. Under ``nn.utils.checkpoint``
and ``scan_layers`` the recompute runs the ring again, on every rank in
the same order.

Which blocks run on the flash kernels. A block with no key-padding mask
and no attention dropout, whose head dim the kernels take
(``flash_attention.kernel_route``) and whose caller did not turn the
kernels off (``use_flash=False``, ``GPTConfig.use_flash``), runs on
kernels B1-B3 (``ops/flash_attention``, the plain twins for a CPU
tensor): B1 gives the block's ``(o, lse)``,
causal on the diagonal block and not on the earlier blocks; B2 and B3
then run once a block with the merged ``o`` and ``lse`` and a shared
``delta`` (B2 writes it on the first block and reads it after). Under
causal masking the later blocks are fully masked, so they are not
computed (merging them would change nothing); their K/V still pass on.
``chunk_size`` does not change that route: it tiles the block inside
the JAX package's XLA code, and the kernels tile by themselves.

Blocks with a key-padding mask or attention dropout, or that the
kernels do not take, run the plain torch blocks below (:func:`_block_attention`, :func:`_block_attention_streamed`:
the JAX functions' counterparts) on any device, as the port's dense
attention runs masked or dropout attention outside the kernels
(``flash_attention_available``) and the JAX ring has no kernel for them
either. Their dropout masks are the JAX package's: a block's key is
``fold_in(fold_in(key, q_base), k_base)`` over the block's (or its
``chunk_size`` tile's) shape ``[b, h, s/sp, chunk]``, a data-parallel
rank drawing its rows and a tensor-parallel rank its heads of it
(``core/rng.py``). The key-padding chunk ``[b, s/sp]`` travels with its
K/V chunk.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from ..core import rng, threefry
from . import flash_attention as fa

NEG_INF = -1e30

# host seconds the rings spent in their exchanges, forward and backward
# (a gloo exchange of CUDA tensors waits for the card: it includes that)
exchange_seconds = 0.0


def _expand_kv(x, hq):
    group = hq // x.shape[2]
    return x if group == 1 else x.repeat_interleave(group, dim=2)


def _keep_mask(dropout_key, q_base, k_base, shape, device):
    """JAX's ``bernoulli(fold_in(fold_in(key, q_base), k_base), keep,
    shape)`` draw as uniform bits (this rank's rows and heads of it)."""
    key = threefry.fold_in(threefry.fold_in(dropout_key, q_base), k_base)
    return threefry.uniform(key, shape, device=device,
                            rows=rng.mask_rows(shape),
                            cols=rng.mask_cols(shape, seq=False))


def _block_attention(q, k, v, sm_scale, mask, dropout_p: float = 0.0,
                     dropout_key=None, q_base=0, k_base=0):
    """Partial attention of local queries against one K/V chunk.

    q: [b, sq, h, d]; k/v: [b, sk, hkv, d] (expanded over a GQA group);
    mask: additive, broadcastable to [b, h, sq, sk], or None. Returns
    (out [b, sq, h, d] f32, lse [b, h, sq] f32) with ``lse = NEG_INF``
    rows giving out = 0. Attention-weight dropout drops entries of the
    softmax numerator only; the normalization and lse come from the
    undropped weights."""
    k, v = _expand_kv(k, q.shape[2]), _expand_kv(v, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if mask is not None:
        logits = logits + mask
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=NEG_INF)
    p = torch.exp(logits - m_safe)
    if mask is not None:
        # the sentinel is finite: a fully masked row must sum to zero
        p = torch.where(mask > NEG_INF * 0.5, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    lse = (m_safe + torch.log(torch.clamp(denom, min=1e-37)))[..., 0]
    fully_masked = denom[..., 0] <= 0.0
    lse = torch.where(fully_masked, NEG_INF, lse)
    if dropout_p and dropout_key is not None:
        keep = 1.0 - dropout_p
        kept = _keep_mask(dropout_key, q_base, k_base, p.shape,
                          p.device) < keep
        p = torch.where(kept, p / torch.full((), keep, device=p.device), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / torch.clamp(denom, min=1e-37).permute(0, 2, 1, 3)
    out = torch.where(fully_masked.permute(0, 2, 1)[..., None], 0.0, out)
    return out, lse


def _merge(o1, lse1, o2, lse2):
    """Online combine of two partial attentions in log-space."""
    lse = torch.logaddexp(lse1, lse2)                      # [b,h,q]
    w1 = torch.exp(lse1 - lse).permute(0, 2, 1)[..., None]
    w2 = torch.exp(lse2 - lse).permute(0, 2, 1)[..., None]
    return o1 * w1 + o2 * w2, lse


def _pad_to_additive(kpm):
    """[b, sk] bool (True = attend) or additive float -> additive f32."""
    if kpm is None:
        return None
    if kpm.dtype == torch.bool:
        return torch.where(kpm, 0.0, NEG_INF).float()
    return kpm.float()


def _causal_mask(sq, sk, offset, device=None):
    rows = torch.arange(sq, device=device)[:, None] + offset
    cols = torch.arange(sk, device=device)[None, :]
    return torch.where(rows >= cols, 0.0, NEG_INF)


def _tile_mask(kpm, causal, sq, k0, w, q_base, k_base, device):
    """The additive mask of columns ``k0 .. k0 + w`` of a block (global
    offsets ``q_base`` / ``k_base``), or None."""
    mask = None if kpm is None else kpm[:, None, None, k0:k0 + w]
    if causal:
        cm = _causal_mask(sq, w, q_base - k_base - k0, device)[None, None]
        mask = cm if mask is None else mask + cm
    return mask


def _tiles(sq, sk, chunk, causal, q_base, k_base):
    """The column offsets of a block's tiles of width ``chunk`` that have
    a visible key (under causal masking, a tile right of every query
    row is fully masked: merging it would change nothing)."""
    return [k0 for k0 in range(0, sk, chunk)
            if not causal or k_base + k0 <= q_base + sq - 1]


def _block_attention_streamed(q, k, v, sm_scale, q_base, k_base, causal,
                              chunk, kpm=None, dropout_p: float = 0.0,
                              dropout_key=None):
    """:func:`_block_attention` with the K/V chunk streamed in tiles of
    ``chunk`` columns merged online (the JAX package's scan over tiles):
    each tile's causal mask is offset by the blocks' global positions
    ``q_base`` / ``k_base``, and its dropout key folds in its own column
    offset. ``kpm``: additive key-padding [b, sk] of this chunk. Returns
    (out f32, lse f32) like :func:`_block_attention`."""
    b, sq, h, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sq), NEG_INF, device=q.device)
    for k0 in _tiles(sq, k.shape[1], chunk, causal, q_base, k_base):
        mask = _tile_mask(kpm, causal, sq, k0, chunk, q_base, k_base,
                          q.device)
        o_t, lse_t = _block_attention(
            q, k[:, k0:k0 + chunk], v[:, k0:k0 + chunk], sm_scale, mask,
            dropout_p, dropout_key, q_base, k_base + k0)
        o, lse = _merge(o, lse, o_t, lse_t)
    return o, lse


def _block_backward(q, k, v, do, delta, lse, sm_scale, mask,
                    dropout_p, dropout_key, q_base, k_base):
    """The gradients (dq, dk, dv, f32) of one block's share of the
    merged output, from the merged ``lse`` and ``delta = rowsum(o *
    do)`` [b, h, sq]; dk and dv summed over the GQA group."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    kf, vf = _expand_kv(k, hq).float(), _expand_kv(v, hq).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    if mask is not None:
        s = s + mask
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask > NEG_INF * 0.5, p, 0.0)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    pd = p
    if dropout_p and dropout_key is not None:
        keep = 1.0 - dropout_p
        kept = _keep_mask(dropout_key, q_base, k_base, p.shape,
                          p.device) < keep
        div = torch.full((), keep, device=p.device)
        pd = torch.where(kept, p / div, 0.0)
        dp = torch.where(kept, dp / div, 0.0)
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, dof)
    if hkv != hq:
        sk = k.shape[1]
        dk = dk.reshape(b, sk, hkv, hq // hkv, d).sum(dim=3)
        dv = dv.reshape(b, sk, hkv, hq // hkv, d).sum(dim=3)
    return dq, dk, dv


class _Ring:
    """One ring call's settings: the sp ``group`` (``size`` ranks, this
    one at ``index``; None for one rank), the masking, the dropout and
    the route (``flash``: kernels B1-B3)."""

    def __init__(self, group, size, index, causal, scale, chunk,
                 dropout_p, dropout_key, flash):
        self.group, self.size, self.index = group, size, index
        self.causal, self.scale, self.chunk = causal, scale, chunk
        self.dropout_p, self.dropout_key = dropout_p, dropout_key
        self.flash = flash
        self.slices = rng.saved_slices()

    def visible(self, src: int) -> bool:
        """Whether the block of chunk ``src`` has a visible key."""
        return not self.causal or src <= self.index

    def bases(self, sq, src):
        return self.index * sq, src * sq

    def pass_on(self, tensors):
        """Send ``tensors`` to rank+1 and receive rank-1's (one exchange
        over the sp group)."""
        global exchange_seconds
        t0 = time.perf_counter()
        from ..parallel.collective import exchange
        nxt, prv = (self.index + 1) % self.size, (self.index - 1) % self.size
        got = exchange([(t, nxt) for t in tensors],
                       [(t.shape, t.dtype, t.device, prv) for t in tensors],
                       self.group)
        exchange_seconds += time.perf_counter() - t0
        return got


def _flash_fwd(q, k, v, scale, causal):
    if fa.impl == "plain":
        return fa.flash_attention_fwd_torch(q, k, v, scale, causal)
    return fa.flash_attention_fwd_kernel(q, k, v, scale, causal)


def _flash_bwd(q, k, v, o, lse, do, scale, causal, delta, ready):
    if fa.impl == "plain" or not q.is_cuda:
        return fa.flash_attention_bwd_torch(q, k, v, o, lse, do, scale,
                                            causal)
    dq = fa.flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, scale, causal,
                                          delta=delta, delta_ready=ready)
    dk, dv = fa.flash_attention_bwd_dkv_kernel(q, k, v, o, lse, do, scale,
                                               causal, delta=delta)
    return dq, dk, dv


def _ring_forward(q, k, v, kpm, r: _Ring):
    b, sq, hq, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, hq, sq), NEG_INF, device=q.device)
    kv = torch.stack([k, v])
    for j in range(r.size):
        src = (r.index - j) % r.size
        if r.visible(src):
            q_base, k_base = r.bases(sq, src)
            if r.flash:
                o_j, lse_j = _flash_fwd(q, kv[0], kv[1], r.scale,
                                        r.causal and src == r.index)
                o_j = o_j.float()
            else:
                o_j, lse_j = _block_attention_streamed(
                    q, kv[0], kv[1], r.scale, q_base, k_base, r.causal,
                    r.chunk, kpm, r.dropout_p, r.dropout_key)
            o, lse = _merge(o, lse, o_j, lse_j)
        if j < r.size - 1:
            got = r.pass_on([kv] if kpm is None else [kv, kpm])
            kv = got[0]
            kpm = got[1] if kpm is not None else None
    return o.to(q.dtype), lse.contiguous()


def _ring_backward(q, k, v, kpm, o, lse, do, r: _Ring):
    b, sq, hq, _ = q.shape
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    do = do.contiguous()
    delta = torch.empty_like(lse) if r.flash else \
        (o.float() * do.float()).sum(dim=-1).permute(0, 2, 1)
    ready = False
    for j in range(r.size):
        src = (r.index - j) % r.size
        if r.visible(src):
            q_base, k_base = r.bases(sq, src)
            if r.flash:
                grads = _flash_bwd(q, kv[0], kv[1], o, lse, do, r.scale,
                                   r.causal and src == r.index, delta, ready)
                ready = True
                dq += grads[0].float()
                dkv[0] += grads[1].float()
                dkv[1] += grads[2].float()
            else:
                for k0 in _tiles(sq, kv.shape[2], r.chunk, r.causal,
                                 q_base, k_base):
                    w = r.chunk
                    mask = _tile_mask(kpm, r.causal, sq, k0, w, q_base,
                                      k_base, q.device)
                    g = _block_backward(
                        q, kv[0, :, k0:k0 + w], kv[1, :, k0:k0 + w], do,
                        delta, lse, r.scale, mask, r.dropout_p,
                        r.dropout_key, q_base, k_base + k0)
                    dq += g[0]
                    dkv[0, :, k0:k0 + w] += g[1]
                    dkv[1, :, k0:k0 + w] += g[2]
        if r.size > 1:
            last = j == r.size - 1
            sends = [dkv] if last else [dkv, kv] + (
                [kpm] if kpm is not None else [])
            got = r.pass_on(sends)
            dkv = got[0]
            if not last:
                kv = got[1]
                kpm = got[2] if kpm is not None else None
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """forward: the ring's merged (o, lse); backward: the ring again, with
    the dK/dV accumulators travelling to their owners."""

    @staticmethod
    def forward(ctx, q, k, v, kpm, r):
        o, lse = _ring_forward(q, k, v, kpm, r)
        ctx.save_for_backward(q, k, v, kpm, o, lse)
        ctx.ring = r
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kpm, o, lse = ctx.saved_tensors
        with rng.restored_slices(ctx.ring.slices):
            dq, dk, dv = _ring_backward(q, k, v, kpm, o, lse, do, ctx.ring)
        return dq, dk, dv, None, None


def ring_attention(q, k, v, *, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   axis: str = "sp", mesh=None,
                   chunk_size: Optional[int] = None,
                   key_padding_mask=None,
                   dropout_p: float = 0.0, dropout_key=None,
                   use_flash: bool = True):
    """Exact attention with Q/K/V sequence-sharded over mesh axis ``axis``.

    q: this rank's ``[b, s/sp, h, d]`` slice of the sequence; k, v:
    ``[b, s/sp, h_kv, d]`` with ``h % h_kv == 0`` (grouped-query heads
    stay unexpanded). Returns this rank's ``[b, s/sp, h, d]`` slice of
    the attention over the whole sequence; differentiable. One rank on
    ``axis`` is full attention over ``q``'s sequence.

    ``chunk_size``: the plain blocks' tile width (it must divide
    ``s/sp``); it selects the JAX package's dropout tiles.
    ``key_padding_mask``: this rank's ``[b, s/sp]`` slice, bool (True =
    attend) or additive float. ``dropout_p`` with ``dropout_key``:
    attention-weight dropout (the module docstring's masks).
    ``use_flash=False`` runs every block on the plain torch blocks."""
    from ..parallel.mesh import get_mesh
    mesh = mesh or get_mesh()
    sp = mesh.axis_size(axis)
    b, s_local, hq, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if dropout_p and dropout_key is None:
        raise ValueError("dropout_p > 0 requires dropout_key")
    if not dropout_p:
        dropout_key = None
    kpm = _pad_to_additive(key_padding_mask)
    if kpm is not None and tuple(kpm.shape) != (b, s_local):
        raise ValueError(
            f"key_padding_mask must be [batch, seq] = {(b, s_local)}, got "
            f"{tuple(kpm.shape)}")
    if chunk_size is not None:
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got "
                             f"{chunk_size}")
        if s_local % chunk_size:
            raise ValueError(
                f"chunk_size {chunk_size} must divide s/sp = {s_local}")
    chunk = chunk_size if chunk_size is not None and chunk_size < s_local \
        else s_local
    flash = (use_flash and kpm is None and dropout_key is None
             and fa.kernel_route(d, q.dtype) is not None)
    r = _Ring(mesh.group(axis) if sp > 1 else None, sp,
              mesh.local_rank(axis), causal, scale, chunk, dropout_p,
              dropout_key, flash)
    return _RingAttention.apply(q, k, v, kpm, r)
