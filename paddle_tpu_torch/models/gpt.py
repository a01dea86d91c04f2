"""GPT: decoder-only transformer LM (the port's counterpart of
``paddle_tpu/models/gpt.py``).

Same configuration, module tree and parameter names as the JAX package,
so a JAX state dict loads by identical key
(:func:`paddle_tpu_torch.interop.load_reference_state`). The attention
of the serving path goes through the paged KV pool of
:mod:`paddle_tpu_torch.inference.llm`; the dense cache path here serves
:meth:`GPTForCausalLM.generate`. Training runs the flash kernels through
``F.scaled_dot_product_attention`` and, with ``fused_loss``, hands
``(hidden, W)`` to :class:`GPTFusedPretrainingCriterion`.

Tensor parallelism (a live ``tp`` axis, ``parallel.reducer``): a rank
holds its slices of the weights the rules split (``vocab`` / ``mlp`` /
``heads`` / ``kv``) and each layer that owns them computes on its
slices once it learns its tp group (``attach_tp``): column-parallel qkv
over the rank's heads (``tp_permutation`` puts each rank's q, k and v
columns together), attention on the local heads, row-parallel
``out_proj`` / ``fc_out`` whose replicated bias is added once after the
all-reduce, a vocab-parallel embedding lookup and head, and the
vocab-parallel fused loss. :class:`GPTForCausalLMPipe` runs the decoder
blocks as a ``parallel.PipelineParallel`` trunk over ``pp``.

Sequence parallelism (``GPTConfig(sequence_parallel=True)`` on a mesh
with a live ``sp`` axis): the embeddings run on the whole sequence (its
positions are global), then a rank keeps its slice of the sequence
(``parallel.sharding.seq_slice``), its residual dropout
draws that slice of the global masks (``rng.seq_slice``), attention runs
as ``ops.ring_attention`` over the sp ranks, and the criteria take each
position's next-token label from the whole label row. The sp group is
the one a Model on the mesh attaches (``attach_sp``: ``MeshSync`` sums
the gradients over sp and gives the criterion the group too), else, for
a forward without gradients only, that of the installed mesh (the JAX
package's ``_sp_mesh``); off such a mesh the config runs plain
attention, and the decode cache always does.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import torch

from .. import amp, nn
from ..core import rng, threefry
from ..core.device import resolve_device
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import Layer, LayerList
from ..nn.utils import checkpoint, scan_layer_stack
from ..ops.fused_xent import fused_linear_cross_entropy
from ..parallel.collective import (SPGroup, copy_to_tp, gather_from_tp,
                                   reduce_from_tp)
from ..parallel.sharding import seq_slice
from ..ops.rotary import apply_rotary_pos_emb, rope_tables


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None   # grouped-query; None = num_heads
    ffn_hidden_size: Optional[int] = None  # None = 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation: str = "gelu"   # "swiglu" selects the gated MLP
    norm_type: str = "layer"   # "rms" selects RMSNorm (LLaMA-style)
    use_rope: bool = False     # rotary positions instead of learned
    rope_base: float = 10000.0
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    use_flash: bool = True
    remat: bool = False        # recompute each block in the backward
    # context parallelism: attention runs as ring attention over the
    # mesh's sp axis (ops/ring_attention); composes with dp/fsdp/tp, not
    # with the pp trunk or the decode cache. ring_chunk_size tiles each
    # plain ring block's K/V (it selects the JAX package's dropout tiles)
    sequence_parallel: bool = False
    ring_chunk_size: Optional[int] = None
    scan_layers: bool = False  # the JAX package's scan over the blocks
    fused_loss: bool = False   # training forward returns (hidden, W)

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


PRESETS = {
    "gpt2-small": dict(hidden_size=768, num_layers=12, num_heads=12,
                       max_position_embeddings=1024),
    "gpt2-medium": dict(hidden_size=1024, num_layers=24, num_heads=16,
                        max_position_embeddings=1024),
    "gpt2-large": dict(hidden_size=1280, num_layers=36, num_heads=20,
                       max_position_embeddings=1024),
    "gpt2-xl": dict(hidden_size=1600, num_layers=48, num_heads=25,
                    max_position_embeddings=1024),
    "gpt3-1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16,
                      max_position_embeddings=2048),
    "gpt3-6.7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                      max_position_embeddings=2048),
    "gpt3-13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                     max_position_embeddings=2048),
}


def llama_config(hidden_size: int = 2048, num_layers: int = 22,
                 num_heads: int = 16, num_kv_heads: int = 4,
                 vocab_size: int = 32000,
                 max_position_embeddings: int = 2048,
                 **overrides) -> GPTConfig:
    """LLaMA-style decoder: RoPE + RMSNorm + SwiGLU + GQA + untied
    head."""
    base = dict(vocab_size=vocab_size, hidden_size=hidden_size,
                num_layers=num_layers, num_heads=num_heads,
                num_kv_heads=num_kv_heads,
                ffn_hidden_size=int(hidden_size * 8 / 3) // 128 * 128,
                max_position_embeddings=max_position_embeddings,
                hidden_dropout=0.0, attention_dropout=0.0,
                activation="swiglu", norm_type="rms", use_rope=True,
                tie_word_embeddings=False)
    base.update(overrides)
    return GPTConfig(**base)


def gpt_config(name: str, **overrides) -> GPTConfig:
    cfg = dict(PRESETS[name])
    cfg.update(overrides)
    return GPTConfig(**cfg)


def _block_perm(blocks, tp: int) -> torch.Tensor:
    """A permutation of a dim made of contiguous ``blocks`` (``[(start,
    width), ...]``) that puts rank i's 1/tp of every block together, in
    block order, for i = 0 .. tp-1."""
    idx = []
    for i in range(tp):
        for start, width in blocks:
            w = width // tp
            idx.extend(range(start + i * w, start + (i + 1) * w))
    return torch.tensor(idx, dtype=torch.long)


def _row_parallel(x, linear, tp):
    """A row-parallel product: this rank's partial ``x @ W_local``
    summed over the tp ranks, then the (replicated) bias, added once."""
    y = reduce_from_tp(F.linear(x, linear.weight), tp)
    return y + linear.bias if linear.bias is not None else y


def _installed_sp() -> Optional[SPGroup]:
    """The sp group of the installed mesh when it has a live ``sp`` axis
    and a process group, else None."""
    from ..parallel.mesh import get_mesh
    mesh = get_mesh(required=False)
    if mesh is None or not mesh.has_axis("sp") or mesh.mesh is None:
        return None
    return SPGroup(mesh)


class _SequenceParallel:
    """A layer that computes on a sequence-parallel rank's slice: the sp
    group a Model on an sp mesh attaches, else the installed mesh's."""

    _sp = None

    def attach_sp(self, sp) -> None:
        if self.cfg.sequence_parallel:
            self._sp = sp

    def _sp_mesh(self) -> Optional[SPGroup]:
        """The sp group when the config is sequence-parallel and a mesh
        with a real sp axis is attached or installed, else None (plain
        attention: the same config runs unsharded unchanged). The
        installed mesh's group serves a forward without gradients only:
        training needs the Model's ``MeshSync``, which sums the gradients
        over sp and slices the criterion's labels."""
        if not self.cfg.sequence_parallel:
            return None
        if self._sp is not None:
            return self._sp
        sp = _installed_sp()
        if sp is not None and torch.is_grad_enabled():
            raise NotImplementedError(
                "a sequence-parallel GPT trains through a Model on the sp "
                "mesh (parallel.distributed_model); under the installed "
                "mesh alone it runs a forward under torch.no_grad()")
        return sp


def _norm(cfg: GPTConfig):
    if cfg.norm_type == "rms":
        return nn.RMSNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon)
    return nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon)


class GPTAttention(_SequenceParallel, Layer):
    """Causal self-attention with fused QKV, grouped-query heads and an
    optional dense KV cache ``(k_cache, v_cache, idx)``; the cache is
    written in place. Under tp the rank computes its heads (and its kv
    heads under GQA) and sums ``out_proj`` over the tp ranks; under sp
    it is ring attention over the sp ranks' slices of the sequence."""

    _tp = None   # the tp group once the qkv and out weights are split
    tp_params = ("qkv_proj.weight", "qkv_proj.bias", "out_proj.weight")

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        qkv_out = h + 2 * cfg.num_kv_heads * hd
        init = I.Normal(0.0, cfg.initializer_range)
        self.qkv_proj = nn.Linear(h, qkv_out, weight_attr=init,
                                  axes=("embed", "heads"),
                                  bias_axes=("heads",))
        self.out_proj = nn.Linear(h, h, weight_attr=I.Normal(
            0.0, cfg.initializer_range / math.sqrt(2 * cfg.num_layers)),
            axes=("heads", "embed"), bias_axes=(None,))

    def tp_permutation(self, name: str, tp: int):
        """The qkv columns in head-aligned tp slices: rank i's q heads,
        then its kv heads' k and v columns."""
        if name not in ("qkv_proj.weight", "qkv_proj.bias"):
            return None
        hd = self.cfg.head_dim
        q, kv = self.num_heads * hd, self.num_kv_heads * hd
        return _block_perm([(0, q), (q, kv), (q + kv, kv)], tp)

    def attach_tp(self, tp) -> None:
        width = (self.num_heads + 2 * self.num_kv_heads) * self.cfg.head_dim
        if width % tp.size:
            return      # the rules left the weights whole
        if self.num_heads % tp.size or self.num_kv_heads % tp.size:
            raise NotImplementedError(
                f"tp={tp.size} must divide num_heads {self.num_heads} and "
                f"num_kv_heads {self.num_kv_heads}")
        self._tp = tp

    def forward(self, x, attn_mask=None, cache=None, position_ids=None):
        b, s, _ = x.shape
        hd = self.cfg.head_dim
        tp = self._tp
        n = tp.size if tp is not None else 1
        nh, nkv = self.num_heads // n, self.num_kv_heads // n
        h = nh * hd
        heads = rng.head_slice(tp.index * nh, self.num_heads) \
            if tp is not None else contextlib.nullcontext()
        if tp is not None:
            x = copy_to_tp(x, tp)
        # [b, s] KEY-padding masks become the additive [b, 1, 1, s]
        # form; rows whose whole causal window is padding are zeroed
        dense_mask = attn_mask
        row_has_key = None
        if attn_mask is not None and attn_mask.dim() == 2:
            kpm = attn_mask if attn_mask.dtype == torch.bool \
                else attn_mask > -1e29
            dense_mask = torch.where(kpm, 0.0, -1e30).float()[:, None,
                                                              None, :]
            row_has_key = torch.cumsum(kpm.long(), dim=1) > 0
        qkv = self.qkv_proj(x)
        q, k, v = torch.split(qkv, [h, nkv * hd, nkv * hd], dim=-1)
        q = q.reshape(b, s, nh, hd)
        k = k.reshape(b, s, nkv, hd)
        v = v.reshape(b, s, nkv, hd)
        if self.cfg.use_rope:
            cos, sin = rope_tables(hd, self.cfg.max_position_embeddings,
                                   self.cfg.rope_base)
            if position_ids is None:
                start = cache[2] if cache is not None else 0
                position_ids = (start + torch.arange(
                    s, device=x.device))[None, :].expand(b, s)
            q, k = apply_rotary_pos_emb(q, k, cos, sin,
                                        position_ids=position_ids)
        if cache is not None:
            k_cache, v_cache, idx = cache
            k_cache[:, idx:idx + s] = k
            v_cache[:, idx:idx + s] = v
            cache = (k_cache, v_cache, idx + s)
            k, v = k_cache, v_cache
            # query t (absolute idx+t) attends keys at positions <= idx+t
            kl = k.shape[1]
            key_pos = torch.arange(kl, device=x.device)[None, None, None]
            qry_pos = (idx + torch.arange(s, device=x.device))[
                None, None, :, None]
            causal = torch.where(key_pos <= qry_pos, 0.0, float("-inf"))
            if dense_mask is not None:
                if dense_mask.dtype == torch.bool:
                    dense_mask = torch.where(dense_mask, 0.0,
                                             float("-inf"))
                causal = causal + dense_mask
            with heads:
                out = F.scaled_dot_product_attention(
                    q, k, v, attn_mask=causal,
                    dropout_p=self.cfg.attention_dropout,
                    training=self.training, use_flash=False)
        elif (sp := self._sp_mesh()) is not None:
            out = self._ring(q, k, v, attn_mask, sp, heads)
        else:
            with heads:
                out = F.scaled_dot_product_attention(
                    q, k, v, attn_mask=dense_mask, is_causal=True,
                    dropout_p=self.cfg.attention_dropout,
                    training=self.training, use_flash=self.cfg.use_flash)
            if row_has_key is not None:
                out = torch.where(row_has_key[:, :, None, None], out,
                                  torch.zeros_like(out))
        out = out.reshape(b, s, h)
        out = self.out_proj(out) if tp is None else \
            _row_parallel(out, self.out_proj, tp)
        if cache is not None:
            return out, cache
        return out

    def _ring(self, q, k, v, attn_mask, sp, heads):
        """Ring attention of this rank's slice; ``attn_mask`` is the
        whole sequence's key-padding mask (the rank's slice travels with
        its K/V chunk). GQA's k and v stay unexpanded."""
        from ..ops.ring_attention import ring_attention
        b, s = q.shape[0], q.shape[1] * sp.size
        if attn_mask is not None and tuple(attn_mask.shape) != (b, s):
            # a general [.., sq, sk] mask would have to be materialized
            # per ring block pair; padded batches are a KEY-padding mask
            raise NotImplementedError(
                "sequence_parallel attention takes a KEY-padding "
                f"attn_mask of shape [batch, seq] = {(b, s)} (bool "
                "True=attend, or additive float); got "
                f"{tuple(attn_mask.shape)}")
        kpm = None if attn_mask is None else \
            seq_slice(attn_mask, 1, sp.size, sp.index)
        dp = self.cfg.attention_dropout if self.training else 0.0
        with heads:
            return ring_attention(
                q, k, v, causal=True, mesh=sp.mesh,
                chunk_size=self.cfg.ring_chunk_size, key_padding_mask=kpm,
                dropout_p=dp, use_flash=self.cfg.use_flash,
                # the same key on every sp rank; the ring folds in each
                # block's global coordinates
                dropout_key=rng.next_key("sp_attn") if dp else None)


class GPTMLP(Layer):
    """fc_in column-parallel and fc_out row-parallel under tp."""

    _tp = None
    tp_params = ("fc_in.weight", "fc_in.bias", "fc_out.weight")

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        init = I.Normal(0.0, cfg.initializer_range)
        init_out = I.Normal(
            0.0, cfg.initializer_range / math.sqrt(2 * cfg.num_layers))
        self._swiglu = cfg.activation == "swiglu"
        in_width = 2 * cfg.ffn_hidden_size if self._swiglu \
            else cfg.ffn_hidden_size
        self.fc_in = nn.Linear(cfg.hidden_size, in_width, weight_attr=init,
                               axes=("embed", "mlp"), bias_axes=("mlp",))
        self.fc_out = nn.Linear(cfg.ffn_hidden_size, cfg.hidden_size,
                                weight_attr=init_out,
                                axes=("mlp", "embed"), bias_axes=(None,))
        self.act = F.swiglu if self._swiglu else getattr(F, cfg.activation)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def tp_permutation(self, name: str, tp: int):
        """SwiGLU's fc_in holds two halves (silu input, gate): each rank
        takes its slice of both."""
        if not self._swiglu or name not in ("fc_in.weight", "fc_in.bias"):
            return None
        f = self.cfg.ffn_hidden_size
        return _block_perm([(0, f), (f, f)], tp)

    def attach_tp(self, tp) -> None:
        if self.cfg.ffn_hidden_size % tp.size == 0:
            self._tp = tp

    def forward(self, x):
        tp = self._tp
        if tp is None:
            return self.dropout(self.fc_out(self.act(self.fc_in(x))))
        y = self.act(self.fc_in(copy_to_tp(x, tp)))
        return self.dropout(_row_parallel(y, self.fc_out, tp))


class GPTDecoderLayer(Layer):
    """Pre-LN decoder block (GPT-2/3 style)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln_1 = _norm(cfg)
        self.attn = GPTAttention(cfg)
        self.ln_2 = _norm(cfg)
        self.mlp = GPTMLP(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, attn_mask=None, cache=None, position_ids=None):
        a = self.attn(self.ln_1(x), attn_mask=attn_mask, cache=cache,
                      position_ids=position_ids)
        if cache is not None:
            a, cache = a
        x = x + self.dropout(a)
        x = x + self.mlp(self.ln_2(x))
        if cache is not None:
            return x, cache
        return x


class GPTEmbeddings(Layer):
    """Under tp the word embeddings are vocab-parallel: a rank looks up
    the ids in its vocab range, zeroes the rest, and the ranks' rows are
    summed (ref: mp_layers.py:30 VocabParallelEmbedding)."""

    _tp = None
    tp_params = ("word_embeddings.weight",)

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        init = I.Normal(0.0, cfg.initializer_range)
        self.word_embeddings = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, weight_attr=init,
            axes=("vocab", "embed"))
        if not cfg.use_rope:  # rotary encodes positions in attention
            self.position_embeddings = nn.Embedding(
                cfg.max_position_embeddings, cfg.hidden_size,
                weight_attr=init, axes=(None, "embed"))
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self._use_rope = cfg.use_rope
        self._max_pos = cfg.max_position_embeddings

    def forward(self, input_ids, position_ids=None):
        s = input_ids.shape[1]
        if s > self._max_pos:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{self._max_pos}")
        tok = self._lookup(input_ids)
        if self._use_rope:
            return self.dropout(tok)
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        return self.dropout(tok + self.position_embeddings(position_ids))

    def attach_tp(self, tp) -> None:
        if self.word_embeddings.num_embeddings % tp.size == 0:
            self._tp = tp

    def _lookup(self, ids):
        tp = self._tp
        if tp is None:
            return self.word_embeddings(ids)
        w = self.word_embeddings.weight
        n = w.shape[0]
        local = ids - tp.index * n
        outside = (local < 0) | (local >= n)
        rows = F.embedding(local.masked_fill(outside, 0), w)
        rows = torch.where(outside[..., None], torch.zeros_like(rows), rows)
        return reduce_from_tp(rows, tp)


class GPTModel(_SequenceParallel, Layer):
    """Transformer trunk: embeddings -> N decoder blocks -> final norm.
    ``cfg.scan_layers`` runs the blocks as the JAX package's scan does
    (per-layer dropout keys folded from one key,
    ``nn.utils.scan_layer_stack``); ``cfg.remat`` recomputes each block
    in the backward (``nn.utils.checkpoint``). With caches both take the
    plain loop, as in the JAX package. Under sp the blocks and the final
    norm run on this rank's slice of the sequence, which it returns."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg)
        self.layers = LayerList(
            [GPTDecoderLayer(cfg) for _ in range(cfg.num_layers)])
        self.ln_f = _norm(cfg)

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                caches=None):
        x = self.embeddings(input_ids, position_ids)
        rope_pos = position_ids if self.cfg.use_rope else None
        sp = self._sp_mesh() if caches is None else None
        if sp is None:
            return self._trunk(x, attn_mask, rope_pos, caches)
        b, s = input_ids.shape[0], input_ids.shape[1]
        x = seq_slice(x, 1, sp.size, sp.index)
        if self.cfg.use_rope:   # the rank's global positions
            if rope_pos is None:
                rope_pos = torch.arange(s, device=x.device)[None]
            rope_pos = seq_slice(rope_pos.expand(b, s), 1, sp.size,
                                 sp.index)
        with rng.seq_slice(sp.index * x.shape[1], s):
            return self._trunk(x, attn_mask, rope_pos, None)

    def _trunk(self, x, attn_mask, rope_pos, caches):
        new_caches = [] if caches is not None else None
        if self.cfg.scan_layers and caches is None:
            x = scan_layer_stack(self.layers, x, remat=self.cfg.remat,
                                 rng_tag="scan_trunk", attn_mask=attn_mask,
                                 position_ids=rope_pos)
        else:
            for i, layer in enumerate(self.layers):
                if caches is not None:
                    x, c = layer(x, attn_mask=attn_mask, cache=caches[i],
                                 position_ids=rope_pos)
                    new_caches.append(c)
                elif self.cfg.remat:
                    x = checkpoint(layer, x, attn_mask=attn_mask,
                                   position_ids=rope_pos)
                else:
                    x = layer(x, attn_mask=attn_mask, position_ids=rope_pos)
        x = self.ln_f(x)
        if caches is not None:
            return x, new_caches
        return x


def _lm_logits(cfg: GPTConfig, embeddings: GPTEmbeddings, hidden,
               lm_head=None, tp=None):
    """Shared head: the tied-embedding product (in the AMP compute dtype
    under auto_cast; the loss upcasts to f32) or a separate lm_head.
    Under tp (vocab-parallel weights) each rank's vocab slice of the
    logits, gathered."""
    if tp is not None:
        hidden = copy_to_tp(hidden, tp)
    if cfg.tie_word_embeddings:
        hidden, w = amp.white_cast(hidden,
                                   embeddings.word_embeddings.weight)
        out = torch.matmul(hidden, w.t())
    else:
        out = lm_head(hidden)
    return out if tp is None else gather_from_tp(out, tp)


class _CausalLMHead:
    """The head and fused-loss output shared by :class:`GPTForCausalLM`
    and :class:`GPTForCausalLMPipe` (which hold ``cfg``, their
    embeddings in ``_embeddings()`` and an optional ``lm_head``)."""

    _tp = None   # the tp group once the vocab dim of the head is split
    tp_params = ("lm_head.weight",)

    def attach_tp(self, tp) -> None:
        if self.cfg.vocab_size % tp.size == 0:
            self._tp = tp

    def _logits(self, hidden):
        return _lm_logits(self.cfg, self._embeddings(), hidden,
                          getattr(self, "lm_head", None), self._tp)

    def _fused_out(self, hidden):
        """(hidden, W [vocab, hidden]) for the fused criterion; W rides
        the output so its gradient flows through the loss. Under tp, W is
        this rank's vocab slice and carries the tp group
        (``_tp_vocab``), which makes the criterion's loss
        vocab-parallel."""
        if not self.cfg.tie_word_embeddings:
            w = self.lm_head.weight.t()   # Linear is [H, V]
        else:
            w = self._embeddings().word_embeddings.weight
        if self._tp is not None:
            w = w.view_as(w)
            w._tp_vocab = self._tp
        return hidden, w


class GPTForCausalLM(_CausalLMHead, Layer):
    """GPT with a (tied) LM head and generation utilities.

    Parameters are drawn on the CPU from the global generator
    (:func:`paddle_tpu_torch.seed`) and moved to ``device``, the GPU
    unless the caller passes ``device="cpu"``."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.gpt = GPTModel(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias_attr=False,
                                     axes=("embed", "vocab"))
        self.to(resolve_device(device))

    def _embeddings(self):
        return self.gpt.embeddings

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                caches=None):
        out = self.gpt(input_ids, position_ids, attn_mask, caches)
        if caches is not None:
            hidden, new_caches = out
            return self._logits(hidden), new_caches
        if self.cfg.fused_loss and self.training:
            return self._fused_out(out)
        return self._logits(out)

    # -- decode-time KV cache -------------------------------------------
    def init_caches(self, batch_size: int, max_len: int,
                    dtype=torch.float32):
        cfg = self.cfg
        dev = self.gpt.ln_f.weight.device
        tp = self.gpt.layers[0].attn._tp
        kv = cfg.num_kv_heads // (tp.size if tp is not None else 1)
        shape = (batch_size, max_len, kv, cfg.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev), 0)
                for _ in range(cfg.num_layers)]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 20,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0):
        """Greedy (temperature=0) or top-k sampled decoding with a dense
        KV cache. Sampling keys follow the JAX package's
        ``jax.random.split`` chain, so both packages draw the same
        tokens."""
        self.eval()
        b, s = input_ids.shape
        max_len = s + max_new_tokens
        if max_len > self.cfg.max_position_embeddings:
            raise ValueError(
                f"prompt {s} + max_new_tokens {max_new_tokens} exceeds "
                f"max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        caches = self.init_caches(b, max_len)
        key = threefry.prng_key(seed, device=input_ids.device)
        logits, caches = self(input_ids, caches=caches)
        tokens = input_ids
        next_logits = logits[:, -1]
        for step in range(max_new_tokens):
            if temperature > 0.0:
                key, sub = threefry.split(key)
                lg = next_logits / temperature
                if top_k > 0:
                    kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
                    lg = torch.where(lg < kth, float("-inf"), lg)
                nxt = threefry.categorical(sub, lg)
            else:
                nxt = torch.argmax(next_logits, dim=-1)
            nxt = nxt[:, None].to(tokens.dtype)
            tokens = torch.cat([tokens, nxt], dim=1)
            if step == max_new_tokens - 1:
                break
            pos = torch.full((b, 1), s + step, device=tokens.device)
            next_logits, caches = self(nxt, position_ids=pos,
                                       caches=caches)
            next_logits = next_logits[:, -1]
        return tokens


class GPTForCausalLMPipe(_CausalLMHead, Layer):
    """GPT with its decoder blocks pipelined over the mesh's ``pp`` axis
    (the JAX package's ``GPTForCausalLMPipe``, ref: fleet
    GPTForPretrainingPipe over pp_layers.py:162): embeddings, the final
    norm and the (tied) head stay OUTSIDE the trunk, replicated over pp,
    while the structurally identical blocks run under
    ``parallel.PipelineParallel`` (``remat=True``). Every pp rank runs
    the embeddings (only the first feeds the trunk; the others keep
    their key streams in step), and each runs the final norm and the
    head on its block of the trunk's output rows, so the loss runs
    data-parallel over pp; the gradients of the replicated parameters
    are summed over pp (``parallel.reducer``), the tied word embedding's
    from the first rank's lookup and every rank's head."""

    def __init__(self, cfg: GPTConfig, num_microbatches: int = 1,
                 virtual_pp_degree: int = 1, mesh=None, device=None):
        super().__init__()
        from ..parallel.mesh import get_mesh
        from ..parallel.pipeline import PipelineLayer, PipelineParallel
        self.cfg = cfg
        if cfg.scan_layers:
            import warnings
            warnings.warn(
                "GPTForCausalLMPipe ignores cfg.scan_layers: the "
                "pipeline's tick loop and rematerialized chunks already "
                "provide the depth loop and remat")
        if cfg.sequence_parallel:
            raise ValueError(
                "sequence_parallel cannot compose with the pipelined "
                "trunk: ring attention's shard_map would nest inside "
                "the pipeline's manual pp region. Use sp with the "
                "dense GPTForCausalLM, or pp without sp")
        mesh = mesh or get_mesh(required=False)
        pp = mesh.axis_size("pp") if mesh is not None else 1
        num_stages = pp * virtual_pp_degree
        if cfg.num_layers % num_stages:
            raise ValueError(
                f"num_layers {cfg.num_layers} not divisible by "
                f"pp*virtual_pp_degree = {num_stages}")
        self.embeddings = GPTEmbeddings(cfg)
        blocks = [GPTDecoderLayer(cfg) for _ in range(cfg.num_layers)]
        self.pipe = PipelineParallel(
            PipelineLayer(blocks, num_stages=num_stages),
            num_microbatches=num_microbatches,
            virtual_pp_degree=virtual_pp_degree, mesh=mesh, remat=True)
        self.ln_f = _norm(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias_attr=False,
                                     axes=("embed", "vocab"))
        self.to(resolve_device(device))

    def _embeddings(self):
        return self.embeddings

    def forward(self, input_ids, position_ids=None):
        x = self.embeddings(input_ids, position_ids)
        x = self.ln_f(self.pipe(x))
        if self.cfg.fused_loss and self.training:
            return self._fused_out(x)
        return self._logits(x)


class GPTGreedyDecoder(Layer):
    """Greedy generation as one module call: prefill, then one decode
    step per new token over the dense KV cache, the argmax staying on
    the device (the JAX package's ``lax.scan`` loop, unrolled in eager
    PyTorch). Returns ``[b, s + max_new_tokens]`` int32 ids."""

    def __init__(self, model: GPTForCausalLM, max_new_tokens: int):
        super().__init__()
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "always argmaxes one token)")
        self.model = model
        self.max_new_tokens = max_new_tokens

    @torch.no_grad()
    def forward(self, input_ids):
        self.eval()
        cfg = self.model.cfg
        b, s = input_ids.shape
        max_len = s + self.max_new_tokens
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"prompt {s} + {self.max_new_tokens} new tokens exceeds "
                f"max_position_embeddings {cfg.max_position_embeddings}")
        caches = self.model.init_caches(b, max_len)
        logits, caches = self.model(input_ids, caches=caches)
        tok = torch.argmax(logits[:, -1], dim=-1)
        toks = [tok]
        for i in range(self.max_new_tokens - 1):
            pos = torch.full((b, 1), s + i, device=input_ids.device)
            lg, caches = self.model(tok[:, None], position_ids=pos,
                                    caches=caches)
            tok = torch.argmax(lg[:, -1], dim=-1)
            toks.append(tok)
        return torch.cat([input_ids, torch.stack(toks, dim=1)],
                         dim=1).to(torch.int32)


class GPTPretrainingCriterion(Layer):
    """Shifted next-token cross entropy over dense logits. Under sp (a
    Model on an sp mesh attaches the group) the logits are this rank's
    slice of the sequence and the labels the whole row: every position
    of the slice predicts the next label, the last rank's last position
    ``ignore_index``."""

    _sp = None

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def attach_sp(self, sp) -> None:
        self._sp = sp

    def _targets(self, labels):
        """The next-token label of each position this rank predicts:
        ``labels[:, 1:]``, or under sp its slice of the row shifted by
        one with ``ignore_index`` after the end."""
        if self._sp is None:
            return labels[:, 1:]
        end = torch.full_like(labels[:, :1], self.ignore_index)
        return seq_slice(torch.cat([labels[:, 1:], end], dim=1), 1,
                         self._sp.size, self._sp.index)

    def _positions(self, n: int) -> int:
        """How many of this rank's ``n`` positions predict a token."""
        return n if self._sp is not None else n - 1

    def count(self, labels):
        """The targets the mean runs over (those not ``ignore_index``):
        on a data-parallel or sequence-parallel mesh each rank's loss is
        weighted by its count over the global count
        (``parallel.reducer``)."""
        return (self._targets(labels) != self.ignore_index).sum()

    def forward(self, logits, labels):
        # logits [b, s, v], labels [b, s]: predict token t+1 at position t
        n = self._positions(logits.shape[1])
        lg = logits[:, :n].reshape(-1, logits.shape[-1])
        lb = self._targets(labels).reshape(-1)
        return F.cross_entropy(lg, lb, ignore_index=self.ignore_index)


class GPTFusedPretrainingCriterion(GPTPretrainingCriterion):
    """Streaming vocab-path loss for ``cfg.fused_loss`` models: takes
    (hidden [b, s, h], weight [v, h]) from the model's training forward
    and computes the shifted next-token cross entropy over vocab chunks,
    with no [b, s, v] logits (``ops/fused_xent.py``). With two arguments
    (an eval-mode forward's logits and the labels) it is the dense
    criterion. A weight that carries a tp group (``_tp_vocab``: a
    vocab-parallel head's slice) streams only its vocab slice, the
    softmax statistics reduced over the tp ranks."""

    def forward(self, *args):
        if len(args) == 2:
            return super().forward(*args)
        hidden, weight, labels = args
        tp = getattr(weight, "_tp_vocab", None)
        hidden, weight = amp.white_cast(hidden, weight, op="matmul")
        n = self._positions(hidden.shape[1])
        h = hidden[:, :n].reshape(-1, hidden.shape[-1])
        lb = self._targets(labels).reshape(-1)
        return fused_linear_cross_entropy(h, weight, lb, self.ignore_index,
                                          tp=tp)
