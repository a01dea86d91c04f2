"""GPT: decoder-only transformer LM (the port's counterpart of
``paddle_tpu/models/gpt.py``).

Same configuration, module tree and parameter names as the JAX package,
so a JAX state dict loads by identical key
(:func:`paddle_tpu_torch.interop.load_reference_state`). The attention
of the serving path goes through the paged KV pool of
:mod:`paddle_tpu_torch.inference.llm`; the dense cache path here serves
:meth:`GPTForCausalLM.generate`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from .. import nn
from ..core import threefry
from ..core.device import resolve_device
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import Layer, LayerList
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
    # features of the JAX package not ported yet: each raises at
    # construction, naming the ROADMAP item that brings it
    remat: bool = False
    sequence_parallel: bool = False
    ring_chunk_size: Optional[int] = None
    scan_layers: bool = False
    fused_loss: bool = False

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        for flag, item in (("sequence_parallel", "ring attention"),
                           ("scan_layers", "scan_layers and remat"),
                           ("remat", "scan_layers and remat"),
                           ("fused_loss", "fused vocab loss")):
            if getattr(self, flag):
                raise NotImplementedError(
                    f"GPTConfig({flag}=True) is not ported yet "
                    f"(ROADMAP Queue A: {item})")

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


def _norm(cfg: GPTConfig):
    if cfg.norm_type == "rms":
        return nn.RMSNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon)
    return nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon)


class GPTAttention(Layer):
    """Causal self-attention with fused QKV, grouped-query heads and an
    optional dense KV cache ``(k_cache, v_cache, idx)``; the cache is
    written in place."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        qkv_out = h + 2 * cfg.num_kv_heads * hd
        init = I.Normal(0.0, cfg.initializer_range)
        self.qkv_proj = nn.Linear(h, qkv_out, weight_attr=init)
        self.out_proj = nn.Linear(h, h, weight_attr=I.Normal(
            0.0, cfg.initializer_range / math.sqrt(2 * cfg.num_layers)))

    def forward(self, x, attn_mask=None, cache=None, position_ids=None):
        b, s, h = x.shape
        hd = self.cfg.head_dim
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
        q, k, v = torch.split(
            qkv, [h, self.num_kv_heads * hd, self.num_kv_heads * hd],
            dim=-1)
        q = q.reshape(b, s, self.num_heads, hd)
        k = k.reshape(b, s, self.num_kv_heads, hd)
        v = v.reshape(b, s, self.num_kv_heads, hd)
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
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=causal,
                dropout_p=self.cfg.attention_dropout,
                training=self.training, use_flash=False)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=dense_mask, is_causal=True,
                dropout_p=self.cfg.attention_dropout,
                training=self.training, use_flash=self.cfg.use_flash)
            if row_has_key is not None:
                out = torch.where(row_has_key[:, :, None, None], out,
                                  torch.zeros_like(out))
        out = self.out_proj(out.reshape(b, s, h))
        if cache is not None:
            return out, cache
        return out


class GPTMLP(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        init = I.Normal(0.0, cfg.initializer_range)
        init_out = I.Normal(
            0.0, cfg.initializer_range / math.sqrt(2 * cfg.num_layers))
        self._swiglu = cfg.activation == "swiglu"
        in_width = 2 * cfg.ffn_hidden_size if self._swiglu \
            else cfg.ffn_hidden_size
        self.fc_in = nn.Linear(cfg.hidden_size, in_width, weight_attr=init)
        self.fc_out = nn.Linear(cfg.ffn_hidden_size, cfg.hidden_size,
                                weight_attr=init_out)
        self.act = F.swiglu if self._swiglu else getattr(F, cfg.activation)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x):
        return self.dropout(self.fc_out(self.act(self.fc_in(x))))


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
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        init = I.Normal(0.0, cfg.initializer_range)
        self.word_embeddings = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, weight_attr=init)
        if not cfg.use_rope:  # rotary encodes positions in attention
            self.position_embeddings = nn.Embedding(
                cfg.max_position_embeddings, cfg.hidden_size,
                weight_attr=init)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self._use_rope = cfg.use_rope
        self._max_pos = cfg.max_position_embeddings

    def forward(self, input_ids, position_ids=None):
        s = input_ids.shape[1]
        if s > self._max_pos:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{self._max_pos}")
        tok = self.word_embeddings(input_ids)
        if self._use_rope:
            return self.dropout(tok)
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        return self.dropout(tok + self.position_embeddings(position_ids))


class GPTModel(Layer):
    """Transformer trunk: embeddings -> N decoder blocks -> final norm."""

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
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            if caches is not None:
                x, c = layer(x, attn_mask=attn_mask, cache=caches[i],
                             position_ids=rope_pos)
                new_caches.append(c)
            else:
                x = layer(x, attn_mask=attn_mask, position_ids=rope_pos)
        x = self.ln_f(x)
        if caches is not None:
            return x, new_caches
        return x


def _lm_logits(cfg: GPTConfig, embeddings: GPTEmbeddings, hidden,
               lm_head=None):
    """Shared head: the tied-embedding product in the parameter dtype
    (AMP comes with the training slice), or a separate lm_head."""
    if cfg.tie_word_embeddings:
        return torch.matmul(hidden, embeddings.word_embeddings.weight.t())
    return lm_head(hidden)


class GPTForCausalLM(Layer):
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
                                     bias_attr=False)
        self.to(resolve_device(device))

    def _logits(self, hidden):
        return _lm_logits(self.cfg, self.gpt.embeddings, hidden,
                          getattr(self, "lm_head", None))

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                caches=None):
        out = self.gpt(input_ids, position_ids, attn_mask, caches)
        if caches is not None:
            hidden, new_caches = out
            return self._logits(hidden), new_caches
        return self._logits(out)

    # -- decode-time KV cache -------------------------------------------
    def init_caches(self, batch_size: int, max_len: int,
                    dtype=torch.float32):
        cfg = self.cfg
        dev = self.gpt.ln_f.weight.device
        shape = (batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
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
