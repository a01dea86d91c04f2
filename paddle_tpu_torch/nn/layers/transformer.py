"""Transformer layers (the port's counterpart of
``paddle_tpu/nn/layers/transformer.py``): MultiHeadAttention, the
encoder and decoder layers and stacks, and Transformer.

Attention runs in ``[batch, seq, heads, head_dim]`` through
``F.scaled_dot_product_attention``, which takes the flash kernels B1-B3
(``ops/flash_attention.py``) exactly where the JAX package's rules
(``flash_attention_available``) take its Pallas kernels: no mask, no
attention dropout in training, head dim >= 64, blocks of at least 128.
Otherwise the plain path runs, with the JAX package's dropout masks.
The parameter names and logical axes are the JAX package's
(``layers.0.self_attn.q_proj.weight``, ...).
"""

from __future__ import annotations

from typing import Optional

from .. import functional as F
from ..layer import Layer, LayerList
from .common import Dropout, Linear
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, use_flash: bool = True):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.use_flash = use_flash
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        # column-parallel: shard output dim over tp axis "heads"
        self.q_proj = Linear(embed_dim, embed_dim,
                             axes=("embed", "heads"), bias_axes=("heads",))
        self.k_proj = Linear(kdim, embed_dim,
                             axes=("embed", "heads"), bias_axes=("heads",))
        self.v_proj = Linear(vdim, embed_dim,
                             axes=("embed", "heads"), bias_axes=("heads",))
        # row-parallel: shard input dim over tp axis
        self.out_proj = Linear(embed_dim, embed_dim,
                               axes=("heads", "embed"), bias_axes=(None,))

    def _shape(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                is_causal: bool = False, cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if cache is not None:
            # decode-time KV cache: cache = (k_cache, v_cache, index)
            # new tensors: the caller's cache stays as it was, as
            # JAX's .at[].set leaves it
            k_cache, v_cache, idx = cache
            k_cache = k_cache.clone()
            v_cache = v_cache.clone()
            k_cache[:, idx] = k[:, 0]
            v_cache[:, idx] = v[:, 0]
            k, v = k_cache, v_cache
            cache = (k_cache, v_cache, idx + 1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=is_causal, training=self.training,
            use_flash=self.use_flash)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if cache is not None:
            return out, cache
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False):
        super().__init__()
        self._init_config = dict(
            d_model=d_model, nhead=nhead, dim_feedforward=dim_feedforward,
            dropout=dropout, activation=activation,
            attn_dropout=attn_dropout, act_dropout=act_dropout,
            normalize_before=normalize_before)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout)
        self.linear1 = Linear(d_model, dim_feedforward,
                              axes=("embed", "mlp"), bias_axes=("mlp",))
        self.linear2 = Linear(dim_feedforward, d_model,
                              axes=("mlp", "embed"), bias_axes=(None,))
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer_fn, num_layers: int, norm=None):
        super().__init__()
        if isinstance(encoder_layer_fn, Layer):
            # clone the full config of the given layer
            proto = encoder_layer_fn
            layers = [proto] + [type(proto)(**proto._init_config)
                                for _ in range(num_layers - 1)]
        else:
            layers = [encoder_layer_fn() for _ in range(num_layers)]
        self.layers = LayerList(layers)
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 normalize_before: bool = False):
        super().__init__()
        self._init_config = dict(
            d_model=d_model, nhead=nhead, dim_feedforward=dim_feedforward,
            dropout=dropout, activation=activation,
            normalize_before=normalize_before)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=dropout)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=dropout)
        self.linear1 = Linear(d_model, dim_feedforward,
                              axes=("embed", "mlp"), bias_axes=("mlp",))
        self.linear2 = Linear(dim_feedforward, d_model,
                              axes=("mlp", "embed"), bias_axes=(None,))
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, attn_mask=tgt_mask, is_causal=(
            tgt_mask is None))
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.activation(self.linear1(tgt)))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer_fn, num_layers: int, norm=None):
        super().__init__()
        if isinstance(decoder_layer_fn, Layer):
            proto = decoder_layer_fn
            layers = [proto] + [type(proto)(**proto._init_config)
                                for _ in range(num_layers - 1)]
        else:
            layers = [decoder_layer_fn() for _ in range(num_layers)]
        self.layers = LayerList(layers)
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", normalize_before: bool = False):
        super().__init__()
        self.encoder = TransformerEncoder(
            lambda: TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                normalize_before=normalize_before),
            num_encoder_layers,
            LayerNorm(d_model) if normalize_before else None)
        self.decoder = TransformerDecoder(
            lambda: TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                normalize_before=normalize_before),
            num_decoder_layers,
            LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
