"""BERT / ERNIE encoder models (the port's counterpart of
``paddle_tpu/models/bert.py``).

Same configuration, module tree and parameter names as the JAX package,
so a JAX state dict loads by identical key
(:func:`paddle_tpu_torch.interop.load_reference_state`). ERNIE-base is
the BERT-base skeleton with ERNIE's vocabulary (``ernie_config``).

Attention runs through ``nn.MultiHeadAttention``, which takes the flash
kernels B1-B3 where the JAX package takes its Pallas kernels: no mask,
no attention dropout in training, head dim >= 64, blocks of at least
128. A padding mask (``BertModel.attention_mask_from_ids``) takes the
plain path.

The MLM decoder is tied to the word embeddings: :class:`BertLMHead`
keeps the embeddings in a plain list, so the weight is one parameter,
``bert.embeddings.word_embeddings.weight``, whose gradient sums the
lookup's and the decoder's. Under AMP the decoder's logits are float32
products of the compute-dtype operands, never rounded to the compute
dtype (``ops.fused_xent._mm_f32``), as the JAX package's
``preferred_element_type=float32`` einsum gives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import amp, nn
from ..core.device import resolve_device
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import Layer, LayerList
from ..nn.utils import checkpoint, scan_layer_stack
from ..ops.fused_xent import _mm_f32, fused_linear_cross_entropy


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None  # None = 4*hidden
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation: str = "gelu"
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-12
    pad_token_id: int = 0
    use_flash: bool = True
    remat: bool = False        # recompute each encoder block
    scan_layers: bool = False  # the JAX package's scan over the blocks
    # fused MLM vocab path (ops/fused_xent.py): the pretraining forward
    # returns the transformed hidden states + tied weight + decoder bias
    # instead of [b, s, vocab] logits
    fused_loss: bool = False

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size


PRESETS = {
    "bert-base": dict(hidden_size=768, num_layers=12, num_heads=12),
    "bert-large": dict(hidden_size=1024, num_layers=24, num_heads=16),
    "ernie-base": dict(hidden_size=768, num_layers=12, num_heads=12,
                       vocab_size=18000),
    "ernie-large": dict(hidden_size=1024, num_layers=24, num_heads=16,
                        vocab_size=18000),
}


def bert_config(name: str, **overrides) -> BertConfig:
    cfg = dict(PRESETS[name])
    cfg.update(overrides)
    return BertConfig(**cfg)


ernie_config = bert_config  # ERNIE-base == BERT skeleton, ERNIE vocab


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        init = I.Normal(0.0, cfg.initializer_range)
        self.word_embeddings = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, padding_idx=cfg.pad_token_id,
            weight_attr=init, axes=("vocab", "embed"))
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, weight_attr=init,
            axes=(None, "embed"))
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, weight_attr=init,
            axes=(None, "embed"))
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_epsilon)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertEncoderLayer(Layer):
    """Post-LN encoder block (original BERT residual order)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attn = nn.MultiHeadAttention(
            cfg.hidden_size, cfg.num_heads, dropout=cfg.attention_dropout,
            use_flash=cfg.use_flash)
        self.ln_1 = nn.LayerNorm(cfg.hidden_size,
                                 epsilon=cfg.layer_norm_epsilon)
        self.fc_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                               weight_attr=I.Normal(0., cfg.initializer_range),
                               axes=("embed", "mlp"), bias_axes=("mlp",))
        self.fc_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                weight_attr=I.Normal(0., cfg.initializer_range),
                                axes=("mlp", "embed"), bias_axes=(None,))
        self.ln_2 = nn.LayerNorm(cfg.hidden_size,
                                 epsilon=cfg.layer_norm_epsilon)
        self.act = getattr(F, cfg.activation)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, attn_mask=None):
        x = self.ln_1(x + self.dropout(self.attn(x, attn_mask=attn_mask)))
        h = self.fc_out(self.act(self.fc_in(x)))
        return self.ln_2(x + self.dropout(h))


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                               weight_attr=I.Normal(0.,
                                                    cfg.initializer_range))

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(Layer):
    """Trunk: embeddings -> encoder stack -> (sequence_output, pooled).
    ``cfg.scan_layers`` runs the blocks as the JAX package's scan does
    (``nn.utils.scan_layer_stack``, tag ``bert_trunk``); ``cfg.remat``
    recomputes each block in the backward (``nn.utils.checkpoint``).

    Parameters are drawn on the CPU from the global generator and moved
    to ``device``, the GPU unless the caller passes ``device="cpu"``."""

    def __init__(self, cfg: BertConfig, with_pooler: bool = True,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = LayerList(
            [BertEncoderLayer(cfg) for _ in range(cfg.num_layers)])
        self.pooler = BertPooler(cfg) if with_pooler else None
        self.to(resolve_device(device))

    @staticmethod
    def attention_mask_from_ids(input_ids, pad_token_id: int):
        """[b, s] ids -> additive [b, 1, 1, s] mask (-inf at padding)."""
        pad = input_ids == pad_token_id
        zero = torch.zeros((), device=input_ids.device)
        return torch.where(pad, float("-inf"), zero)[:, None, None, :]

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attn_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        if self.cfg.scan_layers:
            x = scan_layer_stack(self.encoder, x, remat=self.cfg.remat,
                                 rng_tag="bert_trunk", attn_mask=attn_mask)
        else:
            for layer in self.encoder:
                if self.cfg.remat:
                    x = checkpoint(layer, x, attn_mask=attn_mask)
                else:
                    x = layer(x, attn_mask=attn_mask)
        pooled = self.pooler(x) if self.pooler is not None else None
        return x, pooled


class _DecodeF32(torch.autograd.Function):
    """``h @ w.T`` with a float32 result that is never rounded to the
    operands' dtype (``ops.fused_xent._mm_f32``). ``torch.mm(...,
    out_dtype=)`` has no derivative, so the backward is written out as
    the fused loss's is: the float32 cotangent rounded to the operands'
    dtype, contracted with float32 results."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _mm_f32(h, w.t())

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return _mm_f32(g, w).to(h.dtype), _mm_f32(g.t(), h).to(w.dtype)


class BertLMHead(Layer):
    """MLM head: transform + LN + decode to vocab (tied to embeddings)."""

    def __init__(self, cfg: BertConfig, embeddings: BertEmbeddings):
        super().__init__()
        self.transform = nn.Linear(
            cfg.hidden_size, cfg.hidden_size,
            weight_attr=I.Normal(0., cfg.initializer_range))
        self.act = getattr(F, cfg.activation)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_epsilon)
        self._embeddings = [embeddings]  # plain list: not a sublayer (tied)
        self.decoder_bias = self.create_parameter(
            [cfg.vocab_size], initializer=I.Constant(0.0), axes=("vocab",))

    def transformed(self, hidden):
        return self.layer_norm(self.act(self.transform(hidden)))

    def tied_weight(self):
        return self._embeddings[0].word_embeddings.weight  # [V, H]

    def forward(self, hidden):
        h = self.transformed(hidden)
        h, w = amp.white_cast(h, self.tied_weight())
        logits = _DecodeF32.apply(h.reshape(-1, h.shape[-1]), w)
        return logits.reshape(tuple(h.shape[:-1]) + (w.shape[0],)) \
            + self.decoder_bias


class BertForPretraining(Layer):
    """MLM + next-sentence-prediction heads (BERT objective; ERNIE uses
    the same skeleton with knowledge-masking data)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg, with_pooler=True, device="cpu")
        self.lm_head = BertLMHead(cfg, self.bert.embeddings)
        self.nsp_head = nn.Linear(cfg.hidden_size, 2)
        self.to(resolve_device(device))

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attn_mask=attn_mask)
        if self.cfg.fused_loss and self.training:
            return (self.lm_head.transformed(seq),
                    self.lm_head.tied_weight(),
                    self.lm_head.decoder_bias,
                    self.nsp_head(pooled))
        return self.lm_head(seq), self.nsp_head(pooled)


class BertPretrainingCriterion(Layer):
    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels=None):
        loss = F.cross_entropy(
            mlm_logits.reshape(-1, mlm_logits.shape[-1]),
            mlm_labels.reshape(-1), ignore_index=self.ignore_index)
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits,
                                          nsp_labels.reshape(-1))
        return loss


class BertFusedPretrainingCriterion(Layer):
    """Streaming MLM loss for ``cfg.fused_loss`` models: takes (hidden,
    tied weight, decoder bias, nsp_logits, mlm_labels[, nsp_labels])
    and never builds the [b, s, vocab] logits (``ops/fused_xent.py``).
    With the dense criterion's arity (an eval-mode forward) it is the
    dense criterion."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index
        self._dense = BertPretrainingCriterion(ignore_index)

    def forward(self, *args):
        if len(args) < 5:
            return self._dense(*args)
        hidden, weight, bias, nsp_logits, mlm_labels = args[:5]
        nsp_labels = args[5] if len(args) > 5 else None
        hidden, weight = amp.white_cast(hidden, weight, op="matmul")
        h = hidden.reshape(-1, hidden.shape[-1])
        loss = fused_linear_cross_entropy(
            h, weight, mlm_labels.reshape(-1), self.ignore_index, None,
            bias)
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits,
                                          nsp_labels.reshape(-1))
        return loss


class BertForSequenceClassification(Layer):
    def __init__(self, cfg: BertConfig, num_classes: int = 2, device=None):
        super().__init__()
        self.bert = BertModel(cfg, with_pooler=True, device="cpu")
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)
        self.to(resolve_device(device))

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attn_mask=attn_mask)
        return self.classifier(self.dropout(pooled))
