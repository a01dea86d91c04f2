"""Checkpoint interop: load HuggingFace / torch weights into the zoo (the
port's counterpart of ``paddle_tpu/models/convert.py``).

Mappings are pure name/layout tables, the JAX package's: HF GPT-2's
Conv1D stores weights [in, out], exactly the ``nn.Linear`` convention,
so tensors copy through without transposes; BERT's and LLaMA's
``nn.Linear`` store [out, in] and transpose on the way in. Each
converter builds the port's model on ``device`` (the GPU unless the
caller passes ``device="cpu"``); ``transformers`` is never imported
here: the caller passes the HF model or its state dict.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.rng import seed
from ..interop import load_reference_state


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):  # torch tensor
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _state_dict(model_or_sd) -> Dict[str, np.ndarray]:
    sd = model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict") \
        else model_or_sd
    return {k: _to_numpy(v) for k, v in sd.items()}


def gpt2_from_huggingface(model_or_state_dict, config=None,
                          device=None):
    """Build a :class:`~paddle_tpu_torch.models.gpt.GPTForCausalLM` carrying
    the weights of a HF ``GPT2LMHeadModel`` (or its state_dict).

    ``config`` overrides the inferred GPTConfig fields (e.g. to enable
    ``scan_layers``/``fused_loss`` on the converted model). Returns the
    converted model; logits match HF within float tolerance
    (tests/test_torch_convert.py).
    """
    from .gpt import GPTConfig, GPTForCausalLM

    hf_cfg = getattr(model_or_state_dict, "config", None)
    sd = _state_dict(model_or_state_dict)
    sd = {k[len("transformer."):] if k.startswith("transformer.") else k:
          v for k, v in sd.items()}

    n_layer = 1 + max(int(k.split(".")[1]) for k in sd
                      if k.startswith("h."))
    wte = sd["wte.weight"]
    wpe = sd["wpe.weight"]
    n_head = None
    if isinstance(config, dict):
        n_head = config.get("num_heads")
    if n_head is None and hf_cfg is not None:
        # the source model knows its own head count — never guess when
        # it's available (a 48-dim-head checkpoint converts silently
        # wrong under any divisor heuristic)
        n_head = getattr(hf_cfg, "n_head", None) or \
            getattr(hf_cfg, "num_attention_heads", None)
    if n_head is None:
        # bare state_dict fallback: head_dim 64 GPT-2 family invariant.
        # A non-64 head_dim checkpoint would build a silently-wrong
        # model, so say what was guessed and how to override it.
        n_head = max(1, wte.shape[1] // 64)
        import warnings
        warnings.warn(
            f"gpt2_from_huggingface: bare state_dict with no hf config "
            f"and no config={{'num_heads': ...}} override — guessed "
            f"num_heads={n_head} from the GPT-2 head_dim-64 invariant; "
            f"pass num_heads explicitly if this checkpoint differs",
            stacklevel=2)

    kw = dict(vocab_size=wte.shape[0], hidden_size=wte.shape[1],
              num_layers=n_layer, num_heads=n_head,
              max_position_embeddings=wpe.shape[0],
              activation="gelu_tanh",  # HF "gelu_new"
              tie_word_embeddings=True)
    if config is not None and not isinstance(config, dict):
        raise TypeError(
            "config must be a dict of GPTConfig field overrides (a "
            "full config object would silently drop inferred fields "
            "like activation='gelu_tanh')")
    kw.update(config or {})
    cfg = GPTConfig(**kw)

    seed(0)
    net = GPTForCausalLM(cfg, device=device)

    state = {"gpt.embeddings.word_embeddings.weight": wte,
             "gpt.embeddings.position_embeddings.weight": wpe,
             "gpt.ln_f.weight": sd["ln_f.weight"],
             "gpt.ln_f.bias": sd["ln_f.bias"]}
    for i in range(n_layer):
        src, dst = f"h.{i}", f"gpt.layers.{i}"
        state.update({
            # HF Conv1D is [in, out] — our Linear convention; no T
            f"{dst}.ln_1.weight": sd[f"{src}.ln_1.weight"],
            f"{dst}.ln_1.bias": sd[f"{src}.ln_1.bias"],
            f"{dst}.attn.qkv_proj.weight": sd[f"{src}.attn.c_attn.weight"],
            f"{dst}.attn.qkv_proj.bias": sd[f"{src}.attn.c_attn.bias"],
            f"{dst}.attn.out_proj.weight": sd[f"{src}.attn.c_proj.weight"],
            f"{dst}.attn.out_proj.bias": sd[f"{src}.attn.c_proj.bias"],
            f"{dst}.ln_2.weight": sd[f"{src}.ln_2.weight"],
            f"{dst}.ln_2.bias": sd[f"{src}.ln_2.bias"],
            f"{dst}.mlp.fc_in.weight": sd[f"{src}.mlp.c_fc.weight"],
            f"{dst}.mlp.fc_in.bias": sd[f"{src}.mlp.c_fc.bias"],
            f"{dst}.mlp.fc_out.weight": sd[f"{src}.mlp.c_proj.weight"],
            f"{dst}.mlp.fc_out.bias": sd[f"{src}.mlp.c_proj.bias"],
        })
    load_reference_state(net, state)
    return net


def bert_from_huggingface(model_or_state_dict, config=None,
                          with_pooler: bool = True, device=None):
    """Build a :class:`~paddle_tpu_torch.models.bert.BertModel` carrying the
    weights of a HF ``BertModel`` (or its state_dict). HF torch Linear
    stores [out, in]: weights transpose on the way in."""
    from .bert import BertConfig, BertModel

    hf_cfg = getattr(model_or_state_dict, "config", None)
    sd = _state_dict(model_or_state_dict)
    sd = {k[len("bert."):] if k.startswith("bert.") else k: v
          for k, v in sd.items()}

    n_layer = 1 + max(int(k.split(".")[2]) for k in sd
                      if k.startswith("encoder.layer."))
    tok = sd["embeddings.word_embeddings.weight"]
    pos = sd["embeddings.position_embeddings.weight"]
    typ = sd["embeddings.token_type_embeddings.weight"]
    inter0 = sd["encoder.layer.0.intermediate.dense.weight"]
    n_head = None
    if isinstance(config, dict):
        n_head = config.get("num_heads")
    if n_head is None and hf_cfg is not None:
        n_head = getattr(hf_cfg, "num_attention_heads", None)
    if n_head is None:
        n_head = max(1, tok.shape[1] // 64)
        import warnings
        warnings.warn(
            f"bert_from_huggingface: bare state_dict with no hf config "
            f"and no config={{'num_heads': ...}} override — guessed "
            f"num_heads={n_head} from the head_dim-64 invariant; pass "
            f"num_heads explicitly if this checkpoint differs",
            stacklevel=2)

    kw = dict(vocab_size=tok.shape[0], hidden_size=tok.shape[1],
              num_layers=n_layer, num_heads=n_head,
              intermediate_size=inter0.shape[0],
              max_position_embeddings=pos.shape[0],
              type_vocab_size=typ.shape[0])
    if config is not None and not isinstance(config, dict):
        raise TypeError(
            "config must be a dict of BertConfig field overrides")
    kw.update(config or {})
    cfg = BertConfig(**kw)

    seed(0)
    net = BertModel(cfg, with_pooler=with_pooler, device=device)

    def lin(dst, src):
        return {f"{dst}.weight": sd[f"{src}.weight"].T,
                f"{dst}.bias": sd[f"{src}.bias"]}

    state = {
        "embeddings.word_embeddings.weight": tok,
        "embeddings.position_embeddings.weight": pos,
        "embeddings.token_type_embeddings.weight": typ,
        "embeddings.layer_norm.weight":
            sd["embeddings.LayerNorm.weight"],
        "embeddings.layer_norm.bias": sd["embeddings.LayerNorm.bias"],
    }
    for i in range(n_layer):
        src = f"encoder.layer.{i}"
        dst = f"encoder.{i}"
        state.update(lin(f"{dst}.attn.q_proj",
                         f"{src}.attention.self.query"))
        state.update(lin(f"{dst}.attn.k_proj",
                         f"{src}.attention.self.key"))
        state.update(lin(f"{dst}.attn.v_proj",
                         f"{src}.attention.self.value"))
        state.update(lin(f"{dst}.attn.out_proj",
                         f"{src}.attention.output.dense"))
        state[f"{dst}.ln_1.weight"] = \
            sd[f"{src}.attention.output.LayerNorm.weight"]
        state[f"{dst}.ln_1.bias"] = \
            sd[f"{src}.attention.output.LayerNorm.bias"]
        state.update(lin(f"{dst}.fc_in", f"{src}.intermediate.dense"))
        state.update(lin(f"{dst}.fc_out", f"{src}.output.dense"))
        state[f"{dst}.ln_2.weight"] = sd[f"{src}.output.LayerNorm.weight"]
        state[f"{dst}.ln_2.bias"] = sd[f"{src}.output.LayerNorm.bias"]
    if with_pooler and "pooler.dense.weight" in sd:
        state.update(lin("pooler.dense", "pooler.dense"))
    load_reference_state(net, state)
    return net


def llama_from_huggingface(model_or_state_dict, config=None,
                           device=None):
    """Build a LLaMA-style :class:`~paddle_tpu_torch.models.gpt.GPTForCausalLM`
    (RoPE + RMSNorm + SwiGLU + GQA, ``llama_config``) carrying the
    weights of a HF ``LlamaForCausalLM`` (or its state_dict).

    HF torch Linears store [out, in] (transposed in); the fused
    projections concatenate on the out dim — qkv as [q | k | v], the
    SwiGLU input as [gate | up] (our ``F.swiglu`` silus the first
    half). HF's rotary is the same half-split convention as
    ``ops/rotary.py``, so weights copy through unpermuted.
    """
    from .gpt import GPTForCausalLM, llama_config

    hf_cfg = getattr(model_or_state_dict, "config", None)
    sd = _state_dict(model_or_state_dict)
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}

    n_layer = 1 + max(int(k.split(".")[1]) for k in sd
                      if k.startswith("layers."))
    tok = sd["embed_tokens.weight"]
    hidden = tok.shape[1]
    kq = sd["layers.0.self_attn.q_proj.weight"]     # [H, H]
    kk = sd["layers.0.self_attn.k_proj.weight"]     # [kv*hd, H]
    gate0 = sd["layers.0.mlp.gate_proj.weight"]     # [ffn, H]

    n_head = getattr(hf_cfg, "num_attention_heads", None) \
        if hf_cfg is not None else None
    n_kv = getattr(hf_cfg, "num_key_value_heads", None) \
        if hf_cfg is not None else None
    if isinstance(config, dict):
        n_head = config.get("num_heads", n_head)
        n_kv = config.get("num_kv_heads", n_kv)
    if n_head is None:
        raise ValueError(
            "pass the HF model (not a bare state_dict) or "
            "config={'num_heads': ..., 'num_kv_heads': ...} — the "
            "head grouping is not inferable from weight shapes alone")
    if n_kv is None:
        n_kv = max(1, n_head * kk.shape[0] // kq.shape[0])

    rope_theta = getattr(hf_cfg, "rope_theta", 10000.0) \
        if hf_cfg is not None else 10000.0
    max_pos = getattr(hf_cfg, "max_position_embeddings", 2048) \
        if hf_cfg is not None else 2048
    # tie_word_embeddings=True checkpoints (Llama-3.2 family;
    # safetensors drops the shared lm_head tensor) have no
    # lm_head.weight — tie the built model instead of KeyError-ing.
    # The hf config's flag wins when present: a tied model passed as a
    # live HF module DOES expose the shared tensor in state_dict(), so
    # key presence alone would silently untie it.
    tied = "lm_head.weight" not in sd
    if hf_cfg is not None:
        tied = bool(getattr(hf_cfg, "tie_word_embeddings", tied))
    kw = dict(hidden_size=hidden, num_layers=n_layer,
              num_heads=n_head, num_kv_heads=n_kv,
              vocab_size=tok.shape[0],
              max_position_embeddings=max_pos,
              ffn_hidden_size=gate0.shape[0], rope_base=rope_theta,
              layer_norm_epsilon=getattr(hf_cfg, "rms_norm_eps", 1e-6)
              if hf_cfg is not None else 1e-6,
              tie_word_embeddings=tied)
    if config is not None and not isinstance(config, dict):
        raise TypeError(
            "config must be a dict of llama_config overrides")
    kw.update(config or {})
    cfg = llama_config(**kw)

    seed(0)
    net = GPTForCausalLM(cfg, device=device)

    state = {"gpt.embeddings.word_embeddings.weight": tok,
             "gpt.ln_f.weight": sd["norm.weight"]}
    if not cfg.tie_word_embeddings:
        state["lm_head.weight"] = sd["lm_head.weight"].T
    for i in range(n_layer):
        src, dst = f"layers.{i}", f"gpt.layers.{i}"
        qkv = np.concatenate(
            [sd[f"{src}.self_attn.q_proj.weight"].T,
             sd[f"{src}.self_attn.k_proj.weight"].T,
             sd[f"{src}.self_attn.v_proj.weight"].T], axis=1)
        fc_in = np.concatenate(
            [sd[f"{src}.mlp.gate_proj.weight"].T,
             sd[f"{src}.mlp.up_proj.weight"].T], axis=1)
        state.update({
            f"{dst}.ln_1.weight": sd[f"{src}.input_layernorm.weight"],
            f"{dst}.attn.qkv_proj.weight": qkv,
            f"{dst}.attn.out_proj.weight":
                sd[f"{src}.self_attn.o_proj.weight"].T,
            f"{dst}.ln_2.weight":
                sd[f"{src}.post_attention_layernorm.weight"],
            f"{dst}.mlp.fc_in.weight": fc_in,
            f"{dst}.mlp.fc_out.weight":
                sd[f"{src}.mlp.down_proj.weight"].T,
            # HF llama projections are bias-free; our Linears carry
            # biases — zero them so the math matches
            f"{dst}.attn.qkv_proj.bias":
                np.zeros(qkv.shape[1], qkv.dtype),
            f"{dst}.attn.out_proj.bias":
                np.zeros(hidden, qkv.dtype),
            f"{dst}.mlp.fc_in.bias":
                np.zeros(fc_in.shape[1], fc_in.dtype),
            f"{dst}.mlp.fc_out.bias":
                np.zeros(hidden, fc_in.dtype),
        })
    load_reference_state(net, state)
    return net
