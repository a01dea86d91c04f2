"""The port's HuggingFace converters (``paddle_tpu_torch/models/
convert.py``) against the JAX package's: GPT-2-, BERT- and LLaMA-layout
state dicts in HF names, drawn from a seed with numpy, through both
converters (float32 logits / hidden states within ``1e-6 + 1e-5
|jax|``, the converted states equal and loadable into each other with
``interop.load_reference_state``); a bare state dict without the head
count warns or raises as the JAX package does. Where ``transformers``
imports, the round trips of ``tests/test_convert.py`` against HF models
built offline with random weights (logits within that file's 2e-4 /
3e-4, greedy generation token-identical)."""

import warnings

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

torch = pytest.importorskip("torch")

from paddle_tpu.models import convert as jconv  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.models import convert as tconv  # noqa: E402

ATOL, RTOL = 1e-6, 1e-5
V, H, L, POS = 96, 64, 2, 32


def _close(got, want, atol=ATOL, rtol=RTOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=what)


def _r(rs, *shape, scale=0.05):
    return (rs.randn(*shape) * scale).astype(np.float32)


def gpt2_sd(seed=0):
    rs = np.random.RandomState(seed)
    sd = {"transformer.wte.weight": _r(rs, V, H),
          "transformer.wpe.weight": _r(rs, POS, H),
          "transformer.ln_f.weight": 1 + _r(rs, H),
          "transformer.ln_f.bias": _r(rs, H)}
    for i in range(L):
        p = f"transformer.h.{i}"
        sd.update({f"{p}.ln_1.weight": 1 + _r(rs, H),
                   f"{p}.ln_1.bias": _r(rs, H),
                   f"{p}.attn.c_attn.weight": _r(rs, H, 3 * H),
                   f"{p}.attn.c_attn.bias": _r(rs, 3 * H),
                   f"{p}.attn.c_proj.weight": _r(rs, H, H),
                   f"{p}.attn.c_proj.bias": _r(rs, H),
                   f"{p}.ln_2.weight": 1 + _r(rs, H),
                   f"{p}.ln_2.bias": _r(rs, H),
                   f"{p}.mlp.c_fc.weight": _r(rs, H, 4 * H),
                   f"{p}.mlp.c_fc.bias": _r(rs, 4 * H),
                   f"{p}.mlp.c_proj.weight": _r(rs, 4 * H, H),
                   f"{p}.mlp.c_proj.bias": _r(rs, H)})
    return sd


def bert_sd(seed=1, inter=128):
    rs = np.random.RandomState(seed)
    sd = {"bert.embeddings.word_embeddings.weight": _r(rs, V, H),
          "bert.embeddings.position_embeddings.weight": _r(rs, POS, H),
          "bert.embeddings.token_type_embeddings.weight": _r(rs, 2, H),
          "bert.embeddings.LayerNorm.weight": 1 + _r(rs, H),
          "bert.embeddings.LayerNorm.bias": _r(rs, H),
          "bert.pooler.dense.weight": _r(rs, H, H),
          "bert.pooler.dense.bias": _r(rs, H)}

    def lin(name, o, i):
        sd[f"{name}.weight"] = _r(rs, o, i)      # torch's [out, in]
        sd[f"{name}.bias"] = _r(rs, o)
    for i in range(L):
        p = f"bert.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{p}.attention.self.{n}", H, H)
        lin(f"{p}.attention.output.dense", H, H)
        sd[f"{p}.attention.output.LayerNorm.weight"] = 1 + _r(rs, H)
        sd[f"{p}.attention.output.LayerNorm.bias"] = _r(rs, H)
        lin(f"{p}.intermediate.dense", inter, H)
        lin(f"{p}.output.dense", H, inter)
        sd[f"{p}.output.LayerNorm.weight"] = 1 + _r(rs, H)
        sd[f"{p}.output.LayerNorm.bias"] = _r(rs, H)
    return sd


def llama_sd(seed=2, heads=4, kv=2, ffn=96, tied=False):
    rs = np.random.RandomState(seed)
    hd = H // heads
    sd = {"model.embed_tokens.weight": _r(rs, V, H),
          "model.norm.weight": 1 + _r(rs, H)}
    if not tied:
        sd["lm_head.weight"] = _r(rs, V, H)
    for i in range(L):
        p = f"model.layers.{i}"
        sd.update({f"{p}.input_layernorm.weight": 1 + _r(rs, H),
                   f"{p}.post_attention_layernorm.weight": 1 + _r(rs, H),
                   f"{p}.self_attn.q_proj.weight": _r(rs, H, H),
                   f"{p}.self_attn.k_proj.weight": _r(rs, kv * hd, H),
                   f"{p}.self_attn.v_proj.weight": _r(rs, kv * hd, H),
                   f"{p}.self_attn.o_proj.weight": _r(rs, H, H),
                   f"{p}.mlp.gate_proj.weight": _r(rs, ffn, H),
                   f"{p}.mlp.up_proj.weight": _r(rs, ffn, H),
                   f"{p}.mlp.down_proj.weight": _r(rs, H, ffn)})
    return sd


def _ids(seed=3):
    return np.random.RandomState(seed).randint(0, V, (2, 16))


def _states_equal(tnet, jnet):
    want = {k: np.asarray(v) for k, v in jnet.state_dict().items()}
    got = tnet.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    load_reference_state(tnet, want)


CFG = {"hidden_dropout": 0.0, "attention_dropout": 0.0}


def test_gpt2_state_dict_converts_as_jax():
    sd = gpt2_sd()
    cfg = {"num_heads": 2, **CFG}
    jnet = jconv.gpt2_from_huggingface(sd, config=cfg)
    tnet = tconv.gpt2_from_huggingface(
        {k: torch.from_numpy(v) for k, v in sd.items()}, config=cfg,
        device="cpu")
    _states_equal(tnet, jnet)
    # Conv1D weights copy through untransposed
    np.testing.assert_array_equal(
        tnet.state_dict()["gpt.layers.1.attn.qkv_proj.weight"].numpy(),
        sd["transformer.h.1.attn.c_attn.weight"])
    assert tnet.cfg.activation == "gelu_tanh"
    jnet.eval()
    tnet.eval()
    ids = _ids()
    with torch.no_grad():
        _close(tnet(torch.from_numpy(ids)), jnet(ids))


def test_bert_state_dict_converts_as_jax():
    sd = bert_sd()
    cfg = {"num_heads": 2, **CFG}
    jnet = jconv.bert_from_huggingface(sd, config=cfg)
    tnet = tconv.bert_from_huggingface(sd, config=cfg, device="cpu")
    _states_equal(tnet, jnet)
    # torch Linear [out, in] transposes into Paddle's [in, out]
    np.testing.assert_array_equal(
        tnet.state_dict()["encoder.0.fc_in.weight"].numpy(),
        sd["bert.encoder.layer.0.intermediate.dense.weight"].T)
    assert tnet.cfg.intermediate_size == 128
    jnet.eval()
    tnet.eval()
    ids = _ids(4)
    with torch.no_grad():
        seq, pooled = tnet(torch.from_numpy(ids))
    jseq, jpooled = jnet(ids)
    _close(seq, jseq, what="sequence output")
    _close(pooled, jpooled, what="pooled")


@pytest.mark.parametrize("tied", [False, True])
def test_llama_state_dict_converts_as_jax(tied):
    sd = llama_sd(tied=tied)
    cfg = {"num_heads": 4, "num_kv_heads": 2}
    jnet = jconv.llama_from_huggingface(sd, config=cfg)
    tnet = tconv.llama_from_huggingface(sd, config=cfg, device="cpu")
    _states_equal(tnet, jnet)
    assert tnet.cfg.tie_word_embeddings == tied
    # the fused projections: qkv as [q | k | v], the SwiGLU input as
    # [gate | up]
    qkv = tnet.state_dict()["gpt.layers.0.attn.qkv_proj.weight"].numpy()
    np.testing.assert_array_equal(
        qkv[:, H:H + 32], sd["model.layers.0.self_attn.k_proj.weight"].T)
    fc_in = tnet.state_dict()["gpt.layers.0.mlp.fc_in.weight"].numpy()
    np.testing.assert_array_equal(
        fc_in[:, 96:], sd["model.layers.0.mlp.up_proj.weight"].T)
    jnet.eval()
    tnet.eval()
    ids = _ids(5)
    with torch.no_grad():
        _close(tnet(torch.from_numpy(ids)), jnet(ids))


def test_bare_state_dict_head_count():
    """No head count: GPT-2 and BERT guess ``hidden // 64`` with a
    warning, LLaMA raises, in both packages."""
    for mod in (jconv, tconv):
        kw = {"device": "cpu"} if mod is tconv else {}
        with pytest.warns(UserWarning, match="guessed num_heads=1"):
            net = mod.gpt2_from_huggingface(gpt2_sd(), **kw)
        assert net.cfg.num_heads == 1
        with pytest.warns(UserWarning, match="guessed num_heads=1"):
            mod.bert_from_huggingface(bert_sd(), **kw)
        with pytest.raises(ValueError, match="num_heads"):
            mod.llama_from_huggingface(llama_sd(), **kw)
        with pytest.raises(TypeError, match="dict"):
            mod.gpt2_from_huggingface(gpt2_sd(), config=object(), **kw)


def test_converter_composes_with_training():
    """A converted GPT-2 trains through the port's ``Model`` with
    ``scan_layers``, ``remat`` and the fused loss, as the JAX test's
    does."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.models.gpt import GPTFusedPretrainingCriterion
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = tconv.gpt2_from_huggingface(
            gpt2_sd(), config={"num_heads": 2, **CFG, "scan_layers": True,
                               "remat": True, "fused_loss": True},
            device="cpu")
    m = tpt.Model(net)
    m.prepare(optimizer=tpt.optimizer.AdamW(learning_rate=1e-3,
                                            parameters=net),
              loss=GPTFusedPretrainingCriterion())
    ids = _ids(6)
    losses = [float(m.train_batch([ids], [ids])["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_hf_gpt2_roundtrip():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GPT2Config(vocab_size=160, n_positions=32,
                                  n_embd=64, n_layer=2, n_head=2,
                                  resid_pdrop=0.0, embd_pdrop=0.0,
                                  attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(cfg).eval()
    ids = np.random.RandomState(0).randint(0, 160, (2, 16))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
    net = tconv.gpt2_from_huggingface(hf, config=dict(CFG), device="cpu")
    net.eval()
    assert net.cfg.num_heads == 2
    with torch.no_grad():
        _close(net(torch.from_numpy(ids)), ref, 2e-4, 2e-4)
        ours = net.generate(torch.from_numpy(ids[:1, :8]),
                            max_new_tokens=4).numpy()
        theirs = hf.generate(torch.tensor(ids[:1, :8]), max_new_tokens=4,
                             do_sample=False).numpy()
    np.testing.assert_array_equal(ours, theirs)


def test_hf_bert_roundtrip():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(vocab_size=160, hidden_size=64,
                                  num_hidden_layers=2,
                                  num_attention_heads=2,
                                  intermediate_size=128,
                                  max_position_embeddings=32,
                                  hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.BertModel(cfg).eval()
    ids = np.random.RandomState(0).randint(3, 160, (2, 16))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).last_hidden_state.numpy()
    net = tconv.bert_from_huggingface(hf, config=dict(CFG), device="cpu")
    net.eval()
    with torch.no_grad():
        seq, _ = net(torch.from_numpy(ids))
    _close(seq, ref, 3e-4, 3e-4)


def test_hf_llama_roundtrip():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.LlamaConfig(vocab_size=160, hidden_size=64,
                                   intermediate_size=96,
                                   num_hidden_layers=2,
                                   num_attention_heads=4,
                                   num_key_value_heads=2,
                                   max_position_embeddings=32,
                                   rope_theta=10000.0,
                                   attention_dropout=0.0,
                                   tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(cfg).eval()
    ids = np.random.RandomState(0).randint(0, 160, (2, 16))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
    net = tconv.llama_from_huggingface(hf, device="cpu")
    net.eval()
    with torch.no_grad():
        _close(net(torch.from_numpy(ids)), ref, 3e-4, 3e-4)
        ours = net.generate(torch.from_numpy(ids[:1, :8]),
                            max_new_tokens=4).numpy()
        theirs = hf.generate(torch.tensor(ids[:1, :8]), max_new_tokens=4,
                             do_sample=False).numpy()
    np.testing.assert_array_equal(ours, theirs)
