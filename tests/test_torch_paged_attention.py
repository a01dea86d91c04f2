"""The port's paged attention (plain twin of kernel B4, the wrapper and
the int8 pool) against the JAX package's ``xla`` path and its Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerances: the plain twin and the JAX ``xla`` path run the same f32
gather + softmax math, so 1e-5. Against the Pallas kernel (online
softmax across pages) 2e-5 for f32 pages and 2e-2 for bf16 pages, the
JAX package's own kernel tolerances (tests/test_paged_attention.py).
The kernel itself runs only on the card: ``test_kernel_matches_plain_
on_card`` (marker ``cuda``) skips without one. On the card's machine,
which has no JAX, run it alone:
``python -m pytest -m cuda --noconftest tests/test_torch_paged_attention.py``."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.ops import paged_attention as tpa  # noqa: E402

try:
    import jax.numpy as jnp
    # the package re-exports a function under the module's name
    jpa = importlib.import_module("paddle_tpu.ops.paged_attention")
except ImportError:
    # the card's machine has no JAX; it runs only the cuda-marked test
    # (README: pytest -m cuda --noconftest)
    jnp = jpa = None

TOL_XLA = 1e-5

# (heads, kv_heads, page_size, page dtype) of tests/test_paged_attention.py
CASES = [(4, 2, 8, "float32"), (4, 4, 16, "float32"),
         (8, 2, 8, "bfloat16")]
IDS = ["gqa-f32", "mha-f32", "gqa-bf16"]


def _inputs(h, kvh, ps, dtype, tail=0, seed=1, d=16):
    """Three rows: two pages + 3 tokens, one page + 1, and an empty row.
    ``tail`` fills unused table entries (0, or -1 for unallocated)."""
    rng = np.random.RandomState(seed)
    n_pages = 20
    q = rng.randn(3, h, d).astype(np.float32)
    kp = rng.randn(n_pages, ps, kvh, d).astype(np.float32)
    vp = rng.randn(n_pages, ps, kvh, d).astype(np.float32)
    tables = np.array([[1, 2, 3, tail], [4, 5, tail, tail],
                       [tail] * 4], np.int32)
    lens = np.array([2 * ps + 3, ps + 1, 0], np.int32)
    # round the pages to the dtype once, so both sides read equal values
    kp = np.array(jnp.asarray(kp, dtype).astype(jnp.float32))
    vp = np.array(jnp.asarray(vp, dtype).astype(jnp.float32))
    return q, kp, vp, tables, lens, dtype


def _jax(q, kp, vp, tables, lens, dtype):
    return (jnp.asarray(q), jnp.asarray(kp, dtype), jnp.asarray(vp, dtype),
            jnp.asarray(tables), jnp.asarray(lens))


def _torch(q, kp, vp, tables, lens, dtype):
    dt = getattr(torch, dtype)
    return (torch.from_numpy(q), torch.from_numpy(kp).to(dt),
            torch.from_numpy(vp).to(dt), torch.from_numpy(tables),
            torch.from_numpy(lens))


@pytest.mark.parametrize("tail", [0, -1], ids=["zero-tail", "neg1-tail"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_twin_matches_jax_xla(case, tail):
    args = _inputs(*case, tail=tail)
    want = np.asarray(jpa.ragged_paged_attention(*_jax(*args),
                                                 impl="xla"))
    got = tpa.ragged_paged_attention(*_torch(*args), impl="plain")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_XLA,
                               rtol=TOL_XLA)
    np.testing.assert_array_equal(got[2].numpy(), 0.0)   # empty row


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_twin_matches_pallas_interpret(case):
    args = _inputs(*case, tail=-1)
    want = np.asarray(jpa.paged_attention_kernel(*_jax(*args),
                                                 interpret=True))
    got = tpa.paged_attention_kernel(*_torch(*args))   # CPU: plain twin
    tol = 2e-2 if case[3] == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("d", [80, 96])
def test_plain_twin_matches_pallas_interpret_head_dims(d):
    """Head dims the kernel takes zero-filled to a padded width (GPT of
    hidden 640 / 8 heads, and 96), GQA, f32 pages."""
    args = _inputs(4, 2, 8, "float32", tail=-1, seed=2, d=d)
    want = np.asarray(jpa.paged_attention_kernel(*_jax(*args),
                                                 interpret=True))
    got = tpa.paged_attention_kernel(*_torch(*args))   # CPU: plain twin
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_cpu_wrapper_takes_plain_twin_without_launching():
    before = tpa.launches
    args = _torch(*_inputs(4, 2, 8, "float32"))
    out = tpa.ragged_paged_attention(*args)             # impl="kernel"
    assert tpa.launches == before
    assert torch.equal(out, tpa.paged_attention_torch(*args))


def test_ragged_rows_match_jax_chunk():
    """The rectangular [B, K] chunk flattened to ragged rows with
    per-row causal limits, plus padding rows of limit 0."""
    rng = np.random.RandomState(0)
    B, K, H, KVH, PS, D, NP = 2, 3, 4, 2, 4, 16, 12
    q = rng.randn(B, K, H, D).astype(np.float32)
    kp = rng.randn(NP, PS, KVH, D).astype(np.float32)
    vp = rng.randn(NP, PS, KVH, D).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    base = np.array([5, 2], np.int32)
    want = np.asarray(jpa.paged_attention_chunk(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(base))).reshape(B * K, H, D)
    lims = (base[:, None] + np.arange(K)[None, :] + 1).reshape(-1)
    got = tpa.ragged_paged_attention(
        torch.from_numpy(q.reshape(B * K, H, D)), torch.from_numpy(kp),
        torch.from_numpy(vp),
        torch.from_numpy(np.repeat(tables, K, axis=0)),
        torch.from_numpy(lims.astype(np.int32)), impl="plain")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_XLA,
                               rtol=TOL_XLA)
    zero = tpa.ragged_paged_attention(
        torch.from_numpy(q.reshape(B * K, H, D)), torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(np.repeat(tables, K, 0)),
        torch.zeros(B * K, dtype=torch.int32), impl="plain")
    np.testing.assert_array_equal(zero.numpy(), 0.0)


def test_quantize_kv_bytes_identical_to_jax():
    rows = np.random.RandomState(3).randn(5, 7, 2, 16).astype(np.float32)
    rows[0, 0] = 0.0     # an all-zero row takes the eps scale
    jq, js = jpa.quantize_kv(jnp.asarray(rows))
    tq, ts = tpa.quantize_kv(torch.from_numpy(rows))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_kv_write_matches_jax(kv_dtype):
    """Writes into the [L, NP, ps, KVH, d] pool land where JAX's do,
    with identical bytes (and scales for int8)."""
    shape = (2, 6, 4, 2, 8)
    rows = np.random.RandomState(4).randn(5, 2, 8).astype(np.float32)
    page_idx = np.array([1, 1, 3, 0, 5])
    offs = np.array([0, 3, 2, 1, 1])
    jstore = jpa.kv_write(jpa.kv_zeros(shape, kv_dtype), 1,
                          jnp.asarray(page_idx), jnp.asarray(offs),
                          jnp.asarray(rows))
    tstore = tpa.kv_write(tpa.kv_zeros(shape, kv_dtype), 1,
                          torch.from_numpy(page_idx),
                          torch.from_numpy(offs), torch.from_numpy(rows))
    if kv_dtype == "int8":
        np.testing.assert_array_equal(tstore.pages.numpy(),
                                      np.asarray(jstore.pages))
        np.testing.assert_array_equal(tstore.scales.numpy(),
                                      np.asarray(jstore.scales))
        assert tpa.kv_nbytes(tstore) == jpa.kv_nbytes(jstore)
    else:
        np.testing.assert_array_equal(
            tstore.float().numpy(), np.asarray(jstore, np.float32))
        assert tpa.kv_nbytes(tstore) == jpa.kv_nbytes(jstore)
    assert tpa.kv_page_size(tstore) == jpa.kv_page_size(jstore) == 4


def _int8_pools(seed=5):
    rng = np.random.RandomState(seed)
    kp = rng.randn(20, 8, 2, 16).astype(np.float32)
    vp = rng.randn(20, 8, 2, 16).astype(np.float32)
    jk = jpa.QuantizedKV(*jpa.quantize_kv(jnp.asarray(kp)))
    jv = jpa.QuantizedKV(*jpa.quantize_kv(jnp.asarray(vp)))
    tk = tpa.QuantizedKV(*tpa.quantize_kv(torch.from_numpy(kp)))
    tv = tpa.QuantizedKV(*tpa.quantize_kv(torch.from_numpy(vp)))
    q = rng.randn(3, 4, 16).astype(np.float32)
    tables = np.array([[1, 2, 3, -1], [4, 5, -1, -1], [-1] * 4], np.int32)
    lens = np.array([19, 9, 0], np.int32)
    return q, (jk, jv), (tk, tv), tables, lens


@pytest.mark.parametrize("impl", [("xla", "plain"),
                                  ("reference", "reference")],
                         ids=["plain", "reference"])
def test_int8_pool_matches_jax(impl):
    q, (jk, jv), (tk, tv), tables, lens = _int8_pools()
    want = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lens),
        impl=impl[0]))
    got = tpa.ragged_paged_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(lens), impl=impl[1])
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_XLA,
                               rtol=TOL_XLA)


def test_int8_plain_twin_matches_pallas_interpret():
    q, (jk, jv), (tk, tv), tables, lens = _int8_pools(seed=6)
    want = np.asarray(jpa.paged_attention_kernel(
        jnp.asarray(q), jk.pages, jv.pages, jnp.asarray(tables),
        jnp.asarray(lens), interpret=True, k_scales=jk.scales,
        v_scales=jv.scales))
    got = tpa.paged_attention_kernel(
        torch.from_numpy(q), tk.pages, tv.pages, torch.from_numpy(tables),
        torch.from_numpy(lens), k_scales=tk.scales, v_scales=tv.scales)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_reference_impl_is_f32_end_to_end():
    args = _torch(*_inputs(8, 2, 8, "bfloat16"))
    q16 = args[0].to(torch.bfloat16)
    ref = tpa.ragged_paged_attention_reference(q16, *args[1:])
    assert ref.dtype == torch.float32
    out = tpa.ragged_paged_attention(q16, *args[1:], impl="reference")
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown impl"):
        tpa.ragged_paged_attention(*args, impl="xla")


def _card_case(g, kv_dtype, h, kvh, d, lens, tables):
    kp = torch.randn(96, 16, kvh, d, generator=g, device="cuda")
    vp = torch.randn(96, 16, kvh, d, generator=g, device="cuda")
    ks = vs = None
    if kv_dtype == "int8":
        (kp, ks), (vp, vs) = tpa.quantize_kv(kp), tpa.quantize_kv(vp)
    else:
        kp, vp = kp.to(getattr(torch, kv_dtype)), \
            vp.to(getattr(torch, kv_dtype))
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), h, d, generator=g, device="cuda")
    before = tpa.launches
    got = tpa.paged_attention_kernel(q, kp, vp, tables, lens, k_scales=ks,
                                     v_scales=vs)
    want = tpa.paged_attention_torch(q, kp, vp, tables, lens, k_scales=ks,
                                     v_scales=vs)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    tol = 2e-2 if kv_dtype == "bfloat16" else 1e-4
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert torch.count_nonzero(got[lens == 0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_kernel_matches_plain_on_card(kv_dtype):
    """Kernel B4 against its plain twin on the card: GQA and MHA, head
    dims 64, 80, 128, 256, a partial last page, an empty row, -1 table
    tails; a 1024-token decode row split over partitions; a prefill
    chunk whose rows of one sequence share their pages, beside rows of
    another sequence and padding."""
    if not torch.cuda.is_available():
        pytest.skip("kernel B4 runs only on a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    for h, kvh, d in [(12, 12, 64), (16, 4, 128), (8, 8, 80), (8, 2, 256)]:
        tables = torch.full((4, 8), -1, dtype=torch.int32, device="cuda")
        tables[0, :3] = torch.tensor([5, 9, 2])
        tables[1, :1] = 7
        tables[3, :8] = torch.arange(10, 18)
        _card_case(g, kv_dtype, h, kvh, d, [35, 16, 0, 128], tables)
    # one decode row over 64 pages (8 partitions of 8 pages)
    long_table = torch.arange(20, 84, dtype=torch.int32,
                              device="cuda")[None]
    _card_case(g, kv_dtype, 12, 12, 64, [1024], long_table)
    # a chunk: 20 rows of one sequence (lens 181..200, -1 tails past each
    # row's own pages), 6 rows of another, 2 padding rows
    seq = torch.randperm(90, generator=g, device="cuda")[:26].int() + 1
    lens = list(range(181, 201)) + list(range(3, 9)) + [0, 0]
    tables = torch.full((28, 16), -1, dtype=torch.int32, device="cuda")
    for i, n in enumerate(lens):
        if n:
            src = seq[:13] if i < 20 else seq[13:]
            used = -(-n // 16)
            tables[i, :used] = src[:used]
    _card_case(g, kv_dtype, 12, 12, 64, lens, tables)
