"""The port's paged attention (plain twin of kernel B4, the wrapper and
the int8 pool) against the JAX package's ``xla`` path and its Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerances: the plain twin and the JAX ``xla`` path run the same f32
gather + softmax math, so 1e-5. Against the Pallas kernel (online
softmax across pages) 2e-5 for f32 pages and 2e-2 for bf16 pages, the
JAX package's own kernel tolerances (tests/test_paged_attention.py).
The kernel itself runs only on the card: the ``cuda``-marked tests (the
kernel against its twin at the serving path's shapes, at long pages,
large GQA groups and head dims above 256, head dims that are not a
multiple of 8, and pools that break the alignment of the row copies)
skip without one. On the card's machine, which has no JAX, run them alone:
``python -m pytest -m cuda --noconftest tests/test_torch_paged_attention.py``."""

import importlib
import math

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

tpa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")

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


@pytest.mark.parametrize("d", [20, 80, 96])
def test_plain_twin_matches_pallas_interpret_head_dims(d):
    """Head dims the kernel takes zero-filled to a padded width (GPT of
    hidden 640 / 8 heads, and 96), and d 20, whose last d % 8 columns the
    kernel reads one at a time; GQA, f32 pages."""
    args = _inputs(4, 2, 8, "float32", tail=-1, seed=2, d=d)
    want = np.asarray(jpa.paged_attention_kernel(*_jax(*args),
                                                 interpret=True))
    got = tpa.paged_attention_kernel(*_torch(*args))   # CPU: plain twin
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("h, kvh, ps, d", [
    (4, 2, 128, 16), (40, 1, 8, 128), (8, 8, 8, 320)],
    ids=["page128", "mqa40-d128", "d320"])
def test_plain_twin_matches_pallas_interpret_new_shapes(h, kvh, ps, d):
    """Shapes kernel B4 takes from this slice on: a page of 128 rows
    (two 64-row sub-stages), 40 q heads on one kv head at d 128 (split
    over q-head tiles), and d 320 (output columns split over blocks)."""
    args = _inputs(h, kvh, ps, "float32", tail=-1, seed=7, d=d)
    want = np.asarray(jpa.paged_attention_kernel(*_jax(*args),
                                                 interpret=True))
    got = tpa.paged_attention_kernel(*_torch(*args))   # CPU: plain twin
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_deprecated_aliases_match_jax():
    """``paged_attention``, ``paged_attention_ragged`` and
    ``paged_attention_chunk`` against the JAX package's, exported from
    the ops package as there."""
    import paddle_tpu.ops as jops
    import paddle_tpu_torch.ops as tops
    args = _inputs(4, 2, 8, "float32", tail=-1, seed=8)
    for name in ("paged_attention", "paged_attention_ragged"):
        want = np.asarray(getattr(jops, name)(*_jax(*args)))
        got = getattr(tops, name)(*_torch(*args), impl="plain")
        np.testing.assert_allclose(got.numpy(), want, atol=TOL_XLA,
                                   rtol=TOL_XLA)
    rng = np.random.RandomState(9)
    q = rng.randn(2, 3, 4, 16).astype(np.float32)
    kp = rng.randn(12, 4, 2, 16).astype(np.float32)
    vp = rng.randn(12, 4, 2, 16).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    base = np.array([5, 0], np.int32)
    want = np.asarray(jpa.paged_attention_chunk(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(base)))
    got = tops.paged_attention_chunk(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(base))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_XLA,
                               rtol=TOL_XLA)
    assert tops.PagedKVCache is tpa.PagedKVCache


def test_paged_kv_cache_matches_jax():
    """Allocation, appends across page boundaries and free, against the
    JAX package's ``PagedKVCache``: the same tables, lengths and pages."""
    rng = np.random.RandomState(10)
    jc = jpa.PagedKVCache(8, 4, 2, 8, max_seqs=2, pages_per_seq=3)
    tc = tpa.PagedKVCache(8, 4, 2, 8, max_seqs=2, pages_per_seq=3,
                          device="cpu")
    for seq, n in ((0, 3), (1, 6), (0, 5), (1, 2)):
        k = rng.randn(n, 2, 8).astype(np.float32)
        v = rng.randn(n, 2, 8).astype(np.float32)
        jc.append(seq, jnp.asarray(k), jnp.asarray(v))
        tc.append(seq, torch.from_numpy(k), torch.from_numpy(v))
    jc.free(1)
    tc.free(1)
    np.testing.assert_array_equal(tc.block_tables.numpy(),
                                  np.asarray(jc.block_tables))
    np.testing.assert_array_equal(tc.context_lens.numpy(),
                                  np.asarray(jc.context_lens))
    np.testing.assert_array_equal(tc.k_pages.numpy(),
                                  np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(),
                                  np.asarray(jc.v_pages))
    assert tc._free == jc._free
    with pytest.raises(ValueError, match="pages_per_seq"):
        tc.allocate(0, 13)


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


def _new_shape_tables(g, lens, seqs, ps, P, shared, n_pages):
    """Tables of ``seqs`` (first ``shared`` entries common to all) with
    -1 past each row's own pages."""
    n_seq = max(seqs) + 1
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda")[
        :n_seq * P].int() + 1
    st = perm.reshape(n_seq, P)
    st[:, :shared] = st[0, :shared]
    tables = st[torch.tensor(seqs, device="cuda")].clone()
    used = (torch.tensor(lens, device="cuda") + ps - 1) // ps
    tables[torch.arange(P, device="cuda")[None, :] >= used[:, None]] = -1
    return tables.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # name: (heads, kv heads, d, page size, kv dtype, q dtype, shared)
    ("mixed-shared", 12, 12, 64, 16, "float32", "float32", 32),
    ("page128", 12, 12, 64, 128, "float32", "float32", 0),
    ("page256", 12, 12, 64, 256, "float32", "float32", 0),
    ("mqa40-d128-bf16", 40, 1, 128, 16, "bfloat16", "bfloat16", 0),
    ("mqa64-d64", 64, 1, 64, 16, "float32", "float32", 0),
    ("d320", 8, 8, 320, 16, "float32", "float32", 0)],
    ids=lambda c: c[0])
def test_kernel_matches_plain_on_card_new_shapes(case):
    """Kernel B4 against its plain twin at chip_smoke.py's new shapes: a
    mixed tick (64 suffix chunk rows of one sequence and 8 decode rows of
    others, the first 32 pages shared by all), pages of 128 and 256
    rows, 40 and 64 q heads on one kv head, and d 320."""
    if not torch.cuda.is_available():
        pytest.skip("kernel B4 runs only on a CUDA card")
    _, h, kvh, d, ps, kv_dtype, q_dtype, shared = case
    g = torch.Generator(device="cuda").manual_seed(1)
    decode = [0, 17, 143, 269, 400, 647, 773, 932]
    if shared:
        lens = list(range(513, 577)) + [530, 560, 600, 650, 690, 700, 720,
                                         740]
        seqs = [0] * 64 + list(range(1, 9))
    else:
        lens, seqs = decode, list(range(8))
    n_pages = 16384 // ps
    P = 1024 // ps
    kp = torch.randn(n_pages, ps, kvh, d, generator=g, device="cuda")
    vp = torch.randn(n_pages, ps, kvh, d, generator=g, device="cuda")
    kp, vp = kp.to(getattr(torch, kv_dtype)), vp.to(getattr(torch, kv_dtype))
    tables = _new_shape_tables(g, lens, seqs, ps, P, shared, n_pages)
    lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), h, d, generator=g,
                    device="cuda").to(getattr(torch, q_dtype))
    before = tpa.launches
    got = tpa.paged_attention_kernel(q, kp, vp, tables, lt)
    want = tpa.paged_attention_torch(q, kp, vp, tables, lt)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    tol = 2e-2 if q_dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert torch.count_nonzero(got[lt == 0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_kernel_matches_plain_on_card_verify_window(kv_dtype):
    """A speculative verify window as ``_PagedVerify`` lays it out: 8
    slots x K 4 rows, each slot's table repeated for its 4 rows, limits
    base + 1 .. base + 4 (the kernel runs a slot's rows as one run), one
    inactive slot (limits 0)."""
    if not torch.cuda.is_available():
        pytest.skip("kernel B4 runs only on a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(2)
    K, P = 4, 64
    bases = [0, 16, 143, 269, 400, 647, 773, 928]
    lens = [b + j + 1 if b else 0 for b in bases for j in range(K)]
    slot_tables = torch.randperm(1023, generator=g, device="cuda")[
        :8 * P].int().reshape(8, P) + 1
    tables = slot_tables.repeat_interleave(K, dim=0).contiguous()
    kp = torch.randn(1024, 16, 12, 64, generator=g, device="cuda")
    vp = torch.randn(1024, 16, 12, 64, generator=g, device="cuda")
    ks = vs = None
    if kv_dtype == "int8":
        (kp, ks), (vp, vs) = tpa.quantize_kv(kp), tpa.quantize_kv(vp)
    lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), 12, 64, generator=g, device="cuda")
    before = tpa.launches
    got = tpa.paged_attention_kernel(q, kp, vp, tables, lt, k_scales=ks,
                                     v_scales=vs)
    want = tpa.paged_attention_torch(q, kp, vp, tables, lt, k_scales=ks,
                                     v_scales=vs)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.count_nonzero(got[lt == 0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d, kv_dtype", [
    (20, "float32"), (20, "bfloat16"), (20, "int8"), (100, "float32"),
    (100, "int8"), (36, "float32"), (17, "bfloat16"), (13, "int8"),
    (300, "float32")], ids=lambda v: str(v))
def test_kernel_takes_head_dims_not_a_multiple_of_8(d, kv_dtype):
    """Head dims that are not a multiple of 8, as the Pallas kernel
    takes them: K/V rows staged in 4-, 2- or 1-byte copies where 16 or 8
    do not divide a row, the last d % 8 columns of QK one at a time, and
    above 256 output-column tiles that are not a multiple of 8. A mixed
    run of 8 chunk rows of one sequence and 4 decode rows, 2 q heads a
    kv head, pages of 16 (rows spanning several partitions)."""
    if not torch.cuda.is_available():
        pytest.skip("kernel B4 runs only on a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(3)
    ps, P, n_pages = 16, 64, 1024
    lens = list(range(300, 308)) + [1, 15, 16, 1000]
    seqs = [0] * 8 + [1, 2, 3, 4]
    kp = torch.randn(n_pages, ps, 2, d, generator=g, device="cuda")
    vp = torch.randn(n_pages, ps, 2, d, generator=g, device="cuda")
    ks = vs = None
    if kv_dtype == "int8":
        (kp, ks), (vp, vs) = tpa.quantize_kv(kp), tpa.quantize_kv(vp)
    else:
        kp, vp = kp.to(getattr(torch, kv_dtype)), vp.to(
            getattr(torch, kv_dtype))
    tables = _new_shape_tables(g, lens, seqs, ps, P, 0, n_pages)
    lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), 4, d, generator=g, device="cuda")
    before = tpa.launches
    got = tpa.paged_attention_kernel(q, kp, vp, tables, lt, k_scales=ks,
                                     v_scales=vs)
    want = tpa.paged_attention_torch(q, kp, vp, tables, lt, k_scales=ks,
                                     v_scales=vs)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d, kv_dtype, shift, ok", [
    (64, "float32", 1, False), (64, "float32", 4, True),
    (20, "bfloat16", 1, False), (20, "bfloat16", 4, True),
    (13, "int8", 1, True)], ids=lambda v: str(v))
def test_kernel_checks_pool_alignment_against_its_copies(d, kv_dtype,
                                                         shift, ok):
    """The launch checks the pools against the width it stages their
    rows in (16 bytes for a 256-byte row, 8 for a 40-byte one, 1 for a
    13-byte one): pools that start ``shift`` elements into a buffer are
    refused with a ValueError and no launch where they break it, and
    match the twin where they keep it."""
    if not torch.cuda.is_available():
        pytest.skip("kernel B4 runs only on a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(4)
    dt = getattr(torch, kv_dtype)
    shape = (64, 16, 2, d)
    n = math.prod(shape)

    def pool():
        x = torch.randn(n + shift, generator=g, device="cuda")
        if kv_dtype == "int8":
            return (x * 50).to(dt)[shift:].view(shape)
        return x.to(dt)[shift:].view(shape)
    kp, vp = pool(), pool()
    ks = vs = None
    if kv_dtype == "int8":
        ks = torch.rand(64, 16, generator=g, device="cuda") * 0.02
        vs = torch.rand(64, 16, generator=g, device="cuda") * 0.02
    lens = [40, 0, 17]
    tables = _new_shape_tables(g, lens, [0, 1, 2], 16, 4, 0, 64)
    lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(len(lens), 4, d, generator=g, device="cuda").to(
        torch.bfloat16 if kv_dtype == "bfloat16" else torch.float32)
    before = tpa.launches
    if not ok:
        with pytest.raises(ValueError, match="aligned"):
            tpa.paged_attention_kernel(q, kp, vp, tables, lt)
        assert tpa.launches == before
        return
    got = tpa.paged_attention_kernel(q, kp, vp, tables, lt, k_scales=ks,
                                     v_scales=vs)
    want = tpa.paged_attention_torch(q, kp, vp, tables, lt, k_scales=ks,
                                     v_scales=vs)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    tol = 2e-2 if kv_dtype == "bfloat16" else 1e-4
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d, heads, kv_dtype", [
    (16384, 2, "float32"), (32768, 2, "float32"), (32768, 10, "bfloat16"),
    (24576, 2, "int8")], ids=lambda v: str(v))
def test_kernel_takes_head_dims_past_shared_memory(d, heads, kv_dtype):
    """Head dims whose staged K row, V column slice and float32 q vectors
    pass a block's shared memory (f32 above ~19K, bf16 above ~28K): the
    streamed kernel reads K, q and V over d from global memory. Decode
    rows on one kv head, 2 and 10 q heads (two q-head tiles), a few
    16-token pages a row, one zero row and rows split over several
    partitions."""
    if not torch.cuda.is_available():
        pytest.skip("kernel B4 runs only on a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(4)
    ps, P = 16, 24
    lens = [0, 5, 16, 17, 40, 64, 200, 333]
    n_pages = len(lens) * P + 1
    kp = torch.randn(n_pages, ps, 1, d, generator=g, device="cuda")
    vp = torch.randn(n_pages, ps, 1, d, generator=g, device="cuda")
    ks = vs = None
    if kv_dtype == "int8":
        (kp, ks), (vp, vs) = tpa.quantize_kv(kp), tpa.quantize_kv(vp)
    else:
        kp, vp = kp.to(getattr(torch, kv_dtype)), \
            vp.to(getattr(torch, kv_dtype))
    tables = (torch.randperm(n_pages - 1, generator=g, device="cuda")[
        :len(lens) * P] + 1).int().reshape(len(lens), P)
    lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
    used = (lt + ps - 1) // ps
    tables[torch.arange(P, device="cuda")[None, :] >= used[:, None]] = -1
    q_dtype = torch.bfloat16 if kv_dtype == "bfloat16" else torch.float32
    q = torch.randn(len(lens), heads, d, generator=g,
                    device="cuda").to(q_dtype)
    before = tpa.launches
    got = tpa.paged_attention_kernel(q, kp, vp, tables.contiguous(), lt,
                                     k_scales=ks, v_scales=vs)
    want = tpa.paged_attention_torch(q, kp, vp, tables.contiguous(), lt,
                                     k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    tol = {"float32": 2e-5, "bfloat16": 2e-2, "int8": 1e-4}[kv_dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.count_nonzero(got[lt == 0]) == 0
