"""Kernel B4's route and the numeric design of its tile kernel, on the CPU.

``paged_route`` names the design a launch takes (``ops/paged_attention.py``);
here it is checked for every case of ``chip_smoke.py``'s B4 list and at
the edges of what the tile kernel takes (the rows of one sequence a
launch needs on average, head dims, page sizes, alignment), with
``run_counts`` / ``rows_per_run``, which count them, and the engine,
which passes them.

The tile kernel (``csrc/paged_attention.cu``, ``paged_attention_tile``)
runs only on the card. Its arithmetic is emulated here in float32 on the
mixed tick at gpt2 width (72 rows: 64 chunk rows of one sequence and 8
decode rows of others, the first 32 pages shared; 12 heads, d 64,
16-token pages), from seeded numpy inputs:

- f32 pools, 3xTF32: q, K, V and P split into hi = tf32(x) and lo =
  tf32(x - hi), tf32 rounding by adding half a tf32 ulp to the float32
  bits and masking the low 13 mantissa bits, as the kernel rounds; each
  product summed as hi lo + lo hi + hi hi; scores in log2 units and the
  online softmax over 64-row stages in float32;
- int8 pools: q split into bf16 hi + lo against the exact integers, the K
  scale folded into the scores, P times the V scale split into bf16 hi +
  lo against the exact integers.

Both are held to the JAX package's ``ragged_paged_attention`` at the
limits ``chip_smoke.py`` holds the kernel to on the card (f32 2e-5, int8
1e-4). One tf32 product, without the split, misses the f32 limit: the
emulation shows why the kernel splits.
"""

import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

tpa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
# the package re-exports a function under the module's name
jpa = importlib.import_module("paddle_tpu.ops.paged_attention")

F32_TOL = chip_smoke.TOLERANCE[torch.float32]
I8_TOL = chip_smoke.TOLERANCE[torch.int8]
LOG2E = 1.4426950408889634

# the design of every case of chip_smoke.py's B4 list, at the rows its
# sequences hold: one route, or {kv dtype: route}
ROUTES = {
    "decode gpt2": "simt", "chunk gpt2": "tile",
    "decode llama-gqa": "simt", "decode long row": "simt",
    "decode d80": "simt", "decode d256 gqa": "simt",
    "mixed chunk+decode shared": "tile", "decode ps128": "simt",
    "decode ps256": "simt", "decode mqa 40/1 d128": "simt",
    "decode 64/1": "simt", "decode d320": "simt", "decode d20": "simt",
    "chunk d20": "simt", "decode d100 gqa": "simt",
    "verify gpt2 (8 x K 4)": "simt",
    "verify gpt2, rows reversed": "simt",
    "decode d16384": "simt", "decode d32768 (streamed)": "simt",
    **{f"decode gpt2 x{n}": "simt" for n in chip_smoke.DECODE_SLOTS}}
CASES = {c[0]: c for c in chip_smoke.paged_cases()}


def _case_tables(lens, seqs, page_size):
    """Host tables as ``chip_smoke._case_inputs`` lays them out: rows of
    one sequence share its pages, -1 past each row's live pages."""
    lens = np.asarray(lens)
    P = 1024 // page_size + 1
    tables = np.asarray(seqs)[:, None] * P + np.arange(P)[None, :] + 1
    tables[np.arange(P)[None, :] >= -(-lens[:, None] // page_size)] = -1
    return tables


def test_every_chip_smoke_case_has_a_route():
    assert set(CASES) == set(ROUTES)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_of_chip_smoke_case(name):
    _, t, heads, kv_heads, d, lens, seqs, dtypes, *extra = CASES[name]
    page_size = (extra[0] if extra else {}).get("page_size",
                                                chip_smoke.PAGE_SIZE)
    run = tpa.rows_per_run(lens, _case_tables(lens, seqs, page_size),
                           page_size)
    for kv_dtype, q_dtype in dtypes:
        want = ROUTES[name]
        want = want[kv_dtype] if isinstance(want, dict) else want
        assert tpa.paged_route(t, heads, kv_heads, d, page_size, kv_dtype,
                               q_dtype, run) == want, (kv_dtype, q_dtype)


@pytest.mark.parametrize("lens, seqs, want", [
    ([], [], (0, 0)), ([5], [0], (1, 1)), ([0, 0, 0], [0, 0, 0], (0, 0)),
    ([3, 4, 5, 9, 10], [0, 0, 0, 1, 1], (5, 2)),
    ([5, 4, 3], [0, 0, 0], (3, 3)),            # falling limits
    ([7, 7], [0, 0], (2, 1)),                  # equal limits join
    ([0, 1, 2], [0, 0, 0], (2, 1)),            # a zero row is no run
    ([40, 41, 1, 2, 3, 0], [0, 0, 1, 1, 1, 2], (5, 2)),
    ([16, 17, 18], [0, 1, 1], (3, 2))],
    ids=lambda v: str(v))
def test_run_counts(lens, seqs, want):
    tables = _case_tables(lens, seqs, 16) if lens else np.zeros((0, 4))
    assert tpa.run_counts(lens, tables, 16) == want
    live, runs = want
    assert tpa.rows_per_run(lens, tables, 16) == \
        (live / runs if runs else 0.0)


def test_run_counts_compare_only_the_earlier_rows_pages():
    # rows whose tables differ past the earlier row's live pages join, as
    # the kernels' run detection joins them; a difference inside does not
    tables = np.array([[3, 4, -1, -1], [3, 4, 9, -1], [3, 5, 9, 8]])
    assert tpa.run_counts([20, 40, 60], tables, 16) == (3, 2)
    assert tpa.run_counts([16, 40, 60], tables, 16) == (3, 2)
    tables[1, 0] = 7
    assert tpa.run_counts([20, 40, 60], tables, 16) == (3, 3)


@pytest.mark.parametrize("args, want", [
    ((64, 12, 12, 16, 16, 64), "tile"), ((64, 12, 12, 256, 16, 64), "tile"),
    ((64, 12, 12, 272, 16, 64), "simt"), ((64, 12, 12, 72, 16, 64), "simt"),
    ((64, 12, 12, 64, 8, 64), "tile"), ((64, 12, 12, 64, 512, 64), "tile"),
    ((64, 12, 12, 64, 4, 64), "simt"), ((64, 12, 12, 64, 24, 64), "simt"),
    ((64, 12, 12, 64, 16, 0), "simt"), ((16, 12, 12, 64, 16, 16), "tile"),
    ((72, 12, 12, 64, 16, 8), "tile"), ((72, 12, 12, 64, 16, 7.9), "simt"),
    ((128, 12, 12, 64, 16, 4), "simt"), ((128, 12, 12, 64, 16, 1), "simt"),
    ((16384, 12, 12, 64, 16, 64), "tile"),
    ((16385, 12, 12, 64, 16, 64), "simt"),
    ((8, 12, 5, 64, 16, 1), None), ((8, 12, 12, 0, 16, 1), None)],
    ids=lambda v: str(v))
def test_route_edges(args, want):
    t, h, kvh, d, ps, run = args
    assert tpa.paged_route(t, h, kvh, d, ps, torch.float32, torch.float32,
                           run) == want


def test_route_of_misaligned_pools_and_other_dtypes():
    assert tpa.paged_route(64, 12, 12, 64, 16, torch.float32,
                           torch.float32, 64, aligned=False) == "simt"
    assert tpa.paged_route(8, 12, 12, 64, 16, torch.float64,
                           torch.float32) is None
    assert tpa.paged_route(8, 12, 12, 64, 16, torch.int8,
                           torch.int8) is None
    for kv in (torch.float32, torch.bfloat16, torch.float16, torch.int8):
        for q in (torch.float32, torch.bfloat16, torch.float16):
            assert tpa.paged_route(72, 12, 12, 64, 16, kv, q, 64) == "tile"
            assert tpa.paged_route(64, 12, 12, 64, 16, kv, q, 8) == "tile"
            # decode batches of any size and verify windows of 4 stay on
            # simt
            assert tpa.paged_route(256, 12, 12, 64, 16, kv, q, 1) == "simt"
            assert tpa.paged_route(32, 12, 12, 64, 16, kv, q, 4) == "simt"


def test_launch_route_reads_alignment_from_the_tensors():
    q = torch.zeros(64, 2, 64)
    pool = torch.zeros(8 * 16 * 2 * 64 + 1)
    aligned = pool[:-1].view(8, 16, 2, 64)
    shifted = pool[1:].view(8, 16, 2, 64)
    assert tpa.launch_route(q, aligned, aligned, seq_rows=64) == "tile"
    assert tpa.launch_route(q, shifted, aligned, seq_rows=64) == "simt"
    assert tpa.launch_route(q, aligned, aligned) == "simt"


@pytest.mark.parametrize("mixed_tick", [True, False],
                         ids=["mixed-tick", "alternating"])
def test_engine_passes_rows_of_one_sequence(monkeypatch, mixed_tick):
    """Every attention launch of the engine carries the rows its
    sequences hold on average: 1 on decode ticks and only where each
    live row is a sequence of its own, and never more than the launch
    holds (a mixed tick counts every slot of its slab as decoding), so
    the route errs towards simt."""
    from test_torch_engine import pair
    tllm = importlib.import_module("paddle_tpu_torch.inference.llm")
    seen = []
    real = tllm.ragged_paged_attention

    def record(q, kv_k, kv_v, tables, lens, *args, seq_rows=0, **kw):
        seen.append((seq_rows, tpa.rows_per_run(
            lens.numpy(), tables.numpy(), tpa.kv_page_size(kv_k))))
        return real(q, kv_k, kv_v, tables, lens, *args, seq_rows=seq_rows,
                    **kw)
    monkeypatch.setattr(tllm, "ragged_paged_attention", record)
    net = pair("gpt2")[1]
    with tllm.LLMEngine(net, device="cpu", page_size=4, num_pages=64,
                        max_seqs=3, prefill_chunk=8, mixed_tick=mixed_tick,
                        prefix_cache=False, attention_impl="plain") as eng:
        futs = [eng.submit(p, max_new_tokens=4, nonce=i) for i, p in
                enumerate([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [5, 6],
                           [7, 8, 9, 10, 11, 12]])]
        [f.result(timeout=120) for f in futs]
    assert seen and all(hint >= 1 for hint, _ in seen)
    assert all(run == 0 or hint <= run + 1e-9 for hint, run in seen), seen
    assert all(run <= 1 for hint, run in seen if hint == 1), seen
    assert any(hint == 1 for hint, _ in seen)
    assert any(hint > 1 for hint, _ in seen)


# --------------------------------------------------------------------------
# the tile kernel's arithmetic, emulated
# --------------------------------------------------------------------------

T_ROWS, HEADS, D, PS, SHARED, P = 72, 12, 64, 16, 32, 48
LENS = list(range(513, 577)) + [530, 560, 600, 650, 690, 700, 720, 740]
SEQS = [0] * 64 + list(range(1, 9))
STAGE = 64       # page rows a stage at d 64 (f32 and int8)


def _mixed_tick(seed=0):
    """q [72, 12, 64], pools [NP, 16, 12, 64] f32, tables [72, 48] (-1
    past each row's pages, the first 32 entries shared), lens [72]."""
    rng = np.random.RandomState(seed)
    n_pages = 9 * P + 1
    q = rng.randn(T_ROWS, HEADS, D).astype(np.float32)
    kp = rng.randn(n_pages, PS, HEADS, D).astype(np.float32)
    vp = rng.randn(n_pages, PS, HEADS, D).astype(np.float32)
    seq_tables = (rng.permutation(n_pages - 1)[:9 * P] + 1).reshape(9, P)
    seq_tables[:, :SHARED] = seq_tables[0, :SHARED]
    tables = seq_tables[SEQS].astype(np.int32)
    lens = np.array(LENS, np.int32)
    used = -(-lens // PS)
    tables[np.arange(P)[None, :] >= used[:, None]] = -1
    return q, kp, vp, tables, lens


def _tf32(x):
    """x rounded to tf32 as the kernel rounds it: half a tf32 ulp added
    to the float32 bits, the low 13 mantissa bits masked."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _split_bf16(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _gather(pool, tables, h):
    """Each row's positions of kv head h: [T, P * ps, ...]."""
    rows = pool[torch.from_numpy(tables).long().clamp(min=0)]
    return rows.reshape(T_ROWS, P * PS, *rows.shape[3:])[:, :, h]


def _online(scores, pv, lens):
    """The kernel's softmax: scores [T, L] in log2 units, masked at each
    row's limit, taken in STAGE-row stages with a running max and sum;
    ``pv(p, s0)`` adds P V over the stage at s0. Zero rows give zeros."""
    t, L = scores.shape
    pos = torch.arange(L)[None, :]
    scores = torch.where(pos < torch.from_numpy(lens).long()[:, None],
                         scores, torch.tensor(-math.inf))
    m = torch.full((t, 1), -math.inf)
    l = torch.zeros(t, 1)
    acc = None
    for s0 in range(0, L, STAGE):
        x = scores[:, s0:s0 + STAGE]
        m_new = torch.maximum(m, x.amax(dim=1, keepdim=True))
        base = torch.where(m_new == -math.inf, torch.zeros_like(m_new),
                           m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(x - base)
        l = l * alpha + p.sum(dim=1, keepdim=True)
        add = pv(p, s0)
        acc = add if acc is None else acc * alpha + add
        m = m_new
    return torch.where(l == 0, torch.zeros_like(acc), acc / l)


def _emulate_f32(q, kp, vp, tables, lens, split=True):
    """The f32 pool's products: 3xTF32, or one tf32 product if not
    ``split``."""
    q, kp, vp = (torch.from_numpy(x) for x in (q, kp, vp))
    sc2 = (1.0 / math.sqrt(D)) * LOG2E
    out = torch.empty(T_ROWS, HEADS, D)
    for h in range(HEADS):
        k, v = _gather(kp, tables, h), _gather(vp, tables, h)
        qh, ql = _split_tf32(q[:, h])
        kh, kl = _split_tf32(k)
        vh, vl = _split_tf32(v)
        if split:
            s = (torch.einsum("td,tld->tl", qh, kl) +
                 torch.einsum("td,tld->tl", ql, kh) +
                 torch.einsum("td,tld->tl", qh, kh))
        else:
            s = torch.einsum("td,tld->tl", qh, kh)

        def pv(p, s0, split=split, vh=vh, vl=vl):
            ph, pl = _split_tf32(p)
            b = slice(s0, s0 + STAGE)
            if not split:
                return torch.einsum("tl,tld->td", ph, vh[:, b])
            return (torch.einsum("tl,tld->td", ph, vl[:, b]) +
                    torch.einsum("tl,tld->td", pl, vh[:, b]) +
                    torch.einsum("tl,tld->td", ph, vh[:, b]))
        out[:, h] = _online(s * sc2, pv, lens)
    return out.numpy()


def _emulate_int8(q, kq, ks, vq, vs, tables, lens):
    """The int8 pool's products: the integers exact in bf16, q split into
    bf16 hi + lo, the K scale on the scores, P times the V scale split
    into bf16 hi + lo."""
    q = torch.from_numpy(q)
    sc2 = (1.0 / math.sqrt(D)) * LOG2E
    idx = torch.from_numpy(tables).long().clamp(min=0)
    ksc = ks[idx].reshape(T_ROWS, P * PS)
    vsc = vs[idx].reshape(T_ROWS, P * PS)
    out = torch.empty(T_ROWS, HEADS, D)
    for h in range(HEADS):
        k = _gather(kq, tables, h).float()
        v = _gather(vq, tables, h).float()
        qh, ql = _split_bf16(q[:, h])
        s = (torch.einsum("td,tld->tl", ql, k) +
             torch.einsum("td,tld->tl", qh, k)) * sc2 * ksc

        def pv(p, s0, v=v):
            b = slice(s0, s0 + STAGE)
            ph, pl = _split_bf16(p * vsc[:, b])
            return (torch.einsum("tl,tld->td", pl, v[:, b]) +
                    torch.einsum("tl,tld->td", ph, v[:, b]))
        out[:, h] = _online(s, pv, lens)
    return out.numpy()


def _jax_f32(q, kp, vp, tables, lens):
    return np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens)))


def test_3xtf32_emulation_matches_jax_on_the_mixed_tick():
    args = _mixed_tick()
    want = _jax_f32(*args)
    got = _emulate_f32(*args)
    err = np.abs(got - want).max()
    assert err <= F32_TOL, err


def test_one_tf32_product_misses_the_f32_limit():
    args = _mixed_tick()
    want = _jax_f32(*args)
    err = np.abs(_emulate_f32(*args, split=False) - want).max()
    assert err > F32_TOL, err


def test_int8_split_emulation_matches_jax_on_the_mixed_tick():
    q, kp, vp, tables, lens = _mixed_tick(seed=1)
    (kq, ks), (vq, vs) = (tpa.quantize_kv(torch.from_numpy(x))
                          for x in (kp, vp))
    want = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q),
        jpa.QuantizedKV(jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy())),
        jpa.QuantizedKV(jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy())),
        jnp.asarray(tables), jnp.asarray(lens)))
    got = _emulate_int8(q, kq, ks, vq, vs, tables, lens)
    err = np.abs(got - want).max()
    assert err <= I8_TOL, err
