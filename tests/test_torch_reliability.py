"""The port engine's failure semantics against the JAX engine's on the
CPU (deadlines, shedding, cancel, admission timeout, the health state
machine, the device-retry budget), both engines in
``make_engine_from_spec``'s geometry on the same weights. Faults come
from each package's own ``reliability.faults`` armed with the same
seeded rule, so a rule fires on the same dispatch in both engines;
submissions land in one scheduler iteration by holding each worker in a
control op while they queue."""

import contextlib
import importlib
import threading

import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

from paddle_tpu_torch.inference import llm as tllm  # noqa: E402
from paddle_tpu_torch.observability import audit as taudit  # noqa: E402
from paddle_tpu_torch.observability import metrics as tmetrics  # noqa: E402
from paddle_tpu_torch.reliability import faults as tfaults  # noqa: E402
from paddle_tpu_torch.reliability.retry import (  # noqa: E402
    DeadlineExceeded as TDeadlineExceeded)

from test_torch_serving import make_engines  # noqa: E402

jllm = importlib.import_module("paddle_tpu.inference.llm")
jfaults = importlib.import_module("paddle_tpu.reliability.faults")
jmetrics = importlib.import_module("paddle_tpu.observability.metrics")
jretry = importlib.import_module("paddle_tpu.reliability.retry")

PROMPTS = [[1, 2, 3, 4], [9, 8, 7, 6, 5, 4, 3, 2, 1, 9, 8],
           [5, 5, 6], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52,
                       53, 54, 55, 56, 57]]
TEMPS = [0.0, 0.8, 0.0, 0.8]


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine), shared by this file's tests; each
    test restores any knob it sets."""
    jeng, teng = make_engines()
    yield jeng, teng
    jeng.close()
    teng.close()


def both(engines):
    return zip(engines, (jllm, tllm), (jfaults, tfaults),
               (jmetrics, tmetrics))


@contextlib.contextmanager
def held(eng):
    """Hold the engine's worker inside a control op, so everything
    submitted meanwhile is admitted in one later iteration."""
    entered, release = threading.Event(), threading.Event()

    def op():
        entered.set()
        release.wait(60)

    fut = eng._post_ctl(op)
    assert entered.wait(60)
    try:
        yield
    finally:
        release.set()
        fut.result(timeout=60)


@contextlib.contextmanager
def knobs(eng, **kw):
    saved = {k: getattr(eng, k) for k in kw}
    for k, v in kw.items():
        setattr(eng, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(eng, k, v)


@contextlib.contextmanager
def armed(faults, *rules, seed=0):
    faults.reset()
    for site, kw in rules:
        faults.inject(site, **kw)
    faults.enable(seed=seed)
    try:
        yield
    finally:
        faults.reset()


def counter(metrics, name):
    fam = metrics.default_registry().get(name)
    return fam.value if fam is not None else 0.0


def pool_is_whole(eng):
    return len(eng._free_pages) + eng._cache.evictable_count == \
        eng.num_pages - 1 and eng._n_queued == 0


def burst(eng, n_new=6, prompts=PROMPTS, temps=TEMPS):
    """The four requests submitted as one batch; their futures."""
    with held(eng):
        return [eng.submit(p, max_new_tokens=n_new, temperature=t,
                           nonce=100 + i)
                for i, (p, t) in enumerate(zip(prompts, temps))]


def test_deadline_resolves_and_the_engine_keeps_serving(engines):
    outs = []
    for eng, exc in zip(engines, (jretry.DeadlineExceeded,
                                  TDeadlineExceeded)):
        doomed = eng.submit([1, 2, 3], max_new_tokens=8, deadline=-1.0)
        with pytest.raises(exc):
            doomed.result(timeout=60)
        outs.append(eng.submit([7, 8, 9], max_new_tokens=3)
                    .result(timeout=60)["output_ids"])
    assert outs[1] == outs[0]
    assert all(pool_is_whole(e) for e in engines)


def test_queue_overflow_sheds_the_same_requests(engines):
    verdicts = []
    for eng, llm, _, _ in both(engines):
        with knobs(eng, max_pending=2):
            futs = burst(eng)
            v = []
            for f in futs:
                try:
                    v.append(f.result(timeout=60)["output_ids"])
                except llm.AdmissionShed as e:
                    assert e.reason == "queue_full"
                    assert "admission queue full" in str(e)
                    v.append("shed")
        verdicts.append(v)
    assert verdicts[0].count("shed") == 2
    assert verdicts[1] == verdicts[0]


def test_generate_wider_than_max_pending_never_sheds(engines):
    prompts = [[i + 1, i + 2, i + 3] for i in range(6)]
    outs = []
    for eng in engines:
        with knobs(eng, max_pending=2):
            outs.append([o["output_ids"]
                         for o in eng.generate(prompts, max_new_tokens=2)])
    assert outs[1] == outs[0]
    assert all(len(o) == 2 for o in outs[1])


def test_cancel_resolves_and_frees_pages(engines):
    for eng, llm, _, _ in both(engines):
        futs = burst(eng, n_new=60, prompts=[[i + 1, i + 2]
                                             for i in range(4)])
        assert all(isinstance(f.request_id, int) for f in futs)
        for f in futs:
            assert eng.cancel(f.request_id)
        for f in futs:
            with pytest.raises(llm.RequestCancelled):
                f.result(timeout=60)
        # unknown / resolved ids are a polite no-op
        assert eng.cancel(futs[0].request_id) is False
        assert eng.cancel(10 ** 9) is False
    for eng in engines:
        eng.submit([3], max_new_tokens=1).result(timeout=60)
        assert pool_is_whole(eng)


def test_cancel_wins_over_a_simultaneous_device_error(engines):
    for eng, llm, faults, _ in both(engines):
        box = {}

        def dying():
            # the cancel lands in the tick the device dies
            eng.cancel(box["fut"].request_id)
            return RuntimeError("device died")

        with armed(faults, ("device.dispatch",
                            dict(nth=1, exc=dying))):
            box["fut"] = eng.submit([1, 2, 3], max_new_tokens=4)
            with pytest.raises(llm.RequestCancelled):
                box["fut"].result(timeout=60)
        eng.submit([3], max_new_tokens=1).result(timeout=60)
        assert pool_is_whole(eng)


def test_admission_timeout_is_typed(engines):
    for eng, llm, _, _ in both(engines):
        hogs = burst(eng, n_new=40, prompts=[[i + 1, i + 2, i + 3]
                                             for i in range(4)])
        with knobs(eng, admit_timeout=0.05):
            with held(eng):
                starved = eng.submit([4, 5, 6], max_new_tokens=4)
                threading.Event().wait(0.1)
            with pytest.raises(llm.AdmissionTimeout,
                               match="admit_timeout"):
                starved.result(timeout=60)
        assert all(h.result(timeout=60)["output_ids"] for h in hogs)
        assert pool_is_whole(eng)


def test_health_walks_to_draining_sheds_and_resets(engines):
    outs = []
    for eng, llm, faults, _ in both(engines):
        with knobs(eng, degraded_after=1, drain_after=2):
            with armed(faults, ("device.dispatch", dict(p=1.0))):
                for want in ("degraded", "draining"):
                    with pytest.raises(faults.FaultInjected):
                        eng.submit([1, 2, 3], max_new_tokens=2).result(
                            timeout=60)
                    assert eng.health == want
                with pytest.raises(llm.AdmissionShed, match="draining"):
                    eng.submit([4, 5], max_new_tokens=2).result(
                        timeout=60)
            eng.reset_health()
            assert eng.health == "healthy"
            outs.append(eng.submit([7, 8, 9], max_new_tokens=3)
                        .result(timeout=60)["output_ids"])
        assert pool_is_whole(eng)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("nth", [2, 3])
def test_device_retry_budget_reproduces_the_streams(engines, nth):
    """The same seeded rule fails the ``nth`` dispatch of the batch in
    both engines; every slotted request is re-admitted under its nonce
    and re-emits the fault-free stream, and the retry counters agree."""
    clean = [[f.result(timeout=60)["output_ids"] for f in burst(eng)]
             for eng in engines]
    assert clean[1] == clean[0]
    retries, faulted = [], []
    for eng, _, faults, metrics in both(engines):
        before = counter(metrics, "llm_device_retries_total")
        with knobs(eng, device_retry_budget=1):
            with armed(faults, ("device.dispatch",
                                dict(nth=nth, times=1))):
                outs = [f.result(timeout=60) for f in burst(eng)]
                assert faults.injected_log() == [("device.dispatch", nth)]
        faulted.append([o["output_ids"] for o in outs])
        retries.append(counter(metrics, "llm_device_retries_total") -
                       before)
        assert not any(o["truncated"] for o in outs)
        assert pool_is_whole(eng)
    assert faulted[0] == faulted[1] == clean[0]
    assert retries[1] == retries[0] >= 1
    assert taudit.instance().counts()["diverged"] == 0
