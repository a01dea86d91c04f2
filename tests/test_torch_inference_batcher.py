"""The port's ``inference.DynamicBatcher`` against the JAX package's.

The scenarios of ``tests/test_inference_serving.py`` (coalescing,
padding, hold-over, refusals, errors, a ragged pack, the close and drain
contract, threaded clients) run through both packages' batchers on one
stub predictor, and give equal traces: ``n_requests``,
``n_device_calls``, the shapes the predictor saw, every output and every
exception's type and message. Where the packing would depend on thread
timing, the stub holds its first call until every request of the
scenario is queued, so both batchers see the same queue."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

pytest.importorskip("torch")

from paddle_tpu import inference as jinf  # noqa: E402
from paddle_tpu_torch import inference as tinf  # noqa: E402


class Stub:
    """y = 2 x rowwise; records the shapes of each call. With ``gate``
    the first call waits for the gate to open."""

    def __init__(self, gate=None, fail=None):
        self.calls = []
        self.gate = gate
        self.fail = fail
        self.lock = threading.Lock()

    def run(self, inputs):
        with self.lock:
            self.calls.append([list(a.shape) for a in inputs])
            first = len(self.calls) == 1
        if first and self.gate is not None:
            assert self.gate.wait(timeout=30)
        if self.fail:
            raise RuntimeError(self.fail)
        return [inputs[0] * 2.0]


def _outcome(fut):
    try:
        return ("ok", [o.tolist() for o in fut.result(timeout=30)])
    except Exception as e:  # the trace records it
        return (type(e).__name__, str(e))


def _trace(b, pred, futs, extra=()):
    return {"n_requests": b.n_requests, "n_device_calls": b.n_device_calls,
            "calls": pred.calls, "outcomes": [_outcome(f) for f in futs],
            "extra": list(extra)}


def _rows(n, value, width=4):
    return [np.full((n, width), float(value), np.float32)]


def _gated(B, requests, max_batch, delay_ms=5):
    """A warm-up request holds the worker in the stub's first call while
    ``requests`` queue, then the gate opens."""
    gate = threading.Event()
    pred = Stub(gate)
    b = B(pred, max_batch=max_batch, max_delay_ms=delay_ms)
    futs = [b.submit(_rows(1, -1))]
    while not pred.calls:
        time.sleep(0.001)
    futs += [b.submit(r) for r in requests]
    gate.set()
    outs = [_outcome(f) for f in futs]
    b.close()
    return {"n_requests": b.n_requests, "n_device_calls": b.n_device_calls,
            "calls": pred.calls, "outcomes": outs}


def coalesce(B):
    return _gated(B, [_rows(1, i) for i in range(8)], 8)


def pad_partial(B):
    pred = Stub()
    with B(pred, max_batch=8, max_delay_ms=5) as b:
        fut = b.submit([np.ones((3, 2), np.float32)])
        out = _outcome(fut)
    return {"calls": pred.calls, "outcome": out,
            "n_device_calls": b.n_device_calls}


def holdover(B):
    return _gated(B, [_rows(5, 1, 2), _rows(5, 3, 2)], 8, delay_ms=30)


def refusals(B):
    pred = Stub()
    errs = []
    with B(pred, max_batch=4, max_delay_ms=1) as b:
        for inputs in ([np.ones((5, 2), np.float32)],
                       [np.ones((2, 2), np.float32),
                        np.ones((3, 2), np.float32)]):
            try:
                b.submit(inputs)
            except ValueError as e:
                errs.append(str(e))
    return {"errors": errs, "calls": pred.calls}


def run_errors(B):
    pred = Stub(fail="device gone")
    with B(pred, max_batch=4, max_delay_ms=1) as b:
        fut = b.submit([np.ones((1, 2), np.float32)])
        out = _outcome(fut)
    return {"outcome": out, "n_device_calls": b.n_device_calls}


def ragged_pack(B):
    """A pack whose rows do not concatenate fails its futures, and the
    worker lives on."""
    t = _gated(B, [[np.ones((1, 4), np.float32)],
                   [np.ones((1, 6), np.float32)]], 8, delay_ms=30)
    pred = Stub()
    with B(pred, max_batch=8, max_delay_ms=1) as b:
        t["after"] = _outcome(b.submit(_rows(1, 1)))
    return t


def close_contract(B):
    pred = Stub()
    b = B(pred, max_batch=4, max_delay_ms=1)
    futs = [b.submit([np.full((1, 2), float(i), np.float32)])
            for i in range(6)]
    b.close()
    alive = b._worker.is_alive()
    try:
        b.submit([np.ones((1, 2), np.float32)])
        late = "accepted"
    except RuntimeError as e:
        late = str(e)
    outs = [_outcome(f) for f in futs]
    return {"alive": alive, "late": late, "outcomes": outs,
            "n_requests": b.n_requests}


def drain(B):
    pred = Stub()
    b = B(pred, max_batch=4, max_delay_ms=1)
    b.close()
    f1, f2 = Future(), Future()
    b._q.put(([np.ones((1, 2), np.float32)], 1, f1))
    b._held = ([np.full((1, 2), 3.0, np.float32)], 1, f2)
    b._drain()
    return {"outcomes": [_outcome(f1), _outcome(f2)], "held": b._held,
            "calls": pred.calls}


def threaded_clients(B):
    """16 client threads: every request served with its own rows (the
    packing depends on timing, so the calls are not compared)."""
    pred = Stub()
    results = {}
    with B(pred, max_batch=4, max_delay_ms=10) as b:
        def client(i):
            results[i] = b.run([np.full((1, 3), float(i),
                                        np.float32)])[0].tolist()

        ts = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
    return {"results": dict(sorted(results.items())),
            "n_requests": b.n_requests,
            "coalesced": b.n_device_calls <= 16,
            "all_full": all(c[0][0] == 4 for c in pred.calls)}


def default_max_batch(B):
    class Meta:
        _meta = {"exported_inputs": [{"shape": [4, 16], "dtype": "float32"}]}

        def run(self, inputs):
            return inputs

    class Dynamic(Meta):
        _meta = {"exported_inputs": [{"shape": ["s0", 16],
                                      "dtype": "float32"}]}

    b = B(Meta())
    b.close()
    try:
        B(Dynamic())
        err = None
    except ValueError as e:
        err = str(e)
    return {"max_batch": b.max_batch, "dynamic": err}


SCENARIOS = [coalesce, pad_partial, holdover, refusals, run_errors,
             ragged_pack, close_contract, drain, threaded_clients,
             default_max_batch]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_same_trace_as_reference(scenario):
    want = scenario(jinf.DynamicBatcher)
    got = scenario(tinf.DynamicBatcher)
    assert got == want
