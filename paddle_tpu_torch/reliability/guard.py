"""The numeric guard (the port's counterpart of
``paddle_tpu/reliability/guard.py``): on-device detection of a bad
step and the skip / rollback / abort policy over its verdicts.

- Device side, torch ops with no host read: ``device_state`` (the loss
  EMA and its count), ``inspect`` (0 healthy, 1 non-finite loss or
  gradient, 2 loss spike above ``ema + (spike_factor - 1) * |ema| +
  spike_margin`` once warmed up; and the global grad L2 norm in
  float32), ``apply_mask``, ``update_state`` and ``mask_pytree``
  (``torch.where`` per tensor). ``Model`` computes each step's update
  out of place and masks it into the parameters, the optimizer state and
  the buffers, so a tripped step is an exact no-op, inside a K-step slab
  too; the verdicts ride the buffered metric drain.
- Host side, copied from the JAX package: ``GuardPolicy.process`` over
  drained verdicts (``skip`` within a budget, ``rollback`` as
  :class:`GuardRollback` with a doubling stride, ``abort`` as
  :class:`GuardAbort` carrying the per-tensor non-finite report, the
  step fingerprint and the fault schedule that replays it, with a
  flight-recorder dump), ``escalate`` and ``status`` (the ``/statusz``
  row).

Exactness of ``skip``: a run that skips step ``s`` equals, bit for bit,
a clean run over the same stream with batch ``s`` removed, when the step
math does not key on the global step (constant learning rate, no
dropout). Fault sites ``data.poison`` and ``grad.nonfinite`` (a NaN
multiplier on the loss) make every path replayable.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..nn import clip as _clip
from ..observability import metrics as _obs
from ..observability import tracing as _trace

_ACTIONS_NONFINITE = ("skip", "rollback", "abort")
_ACTIONS_SPIKE = ("allow", "skip", "rollback", "abort")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _guard_metrics():
    """guard_* instruments. GradScaler's inf/nan skip feeds the same
    families, so scaler skips and guard skips read on one dashboard."""
    reg = _obs.default_registry()
    return {
        "trips": reg.counter(
            "guard_trips_total",
            "numeric-guard detections by detector kind and policy "
            "action", label_names=("kind", "action")),
        "skipped": reg.counter(
            "guard_skipped_steps_total",
            "optimizer steps no-op'd (device-masked) by the numeric "
            "guard or the AMP GradScaler"),
        "rollbacks": reg.counter(
            "guard_rollbacks_total",
            "checkpoint rollbacks triggered by the numeric guard"),
        "grad_norm": reg.gauge(
            "train_grad_norm",
            "global grad L2 norm of the newest drained healthy step "
            "(guard-computed on device, read at drain boundaries)"),
    }


# ---------------------------------------------------------------------------
# device side: torch ops run inside each train step
# ---------------------------------------------------------------------------


def device_state(device=None) -> Dict[str, torch.Tensor]:
    """The EMA carry, on ``device``."""
    return {"ema": torch.zeros((), dtype=torch.float32, device=device),
            "n": torch.zeros((), dtype=torch.int32, device=device)}


def inspect(loss, grads, state, *, spike_factor: float,
            spike_margin: float, warmup_steps: int):
    """One step's verdict (int32: 0 healthy, 1 non-finite loss or
    gradient, 2 loss spike against the EMA) and the global grad L2 norm
    in float32. The finite mask is the authoritative bit: a finite but
    overflowing squared sum does not misclassify."""
    loss = loss.float()
    gs = [g for g in (grads.values() if isinstance(grads, dict) else grads)
          if g.is_floating_point()]
    finite = torch.isfinite(loss)
    sq = torch.zeros((), dtype=torch.float32, device=loss.device)
    if gs and _clip.sharded():
        # fsdp shards: the whole gradient's norm and finiteness
        named = {k: g for k, g in grads.items() if g.is_floating_point()}
        finite = finite & _clip.all_finite(named)
        sq = _clip.sum_squares(named)
    elif gs:
        finite = finite & torch.stack(
            [torch.isfinite(g).all() for g in gs]).all()
        sq = torch.stack([torch.sum(torch.square(g.float()))
                          for g in gs]).sum()
    gnorm = torch.sqrt(sq)
    warmed = state["n"] >= warmup_steps
    # ema + (factor - 1) * |ema|: the margin above the baseline scales
    # with the loss's magnitude, whatever its sign
    thresh = state["ema"] + (spike_factor - 1.0) * torch.abs(
        state["ema"]) + spike_margin
    spike = warmed & (loss > thresh)
    verdict = torch.where(~finite, 1, torch.where(spike, 2, 0)).to(
        torch.int32)
    return verdict, gnorm


def apply_mask(verdict, mask_spikes: bool):
    """Whether this step's update applies: never for a non-finite step;
    for a spike only when the policy answers spikes."""
    bad = verdict == 1
    if mask_spikes:
        bad = bad | (verdict == 2)
    return ~bad


def update_state(state, loss, applied, decay: float):
    """EMA update, only for applied steps with a finite loss (a tripped
    step leaves the baseline as a clean run that never saw the batch
    has it); the first applied loss seeds the EMA."""
    loss = loss.float()
    upd = applied & torch.isfinite(loss)
    ema0 = torch.where(state["n"] == 0, loss, state["ema"])
    ema = torch.where(upd, decay * ema0 + (1.0 - decay) * loss,
                      state["ema"])
    return {"ema": ema, "n": state["n"] + upd.to(torch.int32)}


def mask_pytree(ok, new, old):
    """Per-tensor select over nested dicts: ``new`` where ``ok``, else
    ``old``, so a tripped step keeps every pre-step bit."""
    if isinstance(new, dict):
        return {k: mask_pytree(ok, new[k], old[k]) for k in new}
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    if new != old:
        raise TypeError(
            f"cannot mask a host value on the device ({old!r} -> {new!r})")
    return new


# ---------------------------------------------------------------------------
# host side — the policy engine
# ---------------------------------------------------------------------------


class GuardRollback(RuntimeError):
    """Control-flow escalation: restore the newest verified checkpoint
    and fast-forward the loader cursor ``stride`` batches past the
    offending step. ``Model.fit`` catches this; anything else treating
    it as an error is correct too (manual train_batch loops without a
    checkpoint manager cannot roll back)."""

    def __init__(self, step: int, kind: str, stride: int):
        super().__init__(
            f"numeric guard rollback: {kind} at step {step} "
            f"(fast-forward stride {stride})")
        self.step = int(step)
        self.kind = kind
        self.stride = int(stride)


class GuardAbort(FloatingPointError):
    """Terminal verdict. Subclasses FloatingPointError so existing
    ``check_nan_inf`` catchers keep working; the message carries the
    per-tensor report, the step fingerprint and the replay command,
    and a flight-recorder dump is emitted before the raise."""

    def __init__(self, msg: str, step: int, kind: str):
        super().__init__(msg)
        self.step = int(step)
        self.kind = kind


class GuardPolicy:
    """Response policy over drained guard verdicts.

    - ``on_nonfinite``: ``"skip"`` (default) | ``"rollback"`` |
      ``"abort"``;
    - ``on_spike``: ``"allow"`` (default: record only — the update
      still applies) | ``"skip"`` | ``"rollback"`` | ``"abort"``;
    - ``budget``: total skipped steps tolerated before escalating to
      abort (skips past the budget mean the data or the math is not
      transiently bad);
    - ``max_rollbacks``: rollback attempts before escalating;
    - ``rollback_stride``: batches to fast-forward past the offending
      step on the first rollback — doubled on each repeat trip
      (1, 2, 4, ...) so a poisoned RANGE is eventually cleared;
    - spike detector shape: ``loss > ema + (spike_factor - 1) *
      |ema| + spike_margin`` once ``warmup_steps`` applied steps have
      fed the EMA (``ema_decay``) — equal to ``ema * spike_factor``
      for non-negative losses, and still "magnitude blowup above
      baseline" for negative-loss objectives.
    """

    def __init__(self, on_nonfinite: str = "skip",
                 on_spike: str = "allow", budget: int = 8,
                 max_rollbacks: int = 4, rollback_stride: int = 1,
                 spike_factor: float = 4.0, spike_margin: float = 0.0,
                 warmup_steps: int = 16, ema_decay: float = 0.98):
        if on_nonfinite not in _ACTIONS_NONFINITE:
            raise ValueError(
                f"on_nonfinite={on_nonfinite!r} not in "
                f"{_ACTIONS_NONFINITE}")
        if on_spike not in _ACTIONS_SPIKE:
            raise ValueError(
                f"on_spike={on_spike!r} not in {_ACTIONS_SPIKE}")
        self.on_nonfinite = on_nonfinite
        self.on_spike = on_spike
        self.budget = int(budget)
        self.max_rollbacks = int(max_rollbacks)
        self.rollback_stride = max(int(rollback_stride), 1)
        self.spike_factor = float(spike_factor)
        self.spike_margin = float(spike_margin)
        self.warmup_steps = int(warmup_steps)
        self.ema_decay = float(ema_decay)
        # host-side accounting (surfaced on /statusz)
        self.n_trips = 0
        self.n_skipped = 0
        self.n_rollbacks = 0
        self.n_allowed_spikes = 0
        self.last_trip_step: Optional[int] = None
        self.last_trip_kind: Optional[str] = None

    # -- device hooks --------------------------------------------------------
    @property
    def mask_spikes(self) -> bool:
        """Whether the device no-ops spike steps (any spike response
        except "allow" must not train on the spiked batch — even abort,
        which the host only sees at the next drain)."""
        return self.on_spike != "allow"

    def device_state(self, device=None) -> Dict[str, torch.Tensor]:
        return device_state(device)

    def inspect(self, loss, grads, state):
        return inspect(loss, grads, state,
                       spike_factor=self.spike_factor,
                       spike_margin=self.spike_margin,
                       warmup_steps=self.warmup_steps)

    def update_state(self, state, loss, applied):
        return update_state(state, loss, applied, self.ema_decay)

    # -- the drain-boundary engine -------------------------------------------
    def process(self, verdicts, gnorms, losses, step0: int,
                model=None) -> None:
        """Apply the policy to one drained dispatch's verdicts
        (arrays of length K; ``step0`` is the dispatch's first global
        step). Called from the Model's buffered metric drain — ONE
        host sync per log boundary covers metrics, losses AND guard
        verdicts. Raises :class:`GuardRollback` / :class:`GuardAbort`
        per the policy; plain skips only update accounting (the
        device already no-op'd the update)."""
        verdicts = _host(verdicts).reshape(-1)
        gnorms = _host(gnorms).reshape(-1)
        losses = _host(losses).reshape(-1)
        m = _guard_metrics()
        last_norm = None
        for i, v in enumerate(int(x) for x in verdicts):
            gstep = int(step0) + i
            if v == 0:
                if np.isfinite(gnorms[i]):
                    last_norm = float(gnorms[i])
                continue
            kind = "nonfinite" if v == 1 else "spike"
            action = self.on_nonfinite if v == 1 else self.on_spike
            self.n_trips += 1
            self.last_trip_step = gstep
            self.last_trip_kind = kind
            m["trips"].labels(kind, action).inc()
            if _trace.enabled():
                _trace.start_span("train.guard", attrs={
                    "kind": kind, "action": action, "step": gstep,
                    "loss": repr(float(losses[i])),
                    "grad_norm": repr(float(gnorms[i]))}).end()
            if action == "allow":
                self.n_allowed_spikes += 1
                continue
            if action == "skip":
                self.n_skipped += 1
                m["skipped"].inc()
                if self.n_skipped > self.budget:
                    raise self._abort(
                        gstep, kind, model, losses[i], gnorms[i],
                        reason=f"skip budget exhausted "
                               f"({self.n_skipped} > {self.budget})")
                continue
            if action == "rollback":
                self.n_rollbacks += 1
                m["rollbacks"].inc()
                if self.n_rollbacks > self.max_rollbacks:
                    raise self._abort(
                        gstep, kind, model, losses[i], gnorms[i],
                        reason=f"rollback budget exhausted "
                               f"({self.n_rollbacks} > "
                               f"{self.max_rollbacks})")
                stride = self.rollback_stride * (
                    2 ** (self.n_rollbacks - 1))
                raise GuardRollback(gstep, kind, stride)
            raise self._abort(gstep, kind, model, losses[i],
                              gnorms[i], reason="policy abort")
        if last_norm is not None:
            m["grad_norm"].set(last_norm)

    def escalate(self, step: int, kind: str, reason: str,
                 model=None) -> GuardAbort:
        """Build (and flight-dump) an abort outside ``process`` — the
        path ``Model.fit`` uses when a rollback is requested but no
        checkpoint manager is armed."""
        return self._abort(step, kind, model, np.nan, np.nan,
                           reason=reason)

    def _abort(self, step: int, kind: str, model, loss, gnorm,
               reason: str) -> GuardAbort:
        """The abort verdict: per-tensor non-finite report
        (amp.debugging), step/batch fingerprint, deterministic replay
        command, and a flight-recorder dump carrying all of it."""
        bad = []
        fingerprint: Dict[str, Any] = {"step": int(step), "kind": kind}
        if model is not None:
            try:
                from ..amp.debugging import find_nonfinite
                bad = find_nonfinite(model._named_state())
            except Exception:  # noqa: BLE001 — attribution best-effort
                bad = []
            fingerprint["batch_shapes"] = getattr(
                model, "_last_batch_shapes", None)
        replay = self._replay_command()
        msg = (f"numeric guard abort ({reason}): {kind} at step "
               f"{step}, loss={float(loss)!r}, "
               f"grad_norm={float(gnorm)!r}; non-finite tensors: "
               f"{bad or ['(loss/grads only)']}; replay: {replay}")
        try:
            from ..observability.flight import dump_flight_record
            dump_flight_record(
                f"guard_abort_step{int(step)}",
                extra={"what": "numeric_guard_abort", "reason": reason,
                       "kind": kind, "fingerprint": fingerprint,
                       "loss": repr(float(loss)),
                       "grad_norm": repr(float(gnorm)),
                       "nonfinite_tensors": bad[:16],
                       "replay": replay,
                       "policy": self.status()})
        except Exception:  # noqa: BLE001 — never mask the abort
            pass
        return GuardAbort(msg, step, kind)

    def _replay_command(self) -> str:
        from . import faults
        if not faults.enabled():
            return ("faults not armed (organic trip) — rerun with "
                    "faults.enable(seed=...) + a data.poison/"
                    "grad.nonfinite schedule to reproduce injected "
                    "trips")
        tail = faults.injected_log()[-4:]
        return (f"faults.enable(seed={faults.seed()}) with the same "
                f"data.poison/grad.nonfinite rules  # injected tail: "
                f"{tail}")

    # -- introspection -------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """The /statusz bundle (Model's provider embeds it)."""
        return {
            "on_nonfinite": self.on_nonfinite,
            "on_spike": self.on_spike,
            "trips": self.n_trips,
            "skipped": self.n_skipped,
            "skip_budget": self.budget,
            "skip_budget_left": max(self.budget - self.n_skipped, 0),
            "rollbacks": self.n_rollbacks,
            "allowed_spikes": self.n_allowed_spikes,
            "last_trip_step": self.last_trip_step,
            "last_trip_kind": self.last_trip_kind,
        }
