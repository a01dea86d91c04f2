"""Global flag registry of the PyTorch port.

A copy of ``paddle_tpu/core/flags.py``'s typed registry, holding only the
flags the port reads. Flags are declared with a type, default and help
string; values can be overridden from the environment
(``PTPU_FLAGS_<name>`` or ``FLAGS_<name>``) at import time or
programmatically via ``set_flags``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Mapping


class FlagError(KeyError):
    pass


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str
    value: Any
    validator: Callable[[Any], bool] | None = None


_REGISTRY: Dict[str, _Flag] = {}
_LOCK = threading.RLock()
_ENV_PREFIX = "PTPU_FLAGS_"


def _coerce(flag_type: type, raw: Any) -> Any:
    if isinstance(raw, flag_type):
        return raw
    if flag_type is bool:
        if isinstance(raw, str):
            low = raw.strip().lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"cannot parse boolean flag value {raw!r}")
        return bool(raw)
    return flag_type(raw)


def define_flag(name: str, default: Any, help: str = "",
                flag_type: type | None = None,
                validator: Callable[[Any], bool] | None = None) -> None:
    """Declare a flag. Environment override ``PTPU_FLAGS_<name>`` wins
    over the default."""
    with _LOCK:
        if name in _REGISTRY:
            raise FlagError(f"flag {name!r} already defined")
        ftype = flag_type or type(default)
        value = default
        env = os.environ.get(_ENV_PREFIX + name)
        if env is None:
            env = os.environ.get("FLAGS_" + name)
        if env is not None:
            value = _coerce(ftype, env)
        if validator is not None and not validator(value):
            raise ValueError(f"invalid value {value!r} for flag {name!r}")
        _REGISTRY[name] = _Flag(name, default, ftype, help, value, validator)


def get_flags(names: str | Iterable[str] | None = None) -> Dict[str, Any]:
    with _LOCK:
        if names is None:
            return {k: f.value for k, f in _REGISTRY.items()}
        if isinstance(names, str):
            names = [names]
        out = {}
        for n in names:
            if n not in _REGISTRY:
                raise FlagError(f"unknown flag {n!r}")
            out[n] = _REGISTRY[n].value
        return out


def get_flag(name: str) -> Any:
    return get_flags([name])[name]


def set_flags(flags: Mapping[str, Any]) -> None:
    with _LOCK:
        for name, raw in flags.items():
            if name not in _REGISTRY:
                raise FlagError(f"unknown flag {name!r}")
            f = _REGISTRY[name]
            value = _coerce(f.type, raw)
            if f.validator is not None and not f.validator(value):
                raise ValueError(f"invalid value {value!r} for flag {name!r}")
            f.value = value


define_flag("check_nan_inf", False,
            "Test every train step's loss for NaN/Inf and raise "
            "FloatingPointError; the device loss is buffered and tested at "
            "the next metric drain (a log boundary), not per step.")
define_flag("default_dtype", "float32",
            "Default floating dtype for new parameters.")
define_flag("amp_dtype", "bfloat16",
            "Compute dtype used by amp.auto_cast.")
define_flag("recompile_warn_threshold", 8,
            "Warn when Model train/eval steps have seen more than this "
            "many distinct input (shape, dtype) signatures (pad or bucket "
            "variable-length data -- see io.sequence). 0 disables the "
            "guard.")
define_flag("flash_attention", True,
            "Dispatch scaled_dot_product_attention to the flash kernels "
            "(B1 forward, B2 + B3 backward) when "
            "flash_attention_available says the configuration fits.")
define_flag("steps_per_loop", 1,
            "Default number of optimizer steps Model.fit runs as ONE "
            "train_loop_batch call over a [K, batch, ...] superbatch "
            "(io.DataLoader.superbatches): K steps back to back with "
            "losses and metric outputs stacked on the device and no host "
            "sync inside the slab. K=1 keeps the per-batch path. Losses "
            "are bit-identical to K=1 (step i of the slab runs under "
            "rng.split_for_step(step0 + i)). fit(steps_per_loop=...) "
            "overrides per call.",
            validator=lambda v: v >= 1)
define_flag("numeric_guard", False,
            "Arm the numeric guard (reliability/guard.py) with a default "
            "GuardPolicy() in Model.prepare when no explicit "
            "numeric_guard= policy is passed: a finite mask over the "
            "loss and the gradients, the global grad norm and a loss-"
            "spike EMA computed on the device every step, tripped steps "
            "masked to exact no-op updates. Off: the train path runs no "
            "guard op and pays one attribute check.")
define_flag("decode_ticks_per_dispatch", 1,
            "Default for LLMEngine(decode_ticks_per_dispatch=...): decode "
            "ticks issued back to back as one slab (a DecodeCarry loop) "
            "before the host reads the tokens. Token-identical to 1.",
            validator=lambda v: v >= 1)
define_flag("mixed_tick", True,
            "Default for LLMEngine(mixed_tick=...): serve prefill chunk "
            "rows and decode rows as one ragged batch per tick. "
            "Token-identical to the alternating prefill-chunk/decode-tick "
            "loop; the default yields to lookahead.")
define_flag("kv_dtype", "",
            "Default storage dtype for LLMEngine's paged KV pool: "
            "'int8' (quantized pages + per-token f32 scales), "
            "'bf16'/'f16'/'f32' (plain pools), or empty to keep the "
            "engine's cache_dtype argument (default f32).")
define_flag("spec_slab", True,
            "Default for LLMEngine(spec_slab=...): run speculative "
            "draft-K/verify-1 rounds on the device as a DecodeCarry slab "
            "(K chained draft probes, one ragged verify window and the "
            "accept/rollback masking per round, N rounds back to back "
            "before the host reads the tokens); greedy and "
            "temperature > 0. False keeps the legacy host-orchestrated "
            "greedy round (one round per host read, bucketed one-shot "
            "prefill, no prefix cache).")
define_flag("perf_observability", True,
            "Arm the continuous perf observability registry "
            "(observability/perf.py): the analytic cost of each "
            "engine program signature + measured dispatch wall "
            "time -> live perf_mfu / perf_hbm_bw_util / "
            "perf_flops_per_second gauges and the GET /perfz "
            "breakdown. Off: the train/serving hot paths pay one "
            "module-flag check and record nothing (pinned like "
            "tracing; read at import — flip at runtime with "
            "observability.perf.enable()/disable()).")
define_flag("perf_peak_flops", 0.0,
            "Override the per-backend peak FLOP/s table used as the "
            "MFU denominator (observability/perf.py PEAK_TABLE) — the "
            "knob for cards the table does not know, or for "
            "power-capped cards. 0 keeps the table (CPU falls back to "
            "a nominal placeholder).")
define_flag("perf_peak_hbm_gbps", 0.0,
            "Override peak HBM bandwidth in GB/s for the "
            "perf_hbm_bw_util denominator. 0 keeps the table/fallback.")
define_flag("mem_observability", True,
            "Arm the HBM attribution ledger (observability/memory.py): "
            "owners (Model device trees, the engine's paged KV pool, "
            "DecodeCarry scratch, checkpoint staging buffers) register "
            "attributed reservations at allocation boundaries, "
            "reconciled each read against device.memory_stats() with "
            "an explicit unattributed residual -> GET /memz, "
            "mem_bytes{owner,kind} / mem_watermark_bytes / "
            "mem_headroom_pages gauges, and OOM flight-dump "
            "forensics. Off: every call site pays one module-flag "
            "check and records nothing (pinned like tracing/perf; "
            "read at import — flip at runtime with "
            "observability.memory.enable()/disable()).")
define_flag("mem_near_oom_fraction", 0.92,
            "Near-OOM threshold for the memory ledger's one-shot "
            "forensic snapshot: when device bytes_in_use crosses this "
            "fraction of bytes_limit at any ledger read, the "
            "attribution table is dumped through the flight recorder "
            "ONCE (reason near_oom) — the pre-crash baseline an "
            "actual RESOURCE_EXHAUSTED dump diffs against. 0 "
            "disables.", flag_type=float)
define_flag("goodput_observability", True,
            "Arm the wall-clock time ledger (observability/goodput.py):"
            " hot paths attribute every second since arming to one "
            "bucket (productive / compile / input_wait / ckpt_stall / "
            "recovery / migration / audit / shed / queue_wait, plus "
            "derived "
            "host_gap and an "
            "explicit unattributed residual) -> GET /goodputz, "
            "goodput_fraction / badput_seconds_total{cause} gauges, "
            "SLO-trip watermark forensics, fleet_goodput_fraction "
            "federation. Off: every call site pays one module-flag "
            "check and records nothing (pinned like tracing/perf/mem; "
            "read at import — flip at runtime with "
            "observability.goodput.enable()/disable()).")
define_flag("stream_audit", True,
            "Arm the stream-integrity auditor (observability/audit.py):"
            " every request carries a rolling blake2b chain over "
            "(nonce, position, token_id) extended at the engine's "
            "drain boundary and returned as stream_digest; the fleet "
            "router verifies chains wherever token identity is "
            "claimed (nonce-pinned failover/device-retry, migrated-"
            "page decodes, sampled shadow re-executions) -> GET "
            "/driftz, drift_verified_total / "
            "drift_divergence_total{kind} counters (never-armed "
            "process exports neither — federation reads the absence "
            "as a HOLE), one-shot stream_divergence flight dumps. "
            "Off: the drain path pays one module-flag check per "
            "token and nothing else (pinned like tracing/perf/mem/"
            "goodput; flip at runtime with "
            "observability.audit.enable()/disable()).")
define_flag("audit_shadow_rate", 0.0,
            "Sampled SHADOW RE-EXECUTION rate for the stream auditor "
            "(0.0-1.0): the fraction of verified router requests "
            "re-executed off-path on the SAME replica under the SAME "
            "nonce, chain diffed against the served stream "
            "(drift_divergence_total{kind=shadow} on mismatch, with "
            "the first divergent position). Sampling is a "
            "deterministic hash of the request nonce, so a replayed "
            "seed shadows the same requests. The shadow re-spends "
            "the request's device time — its seconds land in the "
            "'audit' badput bucket; see docs/OBSERVABILITY.md "
            "('Stream integrity') for costing guidance. 0 disables "
            "shadows (chain checks still run).", flag_type=float)
