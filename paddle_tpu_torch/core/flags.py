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


define_flag("default_dtype", "float32",
            "Default floating dtype for new parameters.")
define_flag("decode_ticks_per_dispatch", 1,
            "Default for LLMEngine(decode_ticks_per_dispatch=...). The "
            "port runs one decode tick per dispatch; values above 1 (the "
            "fused decode slab) raise NotImplementedError until that "
            "feature is ported.",
            validator=lambda v: v >= 1)
define_flag("mixed_tick", False,
            "Default for LLMEngine(mixed_tick=...). OFF in the port: the "
            "engine runs the alternating prefill-chunk/decode-tick loop, "
            "which the JAX package pins token-identical to the mixed "
            "tick. True raises NotImplementedError until the mixed tick "
            "is ported.")
define_flag("kv_dtype", "",
            "Default storage dtype for LLMEngine's paged KV pool: "
            "'int8' (quantized pages + per-token f32 scales), "
            "'bf16'/'f16'/'f32' (plain pools), or empty to keep the "
            "engine's cache_dtype argument (default f32).")
