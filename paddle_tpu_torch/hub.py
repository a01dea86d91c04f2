"""paddle_tpu_torch.hub: model hub loader (the port's copy of
``paddle_tpu/hub.py``; ref: python/paddle/hapi/hub.py — torch.hub-like
``paddle.hub.list/help/load`` driven by a repo's hubconf.py).

Only ``source="local"`` is supported: github / gitee sources raise with
a clear message instead of reaching for the network."""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import Any, List

HUBCONF = "hubconf.py"


def _load_hubconf(repo_dir: str):
    path = os.path.join(repo_dir, HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {HUBCONF} in {repo_dir!r}")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["hubconf"] = mod
    spec.loader.exec_module(mod)
    return mod


def _check_source(source: str):
    if source != "local":
        raise NotImplementedError(
            f"hub source {source!r} needs network access; clone the repo "
            "and use source='local'")


def list(repo_dir: str, source: str = "local") -> List[str]:  # noqa: A001
    """Entrypoints exported by the repo's hubconf (ref: hub.py list)."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return sorted(n for n, v in vars(mod).items()
                  if callable(v) and not n.startswith("_"))


def help(repo_dir: str, model: str, source: str = "local") -> str:  # noqa: A001
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return getattr(mod, model).__doc__ or ""


def load(repo_dir: str, model: str, *args, source: str = "local",
         **kwargs) -> Any:
    """Instantiate entrypoint ``model`` from the repo (ref: hub.py load)."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    if not hasattr(mod, model):
        raise ValueError(
            f"no entrypoint {model!r}; available: {list(repo_dir)}")
    return getattr(mod, model)(*args, **kwargs)
