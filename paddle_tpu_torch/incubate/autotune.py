"""incubate.autotune — kernel/layout/dataloader tuning config facade
(the port's counterpart of ``paddle_tpu/incubate/autotune.py``).

Reference being replaced: ``paddle.incubate.autotune.set_config``
(python/paddle/incubate/autotune.py) toggling three tuners: "kernel"
(exhaustive cuDNN algo search over warmup steps, phi/kernels/autotune/),
"layout" (NCHW<->NHWC switch pass), and "dataloader" (num_workers
tuning).

The port's decision record, per tuner:
- kernel: the port's hand-written kernels pick their design from dtype
  and shape before each launch (``ops.flash_attention.kernel_route``)
  and torch's library calls choose their own algorithms; there is no
  runtime search to toggle. Accepted and reported as already-enabled.
- layout: convolutions run in the layout their ``data_format`` names;
  accepted as a record of intent.
- dataloader: forwarded to a module-level hint that DataLoader reads
  when ``num_workers='auto'`` (tune between 1 and cpu_count like the
  reference's range).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

_config: Dict = {"kernel": {"enable": True, "tuning_range": None},
                 "layout": {"enable": True},
                 "dataloader": {"enable": False}}


def set_config(config: Optional[Dict] = None) -> None:
    """ref: paddle.incubate.autotune.set_config(config=None|dict|file).

    Accepts the reference's schema; "kernel"/"layout" are records of
    intent (nothing to search at run time), "dataloader" enables worker
    autotuning for DataLoader(num_workers='auto')."""
    global _config
    if config is None:
        _config = {k: {**v, "enable": True} for k, v in _config.items()}
        return
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    for key, val in config.items():
        if key not in _config:
            raise ValueError(f"unknown autotune section {key!r}")
        _config[key].update(val)


def get_config() -> Dict:
    return {k: dict(v) for k, v in _config.items()}


def suggested_num_workers() -> int:
    if not _config["dataloader"].get("enable"):
        return 0
    return min(4, os.cpu_count() or 1)
