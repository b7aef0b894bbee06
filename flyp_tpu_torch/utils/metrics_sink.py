"""Experiment metric sink: the trainer's records as lines of
``<log_dir>/metrics.jsonl``.

Counterpart of ``flyp_tpu/utils/metrics_sink.py``, with the same records:
each line is ``{"ts": <unix time>, **record}``, scalars as floats.  Like the
JAX package, the sink also logs to wandb when that package imports and
initialises (it is not installed on the card's machine).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _clean(v):
    """Scalars (numpy, torch, 0-d or size 1) as floats, larger arrays as
    lists; a logging call must not raise on an array."""
    if isinstance(v, torch.Tensor):
        return float(v) if v.numel() == 1 else v.detach().cpu().tolist()
    if hasattr(v, "item"):
        return float(v) if getattr(v, "size", 1) == 1 else np.asarray(v).tolist()
    return v


class MetricsSink:
    def __init__(self, log_dir: Optional[str], enabled: bool = True, project: str = "sd_exprs", config=None,
                 name=None, group=None):
        self.enabled = enabled
        self._file = None
        self._wandb = None
        if not enabled:
            return
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:  # pragma: no cover - wandb is not installed here or on the card's machine
            import wandb

            wandb.init(project=project, config=config, name=name, group=group)
            self._wandb = wandb
        except Exception:
            self._wandb = None

    def log(self, record: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        if self._file is not None:
            clean = {k: _clean(v) for k, v in record.items()}
            self._file.write(json.dumps({"ts": time.time(), **clean}) + "\n")
            self._file.flush()
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(record)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()
            self._wandb = None
