"""Metrics sink for training: one JSON object per logged step, appended to
``<logdir>/metrics.jsonl`` (the JAX package's MetricsWriter without its
TensorBoard mirror)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
