"""Profiling harness: the counterpart of the JAX package's
utils/profiling.py.

  * ``trace(logdir)`` runs ``torch.profiler`` over the enclosed block (host
    and, where there is a card, CUDA activity) and writes a Chrome trace,
    ``<logdir>/trace.json`` (chrome://tracing or ui.perfetto.dev); it
    yields the profiler, whose ``key_averages()`` sum the time by kernel;
  * ``StageTimer`` accumulates per-stage wall times. Each stage ends by
    synchronising the device of the tensors it is given, where the JAX
    package calls ``block_until_ready``: PyTorch returns before the card
    has finished, so a clock without it measures the enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; write ``<logdir>/trace.json``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _cuda_devices(tree, found: set) -> set:
    """The devices of the CUDA tensors in ``tree`` (nested dicts, lists,
    tuples)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            _cuda_devices(x, found)
    elif isinstance(tree, torch.Tensor) and tree.is_cuda:
        found.add(tree.device)
    return found


class StageTimer:
    """Accumulating wall-clock stage timer that synchronises the card.

    with timer.stage("backbone", sync=feats): ...
    with timer.stage("decoder") as out: out["sync"] = logits
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            for d in _cuda_devices(sync if sync is not None
                                   else out.get("sync"), set()):
                torch.cuda.synchronize(d)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {t * 1e3:9.2f} ms total "
                         f"{t / n * 1e3:8.3f} ms/call x{n:4d} "
                         f"{100 * t / max(total, 1e-9):5.1f}%")
        return "\n".join(lines)
