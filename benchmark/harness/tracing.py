"""Spans from the benchmark's own files, the traced window, and the
reduction of torch.profiler's trace to what the per-layer readers read.

Spans: ``record_function`` ranges around the window, each request and each
step (``bench/window``, ``bench/request``, ``bench/step``), and ranges that
forward pre-hooks and hooks open and close around named modules of the
model (``bench/backbone``, ``bench/feat_proj``, ``bench/decoder``,
``bench/frame_step``) and around the optimizer's update
(``bench/optimizer``). Nothing here edits the program.

The profiler's Chrome trace is written to a temporary file, read back and
deleted. A kernel belongs to a host span when the runtime call that
launched it (matched by its correlation id) lies inside the span on the
same host thread.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class ModuleSpans:
    """Opens a ``record_function`` range named ``bench/<name>`` before each
    call of each named module and closes it after."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.handles, self.open = [], defaultdict(list)
        for name, mod in modules.items():
            self.handles.append(mod.register_forward_pre_hook(self._enter(name)))
            self.handles.append(mod.register_forward_hook(self._exit(name)))

    def _enter(self, name):
        def hook(mod, args):
            rf = torch.profiler.record_function(f"bench/{name}")
            rf.__enter__()
            self.open[name].append(rf)
        return hook

    def _exit(self, name):
        def hook(mod, args, out):
            self.open[name].pop().__exit__(None, None, None)
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


def wrap_method(obj, attr: str, span: str):
    """Run ``obj.attr`` inside a ``record_function`` range (on this
    instance only)."""
    fn = getattr(obj, attr)

    def wrapped(*a, **k):
        with torch.profiler.record_function(span):
            return fn(*a, **k)
    setattr(obj, attr, wrapped)


class Trace:
    """The traced window's device operations and host spans."""

    def __init__(self, events: List[dict], window_s: Optional[float] = None):
        xs = [e for e in events if e.get("ph") == "X"]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.launch = [e for e in xs if e.get("cat") in LAUNCH_CATS]
        self.ranges = [e for e in xs if e.get("cat") in ("user_annotation", "cpu_op")]
        win = [e for e in self.ranges if e["name"] == "bench/window"]
        if win:
            w = win[0]
            self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
            self.main_tid = (w["pid"], w["tid"])
        elif window_s is not None:     # a device-only trace: the host clock's window
            self.w0 = min((float(e["ts"]) for e in self.device), default=0.0)
            self.w1 = self.w0 + window_s * 1e6
            self.main_tid = None
        else:
            raise RuntimeError("the trace holds no bench/window range")
        self.device = [e for e in self.device
                       if self.w0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= self.w1 + 1.0]
        self.by_corr = defaultdict(list)
        for e in self.device:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                self.by_corr[c].append(e)
        self.launch_by_tid = defaultdict(list)
        for e in self.launch:
            self.launch_by_tid[(e["pid"], e["tid"])].append(e)
        for v in self.launch_by_tid.values():
            v.sort(key=lambda e: float(e["ts"]))
        self.launch_ts = {k: [float(e["ts"]) for e in v] for k, v in self.launch_by_tid.items()}

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device)
        total, cur0, cur1 = 0.0, None, None
        for a, b in ivs:
            if cur1 is None or a > cur1:
                if cur1 is not None:
                    total += cur1 - cur0
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        if cur1 is not None:
            total += cur1 - cur0
        return total * 1e-6

    def kernels(self, contains: Optional[str] = None) -> List[dict]:
        return [e for e in self.device if e.get("cat") == "kernel"
                and (contains is None or contains in e["name"])]

    def spans(self, name: str, exact: bool = True) -> List[dict]:
        return [e for e in self.ranges
                if (e["name"] == name if exact else name in e["name"])]

    def device_in(self, spans: List[dict]) -> List[dict]:
        """Device operations launched inside any of ``spans`` (each counted
        once)."""
        seen, out = set(), []
        for s in spans:
            key = (s["pid"], s["tid"])
            ts = self.launch_ts.get(key, [])
            a, b = float(s["ts"]), float(s["ts"]) + float(s["dur"])
            for e in self.launch_by_tid[key][bisect.bisect_left(ts, a):bisect.bisect_right(ts, b)]:
                c = e.get("args", {}).get("correlation")
                if c in seen:
                    continue
                seen.add(c)
                out += self.by_corr.get(c, [])
        return out

    @staticmethod
    def seconds(ops: List[dict]) -> float:
        return sum(float(e["dur"]) for e in ops) * 1e-6

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        tot = defaultdict(float)
        for e in self.device:
            tot[e["name"][:64]] += float(e["dur"]) * 1e-6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest gaps between device operations, each named by the
        innermost host span (and host op) open on the main thread when it
        began."""
        ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device)
        gaps, end = [], self.w0
        for a, b in ivs:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.w1 > end:
            gaps.append((end, self.w1))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        main = [e for e in self.ranges if (e["pid"], e["tid"]) == self.main_tid]
        out = []
        for g0, g1 in gaps[:top]:
            names = []
            for cat in ("user_annotation", "cpu_op"):
                inner = [e for e in main if e.get("cat") == cat and float(e["ts"]) <= g0
                         <= float(e["ts"]) + float(e["dur"])]
                if inner:
                    names.append(min(inner, key=lambda e: float(e["dur"]))["name"])
            out.append((" > ".join(names) or "(no host span)", (g1 - g0) * 1e-6))
        return out


def profile_window(fn, host: bool = True):
    """Run ``fn()`` under torch.profiler inside a ``bench/window`` range
    that ends after a synchronize; return (fn's result, Trace).

    ``host=True`` records host ops and spans as well as the device's, for
    the readers that attribute device time to spans; the recording slows
    the host. ``host=False`` records the device alone, for the busy and
    idle shares: its window is the host clock's, from before ``fn`` to the
    synchronize."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench/window"):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    if not host and cuda:
        events = [e for e in events if e.get("cat") in DEVICE_CATS]
    return out, Trace(events, window_s)
