"""Host -> device input pipeline: decode on a producer thread, stage ahead
of compute, normalise on the device.

Counterpart of the JAX package's data/pipeline.py:

  * a producer thread maps the load function over the items (JPEG/PNG
    decode and resizes release the GIL, so a thread overlaps them with the
    consumer's device work), in order, into a bounded queue;
  * each loaded item is staged on the target device before it is queued,
    so up to ``depth`` items are resident on the card while the consumer
    computes on the current one. On CUDA the numpy arrays are copied into
    pinned host memory (PyTorch's caching host allocator, so the pinned
    blocks are reused rather than allocated per item) and then to the
    device with ``non_blocking=True`` on a side stream of the producer's
    own. The consumer's stream waits on an event recorded after the
    copies, and ``record_stream`` marks each staged tensor as used by the
    consumer's stream, so the caching allocator cannot hand its memory out
    again before the consumer's work on it is done. On the CPU the arrays
    become tensors and nothing is pinned;
  * an exception in the load function or in a copy is raised in the
    consumer; nothing falls back to the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from dmm_net_tpu_torch import resolve_device

# ImageNet statistics: the backbone is trained on ImageNet-normalised inputs.
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize_frames(frames) -> torch.Tensor:
    """uint8/float frames (..., H, W, 3) -> ImageNet-normalised float32, on
    the frames' device (numpy input becomes a CPU tensor)."""
    frames = torch.as_tensor(frames)
    x = frames.float()
    if frames.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def _map(fn, tree):
    """Apply ``fn`` to every array or tensor leaf of nested dicts, lists and
    tuples; other leaves are kept."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


class Prefetcher:
    """Bounded look-ahead: a producer thread maps ``load_fn`` over ``items``
    and stages the results on ``device``; iterating yields them in order,
    already resident there. Runs on CUDA unless ``device`` says otherwise.

    Iterate once. Leaving the loop early stops the producer (``close``)."""

    def __init__(self, items: Iterable, load_fn: Callable[[object], dict],
                 depth: int = 2, device=None):
        self._items = iter(items)
        self._load = load_fn
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _stage_cuda(self, batch, stream):
        """Pinned host copy, then an asynchronous copy on ``stream``;
        returns the staged batch and an event recorded after its copies."""
        def put(x):
            x = _as_tensor(x)
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            # the caching host allocator records this copy on `stream` and
            # keeps the pinned block from reuse until the copy has finished
            return host.to(self._device, non_blocking=True)

        with torch.cuda.stream(stream):
            staged = _map(put, batch)
            ready = torch.cuda.Event()
            ready.record(stream)
        return staged, ready

    def _put(self, x) -> bool:
        """Queue ``x`` unless the consumer has closed; True when queued."""
        while not self._stop.is_set():
            try:
                self._q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        try:
            stream = None
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)     # per-thread state
                stream = torch.cuda.Stream(self._device)
            for it in self._items:
                batch = self._load(it)
                staged = (self._stage_cuda(batch, stream) if stream is not None
                          else (_map(_as_tensor, batch), None))
                if not self._put(staged):
                    return
        except BaseException as e:      # re-raised in the consumer
            self._err = e
        finally:
            self._put(self._done)

    # -- consumer ----------------------------------------------------------
    def __iter__(self) -> Iterator:
        try:
            while True:
                out = self._q.get()
                if out is self._done:
                    if self._err is not None:
                        raise self._err
                    return
                staged, ready = out
                if ready is not None:
                    consumer = torch.cuda.current_stream(self._device)
                    consumer.wait_event(ready)
                    _map(lambda t: t.record_stream(consumer), staged)
                yield staged
        finally:
            self.close()

    def close(self) -> None:
        """Stop the producer and drop what it has staged."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(10.0)


class RingStager:
    """Single-stream stager for per-frame inference: keeps the next
    ``depth`` frame items resident on the device while the current one
    computes. A Prefetcher with the identity load; the source iterator
    (which decodes) runs on the producer thread."""

    def __init__(self, stream: Iterable[dict], depth: int = 2, device=None):
        self._pf = Prefetcher(stream, lambda x: x, depth=depth, device=device)

    def __iter__(self):
        return iter(self._pf)
