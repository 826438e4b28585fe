"""Clip-consistent training augmentation: the counterpart of the JAX
package's data/augment.py, in numpy without cv2.

Horizontal flip, scale jitter with a crop or a reflect pad back to the
clip's size, and photometric jitter, each with the SAME parameters for
every frame of a clip (temporal consistency is what the recurrent decoder
learns from). Geometry moves frames, ground-truth, template and proposal
masks together; validity masks are untouched. It runs in the loader thread
of data/pipeline.Prefetcher, so it overlaps the device's work.

The JAX package resizes with cv2; ``_resize_nhwc`` reproduces cv2.resize:
INTER_LINEAR for frames (half-pixel centres, taps clamped at the border,
float32 weights, no antialias; horizontal pass, then vertical) and
INTER_NEAREST for masks (source index floor(dst * (1 / (dst / src))),
clamped; not PIL's rule). Every random number is drawn from the same
``RandomState(seed * 9973 + b)`` in the same order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _linear_taps(n_in: int, n_out: int):
    """cv2 INTER_LINEAR source taps and float32 weights along one axis."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    w1 = f - i0.astype(np.float32)
    below, above = i0 < 0, i0 >= n_in - 1
    w1[below | above] = 0.0
    i0[below] = 0
    i0[above] = n_in - 1
    return i0, np.minimum(i0 + 1, n_in - 1), np.float32(1.0) - w1, w1


def _nearest_taps(n_in: int, n_out: int) -> np.ndarray:
    """cv2 INTER_NEAREST source index along one axis."""
    inv = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64),
                      n_in - 1)


def _resize_axes(x: np.ndarray, H: int, W: int, ay: int, ax: int,
                 nearest: bool) -> np.ndarray:
    if nearest:
        x = np.take(x, _nearest_taps(x.shape[ax], W), axis=ax)
        return np.take(x, _nearest_taps(x.shape[ay], H), axis=ay)
    x = x.astype(np.float32)

    def lerp(x, axis, n):
        i0, i1, w0, w1 = _linear_taps(x.shape[axis], n)
        shape = [1] * x.ndim
        shape[axis] = n
        return (np.take(x, i0, axis=axis) * w0.reshape(shape)
                + np.take(x, i1, axis=axis) * w1.reshape(shape))

    return lerp(lerp(x, ax, W), ay, H)


def _resize_nhwc(x: np.ndarray, H: int, W: int, nearest: bool) -> np.ndarray:
    """Resize the last (H, W[, C]) dims of an array of any leading shape,
    the trailing axis read as channels when it has 1 or 3 entries (as the
    JAX package's helper reads it)."""
    if x.ndim >= 3 and x.shape[-1] in (1, 3):
        return _resize_axes(x, H, W, x.ndim - 3, x.ndim - 2, nearest)
    return _resize_axes(x, H, W, x.ndim - 2, x.ndim - 1, nearest)


def augment_clip(batch_item: Dict[str, np.ndarray], rng: np.random.RandomState,
                 flip_prob: float = 0.5, scale_range=(0.8, 1.2),
                 brightness: float = 0.15, contrast: float = 0.15
                 ) -> Dict[str, np.ndarray]:
    """Augment one clip (no batch dim):
      frames (T, H, W, 3) float[0,1] or uint8
      gt_masks (T, M, H, W), prop_masks (T, N, H, W), tmpl_masks (M, H, W)
    Returns a new dict with the same keys/shapes."""
    out = dict(batch_item)
    frames = out["frames"]
    T, H, W = frames.shape[:3]
    was_uint8 = frames.dtype == np.uint8
    frames = frames.astype(np.float32) / (255.0 if was_uint8 else 1.0)

    # ---- horizontal flip ----
    if rng.rand() < flip_prob:
        frames = frames[:, :, ::-1].copy()
        for k in ("gt_masks", "prop_masks"):
            out[k] = out[k][..., ::-1].copy()
        out["tmpl_masks"] = out["tmpl_masks"][..., ::-1].copy()

    # ---- scale jitter + crop back to (H, W) ----
    s = rng.uniform(*scale_range)
    if abs(s - 1.0) > 1e-3:
        nh, nw = max(int(round(H * s)), H // 2), max(int(round(W * s)), W // 2)
        frames = _resize_nhwc(frames, nh, nw, nearest=False)
        gt = _resize_nhwc(out["gt_masks"], nh, nw, nearest=True)
        pm = _resize_nhwc(out["prop_masks"], nh, nw, nearest=True)
        tm = _resize_nhwc(out["tmpl_masks"], nh, nw, nearest=True)
        if s > 1.0:   # crop
            y0 = rng.randint(0, nh - H + 1)
            x0 = rng.randint(0, nw - W + 1)
            frames = frames[:, y0:y0 + H, x0:x0 + W]
            gt = gt[..., y0:y0 + H, x0:x0 + W]
            pm = pm[..., y0:y0 + H, x0:x0 + W]
            tm = tm[..., y0:y0 + H, x0:x0 + W]
        else:         # pad (reflect frames, zero masks)
            py, px = H - nh, W - nw
            y0, x0 = rng.randint(0, py + 1), rng.randint(0, px + 1)
            frames = np.pad(frames, ((0, 0), (y0, py - y0), (x0, px - x0),
                                     (0, 0)), mode="reflect")

            def zpad(a):
                pad = [(0, 0)] * (a.ndim - 2) + [(y0, py - y0), (x0, px - x0)]
                return np.pad(a, pad)
            gt, pm, tm = zpad(gt), zpad(pm), zpad(tm)
        out["gt_masks"], out["prop_masks"], out["tmpl_masks"] = gt, pm, tm

    # ---- photometric (frames only, clip-consistent) ----
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    mean = frames.mean(axis=(1, 2, 3), keepdims=True)
    frames = np.clip((frames - mean) * c + mean * b, 0.0, 1.0)

    out["frames"] = ((frames * 255).astype(np.uint8) if was_uint8
                     else frames.astype(np.float32))
    return out


def augment_batch(batch: Dict[str, np.ndarray], seed: int,
                  **kw) -> Dict[str, np.ndarray]:
    """Apply augment_clip independently per batch element."""
    B = batch["frames"].shape[0]
    items = []
    for b in range(B):
        rng = np.random.RandomState(seed * 9973 + b)
        item = {k: v[b] for k, v in batch.items()}
        aug = augment_clip({k: item[k] for k in
                            ("frames", "gt_masks", "prop_masks", "tmpl_masks")},
                           rng, **kw)
        item.update(aug)
        items.append(item)
    return {k: np.stack([it[k] for it in items]) for k in batch}
