"""Host-side proposal compactification: full-res masks -> (boxes, 28x28)
(numpy only; a copy of the JAX package's infer/compact.py).

The engine's compact path ships boxes (N, 4) plus box-local mask crops
(N, mh, mw) to the device and pastes them onto the mask grid there
(``InferenceEngine._frame_step_compact``): ~0.4 MB per frame instead of
~58 MB at 256x448, N=128. The crop is the inverse of
``models/proposal/maskrcnn.paste_masks``: the same half-pixel convention,
bilinear sampling, so a compactify -> paste round trip reconstructs the
mask up to the 28x28 band limit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def masks_to_boxes(masks: np.ndarray, thresh: float = 0.5) -> np.ndarray:
    """Tight pixel-edge boxes for a stack of masks.

    masks (N, H, W) float/bool -> boxes (N, 4) float32 [x1, y1, x2, y2] in
    pixel-edge coordinates (x2/y2 exclusive: a mask occupying column c has
    box x1=c, x2=c+1). Empty masks get a degenerate 1x1 box at the origin.
    """
    m = np.asarray(masks) > thresh
    N, H, W = m.shape
    boxes = np.zeros((N, 4), np.float32)
    any_row = m.any(axis=2)          # (N, H)
    any_col = m.any(axis=1)          # (N, W)
    for i in range(N):
        rows = np.flatnonzero(any_row[i])
        cols = np.flatnonzero(any_col[i])
        if rows.size == 0:
            boxes[i] = (0.0, 0.0, 1.0, 1.0)
            continue
        boxes[i] = (cols[0], rows[0], cols[-1] + 1.0, rows[-1] + 1.0)
    return boxes


def _bilinear_crop(mask: np.ndarray, box: np.ndarray, out: int) -> np.ndarray:
    """Sample an (out, out) box-local grid from a full-res (H, W) mask with
    paste_masks' half-pixel convention."""
    H, W = mask.shape
    x1, y1, x2, y2 = box
    xs = x1 + (np.arange(out) + 0.5) / out * max(x2 - x1, 1e-3)
    ys = y1 + (np.arange(out) + 0.5) / out * max(y2 - y1, 1e-3)
    xi = np.clip(xs - 0.5, 0, W - 1)
    yi = np.clip(ys - 0.5, 0, H - 1)
    x0 = np.floor(xi).astype(np.int64)
    y0 = np.floor(yi).astype(np.int64)
    x1i = np.minimum(x0 + 1, W - 1)
    y1i = np.minimum(y0 + 1, H - 1)
    dx = (xi - x0).astype(np.float32)
    dy = (yi - y0).astype(np.float32)
    g = np.asarray(mask, np.float32)
    top = g[y0][:, x0] * (1 - dx)[None, :] + g[y0][:, x1i] * dx[None, :]
    bot = g[y1i][:, x0] * (1 - dx)[None, :] + g[y1i][:, x1i] * dx[None, :]
    return top * (1 - dy)[:, None] + bot * dy[:, None]


def compactify_proposals(masks: np.ndarray, valid: np.ndarray,
                         out: int = 28, thresh: float = 0.5
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Full-res proposal masks -> the engine's compact form.

    masks (N, H, W), valid (N,) -> (boxes (N, 4) f32, crops (N, out, out)
    f32). Invalid slots get zero crops and degenerate boxes (the engine
    masks them out via prop_valid, but keep them inert anyway).
    """
    masks = np.asarray(masks)
    valid = np.asarray(valid).astype(bool)
    N = masks.shape[0]
    boxes = masks_to_boxes(masks, thresh=thresh)
    crops = np.zeros((N, out, out), np.float32)
    for i in range(N):
        if valid[i]:
            crops[i] = _bilinear_crop(masks[i], boxes[i], out)
        else:
            boxes[i] = (0.0, 0.0, 1.0, 1.0)
    return boxes, crops


def compact_stream(seq_frames: np.ndarray, prop_masks: np.ndarray,
                   prop_valid: np.ndarray, out: int = 28):
    """Per-frame compact item stream for InferenceEngine.run_stream_chunked.

    seq_frames (T, H, W, 3); prop_masks (T, N, H, W); prop_valid (T, N).
    Yields batch-1 items {"frame", "prop_boxes", "prop_masks28",
    "prop_valid"}.
    """
    T = seq_frames.shape[0]
    for t in range(T):
        boxes, crops = compactify_proposals(prop_masks[t], prop_valid[t],
                                            out=out)
        yield {"frame": seq_frames[t][None],
               "prop_boxes": boxes[None],
               "prop_masks28": crops[None],
               "prop_valid": np.asarray(prop_valid[t], bool)[None]}
