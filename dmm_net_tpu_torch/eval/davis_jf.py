"""DAVIS J&F metrics (numpy only; no cv2 and no PIL).

A copy of the JAX package's eval/davis_jf.py, which re-implements the
davis2017-evaluation scorer:
  * J: per-frame region IoU |P∩G| / |P∪G|;
  * F: boundary F-measure: contour pixels of P and G matched within a
    tolerance by dilation with a disk of radius bound_th (0.008) x the image
    diagonal; F = 2PR / (P + R).
First and last frames of each sequence are excluded from the mean, as in
the official protocol. The dilation is the numpy shift-accumulate form
(the JAX package's cv2 path computes the same), and ``upsample_labels``
reproduces PIL's NEAREST resize with index maps.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def db_eval_iou(annotation: np.ndarray, segmentation: np.ndarray) -> float:
    """Region similarity J for one frame, one object (binary masks)."""
    annotation = annotation.astype(bool)
    segmentation = segmentation.astype(bool)
    union = (annotation | segmentation).sum()
    if union == 0:
        # both empty: defined as 1 by the official tool
        return 1.0
    return float((annotation & segmentation).sum() / union)


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Boundary map of a binary mask — pixels that differ from their
    east/south/south-east neighbor. Matches davis2017-evaluation's
    _seg2bmap for the equal-size (no rescale) case, including the special
    handling of the last row/column."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = seg[-1, -1]
    return b


def _disk(radius: int) -> np.ndarray:
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return ((yy ** 2 + xx ** 2) <= radius ** 2).astype(np.uint8)


def _binary_dilate_disk(m: np.ndarray, radius: int) -> np.ndarray:
    """Dilate a boolean map with a disk structuring element (skimage's
    disk, as davis2017-evaluation uses)."""
    if radius <= 0:
        return m
    H, W = m.shape
    out = np.zeros_like(m)
    for dy, dx in np.argwhere(_disk(radius)) - radius:
        ys = slice(max(0, dy), H + min(0, dy))
        yd = slice(max(0, -dy), H + min(0, -dy))
        xs = slice(max(0, dx), W + min(0, dx))
        xd = slice(max(0, -dx), W + min(0, -dx))
        out[yd, xd] |= m[ys, xs]
    return out


def db_eval_boundary(annotation: np.ndarray, segmentation: np.ndarray,
                     bound_th: float = 0.008) -> float:
    """Boundary F-measure for one frame, one object."""
    fg = segmentation.astype(bool)
    gt = annotation.astype(bool)
    bound_pix = (bound_th if bound_th >= 1 else
                 int(np.ceil(bound_th * np.linalg.norm(fg.shape))))
    fg_b = _seg2bmap(fg)
    gt_b = _seg2bmap(gt)
    fg_dil = _binary_dilate_disk(fg_b, int(bound_pix))
    gt_dil = _binary_dilate_disk(gt_b, int(bound_pix))
    # precision: predicted boundary pixels near a GT boundary
    n_fg = fg_b.sum()
    n_gt = gt_b.sum()
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0
    precision = (fg_b & gt_dil).sum() / n_fg
    recall = (gt_b & fg_dil).sum() / n_gt
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output pixel under PIL's NEAREST resize: the
    sample point starts at half a step and advances by in/out in double
    precision, truncated to an integer."""
    step = n_in / n_out
    pos = step * 0.5
    idx = np.empty(n_out, np.int64)
    for i in range(n_out):
        idx[i] = int(pos)
        pos += step
    return np.minimum(idx, n_in - 1)


def upsample_labels(labels: np.ndarray, hw) -> np.ndarray:
    """Nearest-upsample (T, h, w) integer label maps to native (H, W): DAVIS
    scores at the annotation's native resolution, so model-resolution
    predictions are upsampled, never the GT downsampled."""
    labels = np.asarray(labels)
    rows = _nearest_index(labels.shape[1], int(hw[0]))
    cols = _nearest_index(labels.shape[2], int(hw[1]))
    return labels.astype(np.uint8)[:, rows][:, :, cols].astype(labels.dtype)


def evaluate_sequence(gt_masks: np.ndarray, pred_masks: np.ndarray,
                      object_ids: List[int] | None = None,
                      exclude_first_last: bool = True) -> Dict[str, float]:
    """Score one sequence.

    gt_masks, pred_masks: (T, H, W) integer label maps (0 = background) or
    (T, M, H, W) binary per-object stacks.
    Returns {"J": mean J, "F": mean F, "J&F": (J+F)/2, per-object lists}.
    """
    if gt_masks.ndim == 3:
        if object_ids is None:
            object_ids = sorted(set(np.unique(gt_masks)) - {0})
        gt_stack = np.stack([(gt_masks == oid) for oid in object_ids], axis=1)
        pred_stack = np.stack([(pred_masks == oid) for oid in object_ids], axis=1)
    else:
        gt_stack, pred_stack = gt_masks.astype(bool), pred_masks.astype(bool)
        object_ids = list(range(gt_stack.shape[1]))

    T = gt_stack.shape[0]
    frames = range(1, T - 1) if (exclude_first_last and T > 2) else range(T)

    def _recall(xs, th=0.5):
        return float(np.mean([x > th for x in xs])) if xs else 1.0

    def _decay(xs, n_bins=4):
        """Official decay statistic: performance drop from the first to the
        last quarter of the sequence."""
        if len(xs) < n_bins:
            return 0.0
        ids = np.round(np.linspace(1, len(xs), n_bins + 1) + 1e-10) - 1
        # uint8 reproduces the official scorer's dtype quirk bit for bit,
        # but wraps past 255 frames (DAVIS has at most ~104): refuse longer
        # inputs instead of wrapping.
        if len(xs) > 255:
            raise ValueError(
                f"decay statistic is DAVIS-protocol-exact (uint8 bin "
                f"indices) and wraps beyond 255 frames; got {len(xs)}. "
                "Score long videos with another scorer.")
        ids = ids.astype(np.uint8)
        bins = [np.asarray(xs)[ids[i]:ids[i + 1] + 1] for i in range(n_bins)]
        means = [b.mean() if b.size else 0.0 for b in bins]
        return float(means[0] - means[3])

    J_per, F_per = [], []
    J_rec, J_dec, F_rec, F_dec = [], [], [], []
    for k in range(gt_stack.shape[1]):
        js = [db_eval_iou(gt_stack[t, k], pred_stack[t, k]) for t in frames]
        fs = [db_eval_boundary(gt_stack[t, k], pred_stack[t, k]) for t in frames]
        J_per.append(float(np.mean(js)) if js else 1.0)
        F_per.append(float(np.mean(fs)) if fs else 1.0)
        J_rec.append(_recall(js))
        F_rec.append(_recall(fs))
        J_dec.append(_decay(js))
        F_dec.append(_decay(fs))
    J = float(np.mean(J_per))
    F = float(np.mean(F_per))
    return {"J": J, "F": F, "J&F": (J + F) / 2,
            "J_recall": float(np.mean(J_rec)), "J_decay": float(np.mean(J_dec)),
            "F_recall": float(np.mean(F_rec)), "F_decay": float(np.mean(F_dec)),
            "J_per_object": J_per, "F_per_object": F_per,
            "object_ids": object_ids}
