"""Reference of one offline request: a batch of sequences through the
frame step, frame by frame, as an offline evaluator runs it.

Works out again everything the program derives from the request's inputs:
the object bucket, the template features pooled from the first frame, the
initial state, the paste of the compact proposals, the labels, and the
assignments padded back to every template slot. Given the program's labels,
it counts as it goes the pixels that differ, over all pixels and over the
decisive ones: those whose reference margin (``resolve_labels``) exceeds
each of ``taus``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from benchmark.reference.model import FrameStep, bucket, paste, resolve_labels


@torch.no_grad()
def run_request(step: FrameStep, frames, boxes, masks28, prop_valid,
                tmpl_masks, tmpl_valid, got_labels: Optional[torch.Tensor] = None,
                taus: Sequence[float] = ()):
    """frames (T, B, H, W, 3) uint8; boxes (T, B, N, 4); masks28 (T, B, N,
    mh, mw); prop_valid (T, B, N); tmpl_masks (B, M, h, w) float; tmpl_valid
    (B, M) bool with each row's valid slots first; ``got_labels`` (T, B, H,
    W) the program's, on the same device. Returns labels (T, B, H, W) uint8,
    X (T, B, M, N) float32, and the counts {"pixels", "differ",
    "decisive": {tau: (pixels, differ)}} (zeros without ``got_labels``)."""
    M_full = tmpl_valid.shape[1]
    Mb = bucket(int(tmpl_valid.sum(1).max()), M_full)
    tm, tv = tmpl_masks[:, :Mb], tmpl_valid[:, :Mb].bool()
    tfeats = step.template_features(frames[0], tm)
    state = step.init_state(tm)
    labels, xs = [], []
    counts = {"pixels": 0, "differ": 0, "decisive": {t: [0, 0] for t in taus}}
    for t in range(frames.shape[0]):
        pm = paste(masks28[t], boxes[t], prop_valid[t], step.image_hw,
                   step.mask_hw, step.mask_dtype)
        logits, X, state = step(frames[t], pm, prop_valid[t], tfeats, tv, state)
        lab, margin = resolve_labels(logits, tv, step.image_hw, with_margin=True)
        labels.append(lab)
        xs.append(torch.nn.functional.pad(X, (0, 0, 0, M_full - Mb)))
        if got_labels is not None:
            diff = got_labels[t] != lab
            counts["pixels"] += diff.numel()
            counts["differ"] += int(diff.sum())
            for tau, c in counts["decisive"].items():
                sure = margin > tau
                c[0] += int(sure.sum())
                c[1] += int((diff & sure).sum())
    return torch.stack(labels), torch.stack(xs), counts
