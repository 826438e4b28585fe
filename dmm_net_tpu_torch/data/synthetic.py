"""Synthetic moving-shape videos with exact ground truth (numpy only).

A copy of the JAX package's data/synthetic.py: the same seed gives
bit-equal arrays in both packages. Each video holds moving rectangles and
circles over a textured background; proposals are jittered ground-truth
masks plus decoys, so the matcher has a planted optimal assignment and a
trained model scores J&F near 1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _render_objects(centers, sizes, shapes, H, W):
    """centers (M, 2) float, sizes (M,) float, shapes (M,) in {0:rect, 1:circle}
    -> masks (M, H, W) uint8."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    masks = []
    for (cy, cx), s, sh in zip(centers, sizes, shapes):
        if sh == 0:
            m = (np.abs(yy - cy) < s) & (np.abs(xx - cx) < s * 0.7)
        else:
            m = ((yy - cy) ** 2 + (xx - cx) ** 2) < s ** 2
        masks.append(m.astype(np.float32))
    return np.stack(masks) if masks else np.zeros((0, H, W), np.float32)


def synthetic_sequence(seed: int = 0, T: int = 8, H: int = 128, W: int = 128,
                       num_objects: int = 2, num_proposals: int = 16,
                       ) -> Dict[str, np.ndarray]:
    """One video sequence.

    Returns dict:
      frames      (T, H, W, 3) float32 in [0, 1]
      gt_masks    (T, M, H, W) float32 binary
      prop_masks  (T, N, H, W) float32, first M entries are jittered GT,
                  the rest decoys; shuffled per frame
      prop_valid  (T, N) bool
      tmpl_masks  (M, H, W) = gt_masks[0]
      tmpl_valid  (M,) bool
      gt_assignment (T, M) int — planted optimal proposal index per frame
      shapes      (M,) int — shape family per object ({0: rect, 1: circle};
                  maps onto synthetic_detection_frame classes 1=rect,
                  2=ellipse, so a detector fine-tuned on video frames keeps
                  consistent class semantics)
    """
    rng = np.random.RandomState(seed)
    M, N = num_objects, num_proposals
    centers0 = rng.rand(M, 2) * [H * 0.5, W * 0.5] + [H * 0.25, W * 0.25]
    vel = rng.randn(M, 2) * 2.0
    sizes = rng.rand(M) * (H * 0.08) + H * 0.1
    shapes = rng.randint(0, 2, size=M)
    colors = rng.rand(M, 3) * 0.7 + 0.3

    bg = rng.rand(H, W, 3).astype(np.float32) * 0.15 + 0.1

    frames = np.zeros((T, H, W, 3), np.float32)
    gt = np.zeros((T, M, H, W), np.float32)
    props = np.zeros((T, N, H, W), np.float32)
    pvalid = np.zeros((T, N), bool)
    assign = np.zeros((T, M), np.int64)

    for t in range(T):
        centers = centers0 + vel * t
        centers[:, 0] = np.clip(centers[:, 0], sizes, H - sizes)
        centers[:, 1] = np.clip(centers[:, 1], sizes, W - sizes)
        masks = _render_objects(centers, sizes, shapes, H, W)
        gt[t] = masks
        frame = bg.copy()
        for i in range(M):
            frame = frame * (1 - masks[i][..., None]) + \
                masks[i][..., None] * colors[i]
        frames[t] = frame + rng.randn(H, W, 3).astype(np.float32) * 0.02

        # proposals: jittered GT + decoys, then shuffle
        plist = []
        for i in range(M):
            jit = _render_objects(centers[i:i + 1] + rng.randn(1, 2) * 1.0,
                                  sizes[i:i + 1] * (1 + rng.randn() * 0.05),
                                  shapes[i:i + 1], H, W)[0]
            plist.append(jit)
        n_decoy = min(N - M, max(0, N - M))
        for _ in range(n_decoy):
            c = rng.rand(1, 2) * [H * 0.8, W * 0.8] + [H * 0.1, W * 0.1]
            s = np.asarray([rng.rand() * H * 0.12 + H * 0.05])
            plist.append(_render_objects(c, s, rng.randint(0, 2, 1), H, W)[0])
        perm = rng.permutation(len(plist))
        inv = np.argsort(perm)
        props[t, :len(plist)] = np.stack(plist)[perm]
        pvalid[t, :len(plist)] = True
        assign[t] = inv[:M]

    return {
        "frames": frames,
        "gt_masks": gt,
        "prop_masks": props,
        "prop_valid": pvalid,
        "tmpl_masks": gt[0].copy(),
        "tmpl_valid": np.ones((M,), bool),
        "gt_assignment": assign,
        "shapes": shapes.astype(np.int32),
    }


def _render_shape(cy, cx, sy, sx, shape, angle, yy, xx):
    """One soft shape mask. shape: 0 rect, 1 circle/ellipse, 2 triangle."""
    ry = (yy - cy) * np.cos(angle) - (xx - cx) * np.sin(angle)
    rx = (yy - cy) * np.sin(angle) + (xx - cx) * np.cos(angle)
    if shape == 0:
        m = (np.abs(ry) < sy) & (np.abs(rx) < sx)
    elif shape == 1:
        m = (ry / sy) ** 2 + (rx / sx) ** 2 < 1.0
    else:  # triangle: half-plane intersection
        m = (ry > -sy) & (ry + 2 * sy * np.abs(rx) / max(sx, 1e-6) < sy)
    return m.astype(np.float32)


def synthetic_detection_frame(seed: int = 0, H: int = 128, W: int = 128,
                              max_objects: int = 8,
                              num_classes: int = 4) -> Dict[str, np.ndarray]:
    """One detection-training frame with COCO-like statistics.

    Properties the simple video generator lacks, on purpose:
      * variable object count (1..max_objects) with occlusion — later
        objects are drawn on top, and GT masks are the VISIBLE (modal)
        regions, so heavy overlap produces partial masks like real data;
      * log-uniform scale spread (~H/20 .. H/3): small-object regime
        included, exercising the P2..P6 FPN level assignment;
      * class = shape family (1 rect, 2 ellipse, 3 triangle, ...), with
        rotation, aspect ratio, and color jitter inside each class;
      * objects fully gone behind others get valid=False (crowd-style
        filtering), boxes are tight on the visible mask.

    Returns: image (H, W, 3) f32, boxes (G, 4) xyxy, labels (G,) int32
    in [1, num_classes-1], valid (G,) bool, masks (G, H, W) f32.
    """
    rng = np.random.RandomState(seed)
    G = max_objects
    n = rng.randint(1, G + 1)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    # textured background: low-freq gradient + noise
    gy, gx = rng.randn(2) * 0.2
    bg = (0.15 + 0.1 * (gy * yy / H + gx * xx / W)[..., None]
          + rng.randn(H, W, 1).astype(np.float32) * 0.03)
    image = np.clip(np.repeat(bg, 3, axis=-1)
                    + rng.rand(1, 1, 3).astype(np.float32) * 0.1, 0, 1)

    full = np.zeros((n, H, W), np.float32)
    labels_n = np.zeros((n,), np.int32)
    for i in range(n):
        cls = rng.randint(1, num_classes)           # 1..C-1 (0 = bg)
        scale = np.exp(rng.uniform(np.log(H / 20.0), np.log(H / 3.0)))
        aspect = np.exp(rng.randn() * 0.35)
        cy = rng.uniform(scale * 0.3, H - scale * 0.3)
        cx = rng.uniform(scale * 0.3, W - scale * 0.3)
        full[i] = _render_shape(cy, cx, scale, scale * aspect,
                                (cls - 1) % 3, rng.uniform(0, np.pi), yy, xx)
        labels_n[i] = cls
        color = rng.rand(3) * 0.75 + 0.25
        shade = 1.0 - 0.25 * ((yy - cy) / max(scale, 1e-6))
        paint = np.clip(color[None, None] * shade[..., None], 0, 1)
        image = image * (1 - full[i][..., None]) + paint * full[i][..., None]
    image = np.clip(image + rng.randn(H, W, 3).astype(np.float32) * 0.02,
                    0, 1)

    # visibility: later objects occlude earlier ones
    boxes = np.zeros((G, 4), np.float32)
    labels = np.zeros((G,), np.int32)
    valid = np.zeros((G,), bool)
    masks = np.zeros((G, H, W), np.float32)
    for i in range(n):
        vis = full[i].copy()
        for j in range(i + 1, n):
            vis *= (1 - full[j])
        ys, xs = np.nonzero(vis > 0.5)
        if ys.size < 12:                            # fully occluded / sliver
            continue
        masks[i] = (vis > 0.5).astype(np.float32)
        boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        labels[i] = labels_n[i]
        valid[i] = True

    return {"image": image.astype(np.float32), "boxes": boxes,
            "labels": labels, "valid": valid, "masks": masks}


def synthetic_clip_batch(seed: int = 0, batch: int = 2, T: int = 4,
                         H: int = 64, W: int = 64, num_objects: int = 2,
                         num_proposals: int = 8,
                         pad_objects: int | None = None,
                         ) -> Dict[str, np.ndarray]:
    """Batch of clips in the training-batch layout: (B, T, ...) stacks of
    synthetic_sequence outputs, object axes padded to ``pad_objects``."""
    seqs = [synthetic_sequence(seed + b, T=T, H=H, W=W,
                               num_objects=num_objects,
                               num_proposals=num_proposals)
            for b in range(batch)]
    M = pad_objects or num_objects

    def pad_m(x, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, M - num_objects)
        return np.pad(x, pad)

    out = {
        "frames": np.stack([s["frames"] for s in seqs]),
        "prop_masks": np.stack([s["prop_masks"] for s in seqs]),
        "prop_valid": np.stack([s["prop_valid"] for s in seqs]),
        "gt_masks": np.stack([pad_m(s["gt_masks"], 1) for s in seqs]),
        "tmpl_masks": np.stack([pad_m(s["tmpl_masks"], 0) for s in seqs]),
        "tmpl_valid": np.stack([pad_m(s["tmpl_valid"], 0) for s in seqs]),
    }
    return out
