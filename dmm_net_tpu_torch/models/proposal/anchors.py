"""Anchors over the FPN pyramid and the Faster R-CNN box coder.

Counterpart of the JAX package's models/proposal/anchors.py. The anchors of
a fixed image size are a constant, built once with numpy; the coder works
on tensors of any leading shape.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

STRIDES = (4, 8, 16, 32, 64)


def generate_anchors(image_size: Tuple[int, int],
                     strides: Sequence[int] = STRIDES,
                     sizes: Sequence[float] = (32, 64, 128, 256, 512),
                     ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """All anchors over the pyramid, (A_total, 4) xyxy float32, in
    (level, fh, fw, ratio) order. Level dims are ceil(d / stride): every
    level comes from stride-2 convolutions that round up."""
    H, W = image_size
    out = []
    for stride, size in zip(strides, sizes):
        fh, fw = -(-H // stride), -(-W // stride)
        cy = (np.arange(fh) + 0.5) * stride
        cx = (np.arange(fw) + 0.5) * stride
        cyx = np.stack(np.meshgrid(cy, cx, indexing="ij"), -1)     # (fh, fw, 2)
        shapes = np.asarray([(size * np.sqrt(r), size / np.sqrt(r))
                             for r in ratios])                     # (R, 2) h, w
        ctr = np.broadcast_to(cyx[:, :, None, :], (fh, fw, len(ratios), 2))
        hw = np.broadcast_to(shapes[None, None], (fh, fw, len(ratios), 2))
        boxes = np.concatenate([ctr[..., ::-1] - hw[..., ::-1] / 2,
                                ctr[..., ::-1] + hw[..., ::-1] / 2], axis=-1)
        out.append(boxes.reshape(-1, 4))
    return np.concatenate(out, 0).astype(np.float32)


def level_slices(image_size, strides=STRIDES, num_ratios=3):
    """(start, stop) of each pyramid level in the flat anchor list."""
    H, W = image_size
    sizes = [(-(-H // s)) * (-(-W // s)) * num_ratios for s in strides]
    stops = np.cumsum(sizes)
    starts = np.concatenate([[0], stops[:-1]])
    return list(zip(starts.tolist(), stops.tolist()))


def _centres(b: torch.Tensor):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return w, h, b[..., 0] + w / 2, b[..., 1] + h / 2


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Boxes -> (dx, dy, dw, dh) regression targets against anchors."""
    wx, wy, ww, wh = weights
    aw, ah, ax, ay = _centres(anchors)
    bw, bh, bx, by = _centres(boxes)
    aw_, ah_ = aw.clamp_min(1e-6), ah.clamp_min(1e-6)
    return torch.stack([wx * (bx - ax) / aw_, wy * (by - ay) / ah_,
                        ww * torch.log(bw.clamp_min(1e-6) / aw_),
                        wh * torch.log(bh.clamp_min(1e-6) / ah_)], -1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 clip: float = 4.135) -> torch.Tensor:
    """(dx, dy, dw, dh) -> xyxy boxes; dw, dh clipped at log(1000 / 16)."""
    wx, wy, ww, wh = weights
    aw, ah, ax, ay = _centres(anchors)
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(-clip, clip)
    dh = (deltas[..., 3] / wh).clamp(-clip, clip)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def clip_to_image(boxes: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
    H, W = image_size
    return torch.stack([boxes[..., 0].clamp(0, W), boxes[..., 1].clamp(0, H),
                        boxes[..., 2].clamp(0, W), boxes[..., 3].clamp(0, H)], -1)
