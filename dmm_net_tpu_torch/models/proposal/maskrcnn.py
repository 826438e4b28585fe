"""Mask pasting: box-local (28x28) proposal masks onto the image (or mask)
grid. The rest of the proposal detector is not ported yet."""

from __future__ import annotations

from typing import Tuple

import torch


def _paste_interp(coord: torch.Tensor, m: int) -> torch.Tensor:
    """Per-output-pixel bilinear weights into an m-bin source axis.

    coord (..., P) continuous source coordinates -> (..., P, m); all-zero
    rows for pixels outside (-0.5, m - 0.5). Coordinates in the half-pixel
    border clamp to the edge bin with full weight."""
    inside = (coord > -0.5) & (coord < m - 0.5)
    c0 = torch.floor(coord).clamp(0, m - 1)
    d = (coord - c0).clamp(0.0, 1.0)
    c0i = c0.long()
    c1i = (c0i + 1).clamp(0, m - 1)
    bins = torch.arange(m, device=coord.device)
    R = ((1.0 - d)[..., None] * (c0i[..., None] == bins).float()
         + d[..., None] * (c1i[..., None] == bins).float())
    return R * inside[..., None].float()


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                image_size: Tuple[int, int], threshold: float = 0.5,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Paste (..., D, mh, mw) box masks into (..., D, H, W) binary masks.

    boxes (..., D, 4) as (x1, y1, x2, y2) in output-grid coordinates; valid
    (..., D). Separable bilinear inverse mapping, out = R_v @ m @ R_u^T,
    with pixel i sampled at its center i + 0.5; thresholded at
    ``threshold`` and written as ``dtype``."""
    H, W = image_size
    mh, mw = masks.shape[-2:]
    dev = masks.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    boxes = boxes.float()
    x1, y1 = boxes[..., 0:1], boxes[..., 1:2]
    bw = (boxes[..., 2:3] - x1).clamp_min(1e-3)
    bh = (boxes[..., 3:4] - y1).clamp_min(1e-3)
    u = (xs + 0.5 - x1) / bw * mw - 0.5                       # (..., D, W)
    v = (ys + 0.5 - y1) / bh * mh - 0.5                       # (..., D, H)
    Rv = _paste_interp(v, mh)                                 # (..., D, H, mh)
    Ru = _paste_interp(u, mw)                                 # (..., D, W, mw)
    out = Rv @ masks.float() @ Ru.transpose(-1, -2)           # (..., D, H, W)
    out = torch.where(valid.bool()[..., None, None], out, torch.zeros_like(out))
    return (out > threshold).to(dtype)
