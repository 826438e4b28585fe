"""ROI-Align on one pyramid level as a CUDA kernel (B4).

Replaces the TPU kernel ``roi_align_pallas`` in
dmm_net_tpu/kernels/roi_align.py. The CUDA source is ``csrc/roi_align.cu``;
its header says how the work is split and what bounds it on the card
(bytes: ~33 MB at the detector's p2 level with K=128 and a 14x14 output,
~10 us at 3.35 TB/s).

``roi_align`` launches the kernel for CUDA tensors (or raises) and runs the
plain version, ``ops.roi_pool.roi_align_mxu``, for CPU tensors. Channel
first: feats (C, H, W), boxes (K, 4) -> (K, C, oh, ow), the layout the
detector's heads consume.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dmm_net_tpu_torch.kernels import _build
from dmm_net_tpu_torch.ops.roi_pool import roi_align_mxu


def roi_align(feats: torch.Tensor, boxes: torch.Tensor,
              out_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 2,
              spatial_scale: float = 1.0) -> torch.Tensor:
    """feats (C, H, W) float32, boxes (K, 4) float32 (x1, y1, x2, y2) in
    input coordinates -> (K, C, oh, ow) float32."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be (C, H, W), got {tuple(feats.shape)}")
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be (K, 4), got {tuple(boxes.shape)}")
    if boxes.device != feats.device:
        raise ValueError(f"boxes are on {boxes.device}, feats on {feats.device}")
    oh, ow = int(out_size[0]), int(out_size[1])
    if feats.device.type == "cpu":
        return roi_align_mxu(feats, boxes, (oh, ow), sampling_ratio, spatial_scale)
    if feats.device.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {feats.device}")
    for name, t in (("feats", feats), ("boxes", boxes)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32, got {t.dtype}"
                             f" (contiguous={t.is_contiguous()})")
    if sampling_ratio < 1 or oh < 1 or ow < 1:
        raise ValueError(f"roi_align: out_size {out_size}, sampling_ratio "
                         f"{sampling_ratio} must be positive")
    C, H, W = feats.shape
    K = boxes.shape[0]
    out = torch.empty((K, C, oh, ow), dtype=torch.float32, device=feats.device)
    if K == 0:
        return out
    lib = _build.library("roi_align")
    with torch.cuda.device(feats.device):
        err = lib.dmm_roi_align(feats.data_ptr(), boxes.data_ptr(),
                                out.data_ptr(), K, C, H, W, oh, ow,
                                int(sampling_ratio), float(spatial_scale),
                                torch.cuda.current_stream(feats.device).cuda_stream)
    _build.check(err, "roi_align")
    _build.count("roi_align")
    return out
