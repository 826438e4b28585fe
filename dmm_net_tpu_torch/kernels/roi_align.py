"""ROI-Align as a CUDA kernel (B4): one pyramid level, or the FPN's four
levels with each box on its own level, in one launch.

Replaces the TPU kernel ``roi_align_pallas`` in
dmm_net_tpu/kernels/roi_align.py and, for the detector, the reference's
``_multilevel_roi_align`` (dmm_net_tpu/models/proposal/maskrcnn.py), which
aligns every box on all four levels and keeps one. The CUDA source is
``csrc/roi_align.cu``; its header says how the work is split and what
bounds it on the card (bytes: the pyramid read once plus the output, ~15 us
per detector image at 3.35 TB/s).

``multilevel_roi_align`` computes each box's level on the device with the
same torch expression as its plain version (``fpn_levels``), so the
kernel and the plain version always pick the same level, and nothing is
read back to the host. ``roi_align`` is the same kernel with one level.
Both count one ``roi_align`` launch per call that has boxes. Each launches
the kernel for CUDA tensors (or raises) and runs its plain version for CPU
tensors. Channel first: feats (C, H, W), boxes (K, 4) -> (K, C, oh, ow),
the layout the detector's heads consume.

B4' is ``multilevel_roi_align``'s gradient with respect to the four levels
(the detector's training needs it for both heads): ``_MultilevelRoiAlign``,
a ``torch.autograd.Function`` whose forward is B4 and whose backward is
autograd through ``multilevel_roi_align_plain``, as the JAX detector's
``roi_align_mxu`` is differentiated by XLA (no backward kernel there
either). The boxes get no gradient: the detector stops gradients at its
proposals.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from dmm_net_tpu_torch.kernels import _build
from dmm_net_tpu_torch.ops.roi_pool import roi_align_mxu

# csrc/roi_align.cu limits: oh and ow up to 16 (one output per thread of a
# 256-thread block, each rounded up to a power of two), sampling ratio up
# to 4, four levels
_MAX_OUT = 16
_MAX_SAMPLING = 4
_MAX_LEVELS = 4


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fpn_levels(boxes: torch.Tensor) -> torch.Tensor:
    """FPN level of each box, floor(4 + log2(sqrt(area) / 224 + 1e-9))
    clipped to [2, 5], returned as 0..3 (p2..p5), int64, on the boxes'
    device."""
    areas = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])).clamp_min(1e-6)
    lvl = torch.floor(4.0 + torch.log2(torch.sqrt(areas) / 224.0 + 1e-9))
    return lvl.clamp(2, 5).long() - 2


def multilevel_roi_align_plain(levels: Sequence[torch.Tensor], boxes: torch.Tensor,
                               out_size: Tuple[int, int],
                               sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version: ``roi_align_mxu`` on every level (p2..p5, stride
    2**(i + 2)), then each box's own level."""
    stacked = torch.stack([
        roi_align_mxu(f, boxes, out_size, sampling_ratio, 1.0 / 2 ** (i + 2))
        for i, f in enumerate(levels)])                  # (L, K, C, oh, ow)
    return stacked[fpn_levels(boxes), torch.arange(boxes.shape[0], device=boxes.device)]


def _check(feats: Sequence[torch.Tensor], boxes: torch.Tensor) -> None:
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be (K, 4), got {tuple(boxes.shape)}")
    for f in feats:
        if f.dim() != 3:
            raise ValueError(f"feats must be (C, H, W), got {tuple(f.shape)}")
        if f.device != boxes.device:
            raise ValueError(f"boxes are on {boxes.device}, feats on {f.device}")
        if f.shape[0] != feats[0].shape[0]:
            raise ValueError("every level needs the same channel count, got "
                             f"{[tuple(t.shape) for t in feats]}")


def _launch(feats: Sequence[torch.Tensor], scales: Sequence[float],
            boxes: torch.Tensor, level: Optional[torch.Tensor],
            oh: int, ow: int, s: int) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors, validated here."""
    dev = boxes.device
    if dev.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {dev}")
    for name, t in [("boxes", boxes)] + [(f"feats[{i}]", f) for i, f in enumerate(feats)]:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32, got {t.dtype}"
                             f" (contiguous={t.is_contiguous()})")
    if s < 1 or oh < 1 or ow < 1:
        raise ValueError(f"roi_align: out_size {(oh, ow)}, sampling_ratio {s} "
                         "must be positive")
    if (s > _MAX_SAMPLING or max(oh, ow) > _MAX_OUT
            or _pow2(oh) * _pow2(ow) > 256):
        raise ValueError(f"roi_align: out_size {(oh, ow)} with sampling_ratio {s}"
                         f" exceeds the kernel's limits (sampling ratio <= "
                         f"{_MAX_SAMPLING}, oh and ow <= {_MAX_OUT})")
    C = feats[0].shape[0]
    K = boxes.shape[0]
    out = torch.empty((K, C, oh, ow), dtype=torch.float32, device=dev)
    if K == 0:
        return out
    n = len(feats)
    ptrs = [f.data_ptr() for f in feats] + [None] * (_MAX_LEVELS - n)
    Hs = [f.shape[1] for f in feats] + [1] * (_MAX_LEVELS - n)
    Ws = [f.shape[2] for f in feats] + [1] * (_MAX_LEVELS - n)
    scs = [float(x) for x in scales] + [0.0] * (_MAX_LEVELS - n)
    lib = _build.library("roi_align")
    with torch.cuda.device(dev):
        err = lib.dmm_roi_align(*ptrs, *Hs, *Ws, *scs, n, boxes.data_ptr(),
                                None if level is None else level.data_ptr(),
                                out.data_ptr(), K, C, oh, ow, int(s),
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "roi_align")
    _build.count("roi_align")
    return out


class _MultilevelRoiAlign(torch.autograd.Function):
    """B4 with B4' as its backward. Forward: the CUDA kernel (the plain
    version for CPU tensors); it saves the four levels and the boxes.
    Backward: ``multilevel_roi_align_plain`` recomputed on detached levels
    under ``enable_grad`` and differentiated by ``torch.autograd.grad``; on
    CUDA each backward counts one call in ``_build.backward_calls()`` (it
    launches no kernel of its own). The plain version aligns every box on
    all four levels and keeps one, so the recompute does about 4x the work
    of the box's own level; a CUDA backward that adds each output cell's
    gradient into its taps on that level alone is later work."""

    @staticmethod
    def forward(ctx, boxes, out_size, sampling_ratio, *levels):
        ctx.save_for_backward(boxes, *levels)
        ctx.opts = (out_size, sampling_ratio)
        if boxes.device.type == "cpu":
            return multilevel_roi_align_plain(levels, boxes, out_size,
                                              sampling_ratio)
        lvl = fpn_levels(boxes).to(torch.int32)
        return _launch(levels, [1.0 / 2 ** (i + 2) for i in range(_MAX_LEVELS)],
                       boxes, lvl, out_size[0], out_size[1], sampling_ratio)

    @staticmethod
    def backward(ctx, g_out):
        boxes, *levels = ctx.saved_tensors
        with torch.enable_grad():
            xs = [f.detach().requires_grad_(True) for f in levels]
            out = multilevel_roi_align_plain(xs, boxes, *ctx.opts)
            grads = torch.autograd.grad(out, xs, g_out)
        if g_out.device.type == "cuda":
            _build.count_backward("roi_align")
        return (None, None, None, *grads)


def multilevel_roi_align(levels: Sequence[torch.Tensor], boxes: torch.Tensor,
                         out_size: Tuple[int, int],
                         sampling_ratio: int = 2) -> torch.Tensor:
    """levels: the FPN maps p2..p5, each (C, H_l, W_l) float32 at stride
    2**(l + 2); boxes (K, 4) (x1, y1, x2, y2) in image coordinates ->
    (K, C, oh, ow), each box aligned on its level (``fpn_levels``).
    Differentiable with respect to the levels (B4'), not the boxes."""
    levels = list(levels)
    if len(levels) != _MAX_LEVELS:
        raise ValueError(f"multilevel_roi_align: needs the 4 maps p2..p5, "
                         f"got {len(levels)}")
    _check(levels, boxes)
    if boxes.requires_grad:
        raise ValueError("multilevel_roi_align: boxes must not require a "
                         "gradient (the detector stops it at the proposals)")
    oh, ow = int(out_size[0]), int(out_size[1])
    return _MultilevelRoiAlign.apply(boxes, (oh, ow), int(sampling_ratio),
                                     *levels)


def roi_align(feats: torch.Tensor, boxes: torch.Tensor,
              out_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 2,
              spatial_scale: float = 1.0) -> torch.Tensor:
    """One level: feats (C, H, W) float32, boxes (K, 4) float32 (x1, y1, x2,
    y2) in input coordinates -> (K, C, oh, ow) float32."""
    _check([feats], boxes)
    oh, ow = int(out_size[0]), int(out_size[1])
    if feats.device.type == "cpu":
        return roi_align_mxu(feats, boxes, (oh, ow), sampling_ratio, spatial_scale)
    return _launch([feats], [spatial_scale], boxes, None, oh, ow, int(sampling_ratio))
