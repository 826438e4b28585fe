"""Mask R-CNN (R-50-FPN) proposal detector: inference, the training forward,
and mask pasting.

Counterpart of the JAX package's models/proposal/maskrcnn.py, NCHW, float32:

    backbone (c2..c5) -> FPN (p2..p6) -> RPN head per level
      -> per-level top-k -> joint NMS -> post_nms_top_n proposals
      -> ROI-Align (kernel B4), each box on its FPN level
      -> box head -> best class, class boxes -> class-aware NMS
      -> ROI-Align -> mask head -> 28x28 mask of the chosen class

Every stage keeps a fixed count with a validity mask, as the reference does,
so nothing is read back to the host inside ``forward``. Each stage runs in a
``torch.profiler.record_function`` range named ``detector/<stage>``, so a
profile splits the device time by stage. ROI-Align aligns each box on its
assigned level only, all levels in one launch (2 launches per image, one
for each head); the reference aligns every box on all four levels and
keeps one, and the output is the same.

``train_forward`` is the JAX package's training forward: the raw RPN
outputs over all anchors and both heads on the proposals, which are chosen
from detached RPN outputs (two-stage training does not backpropagate
through proposal coordinates). ROI-Align's gradient reaches p2..p5 through
B4' (kernels/roi_align.py). The detector trains with frozen BatchNorm (the
reference's FrozenBatchNorm2d): ``trainable_()`` gives every parameter a
gradient, BN scales and biases included (they are flax ``params``), while
the running statistics stay fixed and ``forward`` stays ``no_grad``.

Module names are the flax names (``backbone``, ``fpn``, ``rpn``,
``box_head``, ``mask_head``, ``fc6``, ``conv5_mask``, ...), so the weight
bridge (weights.py) is a rename.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from dmm_net_tpu_torch import resolve_device
from dmm_net_tpu_torch.kernels.roi_align import multilevel_roi_align
from dmm_net_tpu_torch.models.layers import Conv, ConvTranspose, init_random
from dmm_net_tpu_torch.models.proposal.anchors import (clip_to_image,
                                                       decode_boxes,
                                                       generate_anchors,
                                                       level_slices)
from dmm_net_tpu_torch.models.proposal.fpn import FPN
from dmm_net_tpu_torch.models.resnet import backbone_by_name, feature_dims
from dmm_net_tpu_torch.ops.nms import nms_boxes

_ROI_LEVELS = ("p2", "p3", "p4", "p5")


class RPNHead(nn.Module):
    """Shared 3x3 conv + objectness / box-delta 1x1 heads, per level."""

    def __init__(self, num_anchors: int = 3, channels: int = 256):
        super().__init__()
        self.conv = Conv(channels, channels, 3)
        self.cls_logits = Conv(channels, num_anchors, 1)
        self.bbox_pred = Conv(channels, num_anchors * 4, 1)

    def forward(self, x):
        t = F.relu(self.conv(x))
        return self.cls_logits(t), self.bbox_pred(t)


class BoxHead(nn.Module):
    """Two FC layers (1024) then class scores and class box deltas. Takes
    (K, C, 7, 7) and flattens it in (7, 7, C) order, as the flax head does."""

    def __init__(self, num_classes: int = 81, channels: int = 256):
        super().__init__()
        self.fc6 = nn.Linear(channels * 7 * 7, 1024)
        self.fc7 = nn.Linear(1024, 1024)
        self.cls_score = nn.Linear(1024, num_classes)
        self.bbox_pred = nn.Linear(1024, num_classes * 4)

    def forward(self, x):
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    """Four 3x3 convs, a 2x2/s2 transposed conv, and per-class 1x1 logits:
    (K, C, 14, 14) -> (K, classes, 28, 28)."""

    def __init__(self, num_classes: int = 81, channels: int = 256):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"mask_fcn{i}", Conv(channels, 256, 3))
            channels = 256
        self.conv5_mask = ConvTranspose(256, 256, 2)
        self.mask_fcn_logits = Conv(256, num_classes, 1)

    def forward(self, x):
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


def _multilevel_roi_align(pyramid: Dict[str, torch.Tensor], boxes: torch.Tensor,
                          out_size: Tuple[int, int]) -> torch.Tensor:
    """ROI-Align of each box on its own level of p2..p5, level
    floor(4 + log2(sqrt(area) / 224 + 1e-9)) clipped to [2, 5]: one kernel
    launch. boxes (K, 4) in image coordinates -> (K, C, oh, ow)."""
    return multilevel_roi_align([pyramid[name][0] for name in _ROI_LEVELS], boxes,
                                out_size, sampling_ratio=2)


class MaskRCNN(nn.Module):
    """Single-image Mask R-CNN with static output sizes: ``pre_nms_top_n``
    candidates per level, ``post_nms_top_n`` proposals, ``max_detections``
    detections. Float32 throughout. ``deform_stages`` (e.g. ("c3", "c4",
    "c5")) gives the backbone DCNv2 in those stages.

    Weights are random from ``seed`` until the caller loads a checkpoint
    (weights.load_flax_variables); they take no gradient until
    ``trainable_()``. Runs on CUDA unless ``device`` says otherwise."""

    def __init__(self, image_size: Tuple[int, int] = (256, 448),
                 backbone_name: str = "resnet50", num_classes: int = 81,
                 pre_nms_top_n: int = 256, post_nms_top_n: int = 128,
                 max_detections: int = 64, rpn_nms_thresh: float = 0.7,
                 box_nms_thresh: float = 0.5, score_thresh: float = 0.05,
                 deform_stages: Sequence[str] = (), device=None, seed: int = 0):
        super().__init__()
        self.image_size = tuple(image_size)
        self.num_classes = num_classes
        self.pre_nms_top_n = pre_nms_top_n
        self.post_nms_top_n = post_nms_top_n
        self.max_detections = max_detections
        self.rpn_nms_thresh = rpn_nms_thresh
        self.box_nms_thresh = box_nms_thresh
        self.score_thresh = score_thresh
        self.backbone = backbone_by_name(backbone_name, dtype=torch.float32,
                                         deform_stages=tuple(deform_stages))
        self.fpn = FPN(feature_dims(backbone_name))
        self.rpn = RPNHead()
        self.box_head = BoxHead(num_classes)
        self.mask_head = MaskHead(num_classes)
        self._slices = level_slices(self.image_size)
        self.register_buffer("anchors", torch.from_numpy(
            generate_anchors(self.image_size)), persistent=False)
        init_random(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))
        self.eval()
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.anchors.device

    def trainable_(self, on: bool = True) -> "MaskRCNN":
        """Give every parameter a gradient (or take it away). BatchNorm
        stays frozen on its running statistics either way."""
        self.requires_grad_(on)
        return self

    def _check_images(self, images: torch.Tensor, batch=None) -> None:
        H, W = self.image_size
        if images.dim() != 4 or tuple(images.shape[1:]) != (3, H, W) or (
                batch is not None and images.shape[0] != batch):
            raise ValueError(f"image {tuple(images.shape)}, expected "
                             f"({batch or 'B'}, 3, {H}, {W})")

    def _pyramid(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """p2..p6 of (B, 3, H, W) images. The input is made contiguous
        first: a channels-last view (an NHWC frame permuted) would make the
        convolutions' outputs channels-last, and B4 takes contiguous maps."""
        return self.fpn(self.backbone(images.float().contiguous()))

    def _rpn(self, pyramid: Dict[str, torch.Tensor]):
        """RPN over p2..p6, flattened per image in (level, h, w, anchor)
        order: objectness (B, A), deltas (B, A, 4)."""
        obj, deltas = [], []
        for name in ("p2", "p3", "p4", "p5", "p6"):
            logits, d = self.rpn(pyramid[name])
            B = logits.shape[0]
            obj.append(logits.permute(0, 2, 3, 1).reshape(B, -1))
            deltas.append(d.permute(0, 2, 3, 1).reshape(B, -1, 4))
        return torch.cat(obj, 1), torch.cat(deltas, 1)

    def _proposals(self, obj: torch.Tensor, deltas: torch.Tensor):
        """One image's objectness (A,) and deltas (A, 4) (detached by the
        caller in training) -> per-level top-k, joint NMS: proposals
        (post_nms_top_n, 4) and their validity."""
        with record_function("detector/rpn"):
            cand = torch.cat([
                torch.topk(obj[a:b], min(self.pre_nms_top_n, b - a)).indices + a
                for a, b in self._slices])
            cand_boxes = clip_to_image(
                decode_boxes(deltas[cand], self.anchors[cand]), self.image_size)
            wh_ok = ((cand_boxes[:, 2] - cand_boxes[:, 0] > 1e-3)
                     & (cand_boxes[:, 3] - cand_boxes[:, 1] > 1e-3))
        with record_function("detector/rpn_nms"):
            keep_idx, prop_valid = nms_boxes(cand_boxes, obj[cand], wh_ok,
                                             iou_threshold=self.rpn_nms_thresh,
                                             max_out=self.post_nms_top_n)
            return cand_boxes[keep_idx.clamp_min(0)], prop_valid

    @torch.no_grad()
    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image (1, 3, H, W) float in [0, 1] (or whatever distribution the
        weights were trained on). Returns boxes (D, 4), scores (D,),
        classes (D,) int64, masks (D, 28, 28) sigmoid, valid (D,) bool, with
        D = max_detections."""
        H, W = self.image_size
        self._check_images(image, 1)
        with record_function("detector/backbone_fpn"):
            pyramid = self._pyramid(image)

        with record_function("detector/rpn"):
            obj, deltas = self._rpn(pyramid)
        proposals, prop_valid = self._proposals(obj[0], deltas[0])

        with record_function("detector/box_head"):
            # best foreground class per proposal, and its box
            cls_scores, box_deltas = self.box_head(
                _multilevel_roi_align(pyramid, proposals, (7, 7)))
            fg_score, best_cls = torch.softmax(cls_scores, -1)[:, 1:].max(-1)
            best_score = fg_score * prop_valid
            sel = box_deltas.reshape(-1, self.num_classes, 4).gather(
                1, (best_cls + 1)[:, None, None].expand(-1, 1, 4))[:, 0]
            det_boxes = clip_to_image(
                decode_boxes(sel, proposals, weights=(10., 10., 5., 5.)),
                self.image_size)

        with record_function("detector/box_nms"):
            # class-aware NMS: offset each class by the image's H + W so boxes
            # of different classes never overlap, then one plain NMS
            offset = (best_cls + 1).float()[:, None] * float(H + W)
            d_idx, d_mask = nms_boxes(det_boxes + offset, best_score,
                                      best_score > self.score_thresh,
                                      iou_threshold=self.box_nms_thresh,
                                      max_out=self.max_detections)
            dsafe = d_idx.clamp_min(0)
            final_boxes = det_boxes[dsafe]
            final_classes = (best_cls[dsafe] + 1) * d_mask

        with record_function("detector/mask_head"):
            # the chosen class's mask logits (class 0 for an invalid slot)
            mask_logits = self.mask_head(
                _multilevel_roi_align(pyramid, final_boxes, (14, 14)))
            mh, mw = mask_logits.shape[-2:]
            masks = mask_logits.gather(
                1, final_classes[:, None, None, None].expand(-1, 1, mh, mw))[:, 0]
        return {"boxes": final_boxes, "scores": best_score[dsafe] * d_mask,
                "classes": final_classes, "masks": torch.sigmoid(masks),
                "valid": d_mask}

    def train_forward_batch(self, images: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """``train_forward`` for each image of a batch (B, 3, H, W), with
        the backbone, the FPN and the RPN convolutions run once on the
        whole batch (BatchNorm is frozen, so each image's result is its
        own); the proposal selection, ROI-Align (B4, one launch per head)
        and the heads run per image."""
        self._check_images(images)
        with record_function("detector/backbone_fpn"):
            pyramid = self._pyramid(images)
        with record_function("detector/rpn"):
            obj, deltas = self._rpn(pyramid)
        outs = []
        for b in range(images.shape[0]):
            proposals, prop_valid = self._proposals(obj[b].detach(),
                                                    deltas[b].detach())
            levels = {name: pyramid[name][b:b + 1] for name in _ROI_LEVELS}
            with record_function("detector/box_head"):
                cls_scores, box_deltas = self.box_head(
                    _multilevel_roi_align(levels, proposals, (7, 7)))
            with record_function("detector/mask_head"):
                mask_logits = self.mask_head(
                    _multilevel_roi_align(levels, proposals, (14, 14)))
            outs.append({"rpn_objectness": obj[b], "rpn_deltas": deltas[b],
                         "anchors": self.anchors, "proposals": proposals,
                         "prop_valid": prop_valid, "cls_scores": cls_scores,
                         "box_deltas": box_deltas, "mask_logits": mask_logits})
        return outs

    def train_forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Training forward of one image (1, 3, H, W): rpn_objectness (A,)
        and rpn_deltas (A, 4) over all anchors, anchors (A, 4), proposals
        (P, 4) and prop_valid (P,) from the detached RPN outputs, and on
        those proposals cls_scores (P, C), box_deltas (P, C * 4) and
        mask_logits (P, C, 28, 28), with P = post_nms_top_n: everything
        models/proposal/losses.py takes."""
        self._check_images(image, 1)
        return self.train_forward_batch(image)[0]


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
