"""Train step of the proposal detector: the counterpart of the JAX package's
train/proposal_loop.py.

The loss of a batch is the mean of the per-image detection losses (RPN,
box head, mask head); each part is the mean over the images too. The JAX
package runs a batch-1 ``train_forward`` per image under ``vmap``. With
frozen BatchNorm an image's result does not depend on the rest of its
batch, so here the backbone and the FPN run once on the whole batch, and
the proposal selection, ROI-Align (B4 forward, B4' backward) and the heads
run per image (``MaskRCNN.train_forward_batch``).

The optimizer is optax's ``adamw(lr, weight_decay=1e-5)``: torch's
``AdamW`` with the same betas, eps and decay over every parameter, BN
scales and biases included (they are flax ``params``).

A batch is the JAX package's dict, numpy or tensors: images (B, H, W, 3)
float in [0, 1], boxes (B, G, 4), labels (B, G), valid (B, G) bool and
masks (B, G, H, W).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from dmm_net_tpu_torch.infer.engine import _not_ported
from dmm_net_tpu_torch.models.proposal.losses import (assign_proposals,
                                                      box_head_loss,
                                                      mask_head_loss,
                                                      rpn_loss)
from dmm_net_tpu_torch.models.proposal.maskrcnn import MaskRCNN

_PARTS = ("rpn_cls", "rpn_reg", "box_cls", "box_reg", "mask")


def stack_detection_frames(frames: Sequence[dict]) -> Dict[str, np.ndarray]:
    """``synthetic_detection_frame`` dicts (image (H, W, 3), boxes (G, 4),
    labels (G,), valid (G,), masks (G, H, W)) -> one detection batch, numpy."""
    keys = {"images": "image", "boxes": "boxes", "labels": "labels",
            "valid": "valid", "masks": "masks"}
    return {k: np.stack([f[src] for f in frames]) for k, src in keys.items()}


def proposal_batch_to(batch, device) -> Dict[str, torch.Tensor]:
    """A detection batch dict (numpy or tensors) on ``device``, with the
    JAX package's dtypes: float32 images, boxes and masks, int64 labels,
    bool valid."""
    kinds = {"images": torch.float32, "boxes": torch.float32,
             "masks": torch.float32, "labels": torch.int64, "valid": torch.bool}
    return {k: torch.as_tensor(batch[k]).to(device=device, dtype=kinds[k])
            for k in kinds}


def _image_loss(out: Dict[str, torch.Tensor], gt_boxes, gt_labels, gt_valid,
                gt_masks) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One image's detection loss from its ``train_forward`` outputs."""
    l_rpn = rpn_loss(out["rpn_objectness"], out["rpn_deltas"], out["anchors"],
                     gt_boxes, gt_valid)
    l_box = box_head_loss(out["cls_scores"], out["box_deltas"],
                          out["proposals"], out["prop_valid"], gt_boxes,
                          gt_labels, gt_valid)
    cls_t, matched = assign_proposals(out["proposals"], out["prop_valid"],
                                      gt_boxes, gt_labels, gt_valid)
    l_mask = mask_head_loss(out["mask_logits"], out["proposals"], cls_t,
                            matched, gt_masks)
    parts = {**l_rpn, **l_box, "mask": l_mask}
    return sum(parts[k] for k in _PARTS), parts


def proposal_image_loss(model: MaskRCNN, image, gt_boxes, gt_labels,
                        gt_valid, gt_masks):
    """Detection loss of ONE image (image (H, W, 3); gt_* unbatched) ->
    (total, parts)."""
    out = model.train_forward(image.permute(2, 0, 1)[None])
    return _image_loss(out, gt_boxes, gt_labels, gt_valid, gt_masks)


def make_proposal_batch_loss(model: MaskRCNN):
    """batch (proposal_batch_to's dict) -> (mean loss, mean of each part)."""

    def batch_loss(batch):
        outs = model.train_forward_batch(batch["images"].permute(0, 3, 1, 2))
        totals, parts = [], {k: [] for k in _PARTS}
        for b, out in enumerate(outs):
            t, p = _image_loss(out, batch["boxes"][b], batch["labels"][b],
                               batch["valid"][b], batch["masks"][b])
            totals.append(t)
            for k in _PARTS:
                parts[k].append(p[k])
        return (torch.stack(totals).mean(),
                {k: torch.stack(v).mean() for k, v in parts.items()})

    return batch_loss


def make_proposal_optimizer(model: MaskRCNN, lr: float) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay=1e-5) over every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-5)


def make_proposal_train_step(model: MaskRCNN, optimizer: torch.optim.Optimizer,
                             mesh=None):
    """step(batch) -> {"loss", "grad_norm", *parts} as 0-d tensors (read
    nothing back to the host): one update of ``model`` in place.
    ``grad_norm`` is the global norm of the gradient before the update."""
    if mesh is not None:
        raise _not_ported("the multi-device mesh", "item 9")
    batch_loss = make_proposal_batch_loss(model)
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the detector has no trainable parameter: call "
                         "model.trainable_() first")

    def step(batch):
        loss, parts = batch_loss(batch)
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        return {"loss": loss.detach(), "grad_norm": g_norm,
                **{k: v.detach() for k, v in parts.items()}}

    return step
