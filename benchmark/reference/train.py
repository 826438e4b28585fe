"""Reference of the first train steps: clip forward through the frame
step, the masked BCE + soft-IoU loss, gradients by autograd, the global
norm clip at 1.0, and AdamW in optax's float32 order under the warmup-
cosine schedule.

``first_steps`` follows ``n`` updates from the same weights on the same
batches as the program's first ``n`` steps, and returns what the
comparison reads: each step's loss, every parameter's clipped gradient norm
at the first step, and every parameter's change after the ``n`` steps.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.model import FrameStep


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def loss_counts(batch) -> tuple:
    """The loss's two denominators over a whole batch: valid (clip, frame,
    object) entries, and those of them whose target is not empty."""
    t = batch["gt_masks"]
    v = batch["tmpl_valid"].bool()[:, None, :].expand(t.shape[:3])
    nonempty = t.flatten(-2).amax(-1) > 0
    return (float(v.sum().clamp_min(1)), float((v & nonempty).sum().clamp_min(1)))


def loss_terms(logits, targets, valid):
    """Numerators of the masked BCE and of 1 - soft IoU: logits, targets
    (B, T, M, H, W); valid (B, M), one mask for every frame. BCE per object
    is its pixels' mean; the IoU term counts valid objects whose target is
    not empty."""
    v = valid[:, None, :].expand(logits.shape[:3]).float()
    t = targets.float()
    per_obj = (t * _softplus(-logits) + (1.0 - t) * _softplus(logits)).mean(dim=(-2, -1))
    p = torch.exp(-_softplus(-logits))
    p = torch.minimum(torch.maximum(p, torch.zeros_like(p)), torch.ones_like(p))
    inter = (p * t).sum(dim=(-2, -1))
    union = (p + t - p * t).sum(dim=(-2, -1))
    vi = v * (t.sum(dim=(-2, -1)) > 0).float()
    return (per_obj * v).sum(), ((1.0 - inter / union.clamp_min(1e-6)) * vi).sum()


def clip_forward(step: FrameStep, batch: Dict[str, torch.Tensor], cfg: dict,
                 counts: tuple):
    """The loss of a batch of clips (or of some rows of it, over the whole
    batch's ``counts``): frames (B, T, H, W, 3), prop_masks (B, T, N, H, W),
    prop_valid (B, T, N), tmpl_masks (B, M, H, W), tmpl_valid (B, M),
    gt_masks (B, T, M, H, W). Template features come from the first
    frame's features."""
    frames = batch["frames"]
    tv = batch["tmpl_valid"].bool()
    state = step.init_state(batch["tmpl_masks"])
    tfeats, logits = None, []
    for t in range(frames.shape[1]):
        feats = step.features(frames[:, t])
        if tfeats is None:
            tfeats = step.template_features_from(feats, batch["tmpl_masks"])
        lg, _, state = step(frames[:, t], batch["prop_masks"][:, t],
                            batch["prop_valid"][:, t].bool(), tfeats, tv, state, feats)
        logits.append(lg)
    bce, iou = loss_terms(torch.stack(logits, 1), batch["gt_masks"], tv)
    tr = cfg["train"]
    return tr["loss_bce_weight"] * bce / counts[0] + tr["loss_iou_weight"] * iou / counts[1]


def warmup_cosine_lr(tr: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total) at ``count``
    updates applied, in float32."""
    f32 = np.float32
    decay = max(tr["total_steps"], tr["warmup_steps"] + 1)
    if count < tr["warmup_steps"]:
        frac = f32(1) - f32(count) / f32(tr["warmup_steps"])
        return float(f32(0.0 - tr["lr"]) * frac + f32(tr["lr"]))
    span = decay - tr["warmup_steps"]
    c = f32(min(count - tr["warmup_steps"], span))
    return float(f32(tr["lr"]) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(span), dtype=f32)))


def _f32(x):
    return float(np.float32(x))


def first_steps(step: FrameStep, batches: List[Dict[str, torch.Tensor]],
                cfg: dict, rows: int = 0) -> dict:
    """``len(batches)`` updates of the reference from its current
    parameters. ``rows`` > 0 takes each batch's gradient in blocks of that
    many clips, each block's loss over the whole batch's denominators, so
    that the blocks' gradients sum to the batch's. Returns
    {"loss": [per step], "grad_norm": {name: clipped norm at step 1},
    "change": {name: |p_n - p_0|}}."""
    tr = cfg["train"]
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, tr["weight_decay"]
    params = {n: p for n, p in step.named_parameters()}
    p0 = {n: p.detach().clone() for n, p in params.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    out = {"loss": [], "grad_norm": {}, "change": {}}
    for k, batch in enumerate(batches):
        grads, loss = _grads(step, batch, cfg, list(params.values()), rows)
        out["loss"].append(loss)
        gn = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
        if float(gn) >= 1.0:
            grads = [g / gn for g in grads]
        if k == 0:
            out["grad_norm"] = {n: float(g.norm()) for n, g in zip(params, grads)}
        lr = warmup_cosine_lr(tr, k)
        t = np.float32(k + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                mu[n] = mu[n] * _f32(b1) + g * _f32(1 - b1)
                nu[n] = nu[n] * _f32(b2) + (g * g) * _f32(1 - b2)
                u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + _f32(eps))
                if wd:
                    u = u + p * _f32(wd)
                p.add_(u * (-_f32(lr)))
    out["change"] = {n: float((p.detach() - p0[n]).norm()) for n, p in params.items()}
    return out


def _grads(step, batch, cfg, params, rows):
    B = batch["frames"].shape[0]
    rows = rows or B
    counts = loss_counts(batch)
    grads = [torch.zeros_like(p) for p in params]
    loss = 0.0
    for r0 in range(0, B, rows):
        part = {k: v[r0:r0 + rows] for k, v in batch.items()}
        part_loss = clip_forward(step, part, cfg, counts)
        gs = torch.autograd.grad(part_loss, params, allow_unused=True)
        for acc, g in zip(grads, gs):
            if g is not None:
                acc.add_(g)
        loss += float(part_loss.detach())
    if not math.isfinite(loss):
        raise FloatingPointError("the reference's loss is not finite")
    return grads, loss
