"""DMM-Net frame step: backbone -> pooling -> cost -> matching ->
aggregation -> decoder.

Counterpart of the JAX package's models/dmm.py. Public layouts are the
JAX package's: frames (B, H, W, 3), masks (B, K, h, w), X (B, M, N),
decoder state (B, M, H/32, W/32, F). The feature pyramid is NCHW.

With ``matching.use_pallas`` the pooling, cost and Sinkhorn run as one
fused kernel (kernels/matcher.py: CUDA on the card, its plain version on
the CPU); otherwise as separate ops (ops/).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dmm_net_tpu_torch import resolve_device
from dmm_net_tpu_torch.config import Config
from dmm_net_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from dmm_net_tpu_torch.kernels.matcher import fused_pool_cost_match
from dmm_net_tpu_torch.models.decoder import RefinementDecoder, SharedFPNDecoder
from dmm_net_tpu_torch.models.layers import Conv, init_random
from dmm_net_tpu_torch.models.resnet import backbone_by_name, feature_dims
from dmm_net_tpu_torch.ops.cost import cost_matrix
from dmm_net_tpu_torch.ops.matching import (hard_assignment, pgd_match,
                                            sinkhorn_match)
from dmm_net_tpu_torch.ops.resize import resize
from dmm_net_tpu_torch.ops.roi_pool import mask_avg_pool


class FrameState(NamedTuple):
    """Carried across frames of one sequence."""

    template_masks: torch.Tensor   # (B, M, h, w) soft masks for the IoU term
    decoder_state: torch.Tensor    # (B, M, H/32, W/32, F) float32 ConvGRU state


class FrameOutput(NamedTuple):
    logits: torch.Tensor           # (B, M, h, w) per-object mask logits
    assignment: torch.Tensor       # (B, M, N) soft assignment X
    agg_masks: torch.Tensor        # (B, M, h, w) matcher-aggregated masks


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _mask_dtype(cfg: Config) -> torch.dtype:
    return _dtype(cfg.model.mask_dtype)


def mask_hw(cfg: Config) -> Tuple[int, int]:
    """The (h, w) grid masks live on inside the frame step."""
    H, W = cfg.model.image_size
    if cfg.model.mask_res == "stride4":
        return (H // 4, W // 4)
    return (H, W)


def _to_mask_grid(m: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Resize trailing (h, w) to the mask grid (no-op when already there)."""
    return resize(m, hw)


def decoder_state_dim(cfg: Config) -> int:
    """Channel width of the carried ConvGRU state."""
    if cfg.model.decoder_variant == "shared":
        return cfg.model.decoder_obj_dim
    return cfg.model.decoder_dim


def init_frame_state(cfg: Config, tmpl_masks: torch.Tensor) -> FrameState:
    """Initial FrameState from frame-1 templates (any resolution; stored
    at the config's mask grid and dtype)."""
    B, M = tmpl_masks.shape[:2]
    H, W = cfg.model.image_size
    dec = torch.zeros((B, M, H // 32, W // 32, decoder_state_dim(cfg)),
                      dtype=torch.float32, device=tmpl_masks.device)
    tm = _to_mask_grid(tmpl_masks.to(_mask_dtype(cfg)), mask_hw(cfg))
    return FrameState(template_masks=tm, decoder_state=dec)


class DMMNet(nn.Module):
    """Differentiable Mask-Matching network (one frame step, inference).

    Weights are random from ``seed`` (a ``torch.Generator``) until the
    caller loads a checkpoint (weights.load_flax_variables)."""

    def __init__(self, config: Config, device=None, seed: int = 0):
        super().__init__()
        cfg = config
        self.config = cfg
        dims = feature_dims(cfg.model.backbone)
        self.backbone = backbone_by_name(cfg.model.backbone,
                                         dtype=_dtype(cfg.model.backbone_dtype))
        self.feat_proj = Conv(dims["c4"], cfg.model.feature_dim, 1,
                              dtype=torch.float32)
        m = cfg.model
        if m.decoder_variant == "shared":
            self.decoder = SharedFPNDecoder(
                dims, features=m.decoder_dim, obj_features=m.decoder_obj_dim,
                recurrent=m.decoder_recurrent, dtype=_dtype(m.decoder_dtype),
                fine_level=m.decoder_fine_level, obj_fuse=m.decoder_obj_fuse,
                obj_features_fine=m.decoder_obj_dim_fine,
                features_fine=m.decoder_dim_fine,
                obj_merge_fine_k=m.decoder_obj_merge_fine_k,
                obj_fine_level=m.decoder_obj_fine_level,
                detail_dim=m.decoder_detail_dim,
                detail_basis_k=m.decoder_detail_basis_k)
        else:
            self.decoder = RefinementDecoder(
                dims, features=m.decoder_dim, recurrent=m.decoder_recurrent,
                dtype=_dtype(m.decoder_dtype), fine_level=m.decoder_fine_level)
        init_random(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))
        self.eval()
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.feat_proj.weight.device

    def extract_features(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """frames (B, H, W, 3) uint8 or float in [0, 1] -> NCHW pyramid
        {"c1".."c5"} at the backbone dtype plus "emb" (c4 projected to the
        matching space, float32)."""
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0
        if self.config.model.input_norm == "imagenet":
            mean = torch.as_tensor(IMAGENET_MEAN, device=frames.device)
            std = torch.as_tensor(IMAGENET_STD, device=frames.device)
            frames = (frames.float() - mean) / std
        feats = dict(self.backbone(frames.permute(0, 3, 1, 2)))
        feats["emb"] = self.feat_proj(feats["c4"].float())
        return feats

    def pool_mask_features(self, feats: Dict[str, torch.Tensor],
                           masks: torch.Tensor) -> torch.Tensor:
        """masks (B, K, h, w) -> (B, K, D) pooled embedding vectors."""
        return mask_avg_pool(feats["emb"].permute(0, 2, 3, 1), masks)

    def match_step(self, tmpl_masks, prop_masks, tmpl_feats, prop_feats,
                   row_mask, col_mask) -> torch.Tensor:
        """Cost + Sinkhorn on masks resized to the cost grid (unfused path).
        Returns X (B, M, N)."""
        cfg = self.config
        mh, mw = cfg.cost.mask_size

        def flat(m):
            return resize(m, (mh, mw)).reshape(m.shape[0], m.shape[1], mh * mw)

        C = cost_matrix(flat(tmpl_masks), flat(prop_masks), tmpl_feats,
                        prop_feats, row_mask=row_mask, col_mask=col_mask,
                        iou_weight=cfg.cost.iou_weight)
        if cfg.matching.solver == "pgd":
            return pgd_match(C, row_mask, col_mask, step=cfg.matching.pgd_step,
                             pgd_iters=cfg.matching.pgd_iters,
                             dykstra_iters=cfg.matching.dykstra_iters)
        return sinkhorn_match(C, row_mask, col_mask,
                              epsilon=cfg.matching.epsilon,
                              iters=cfg.matching.sinkhorn_iters,
                              implicit_grad=cfg.matching.implicit_grad,
                              epsilon_init=cfg.matching.epsilon_init or None)

    @staticmethod
    def aggregate(X: torch.Tensor, prop_masks: torch.Tensor,
                  row_mask: torch.Tensor) -> torch.Tensor:
        """Soft aggregation M_i = sum_j X_ij mask_j: X (B, M, N), prop_masks
        (B, N, h, w) -> (B, M, h, w) float32. X is rounded to the masks'
        dtype and the sum accumulates in float32 (bf16 products are exact
        in float32), as the reference's preferred_element_type einsum."""
        B, N, h, w = prop_masks.shape
        agg = X.to(prop_masks.dtype).float() @ prop_masks.float().reshape(B, N, h * w)
        agg = agg.reshape(B, -1, h, w)
        return torch.where(row_mask[..., None, None], agg, torch.zeros_like(agg))

    def forward(self, frame: torch.Tensor, prop_masks: torch.Tensor,
                prop_valid: torch.Tensor, tmpl_feats: torch.Tensor,
                tmpl_valid: torch.Tensor, state: FrameState,
                feats: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[FrameOutput, FrameState]:
        """One frame step. decode="argmax" hardens X row-wise; "soft" (and
        "hungarian", which the engine handles) aggregate with soft X."""
        feats, X = self.match_assignment(frame, prop_masks, prop_valid,
                                         tmpl_feats, tmpl_valid, state, feats)
        if self.config.matching.decode == "argmax":
            idx = hard_assignment(X, tmpl_valid, prop_valid)
            X = (F.one_hot(idx.clamp_min(0).long(), X.shape[-1]).to(X.dtype)
                 * (idx >= 0)[..., None].to(X.dtype))
        return self.decode_from_assignment(feats, X, prop_masks, tmpl_valid,
                                           state)

    def match_assignment(self, frame, prop_masks, prop_valid, tmpl_feats,
                         tmpl_valid, state: FrameState, feats=None):
        """Backbone + pooling + cost + matching; returns (feats, soft X)."""
        if feats is None:
            feats = self.extract_features(frame)
        cfg = self.config
        mdt = _mask_dtype(cfg)
        mhw = mask_hw(cfg)
        prop_masks = _to_mask_grid(prop_masks.to(mdt), mhw)
        tmpl_masks = _to_mask_grid(state.template_masks.to(mdt), mhw)
        if cfg.matching.use_pallas:
            emb = feats["emb"]
            B, D, eh, ew = emb.shape
            M, N = tmpl_masks.shape[1], prop_masks.shape[1]
            mh, mw = cfg.cost.mask_size
            pm_pool = resize(prop_masks, (eh, ew)).reshape(B, N, -1).float()
            tm_cost = resize(tmpl_masks, (mh, mw)).reshape(B, M, -1).float()
            pm_cost = resize(prop_masks, (mh, mw)).reshape(B, N, -1).float()
            X = fused_pool_cost_match(
                emb.permute(0, 2, 3, 1).reshape(B, eh * ew, D).contiguous(),
                pm_pool.contiguous(), tm_cost.contiguous(),
                pm_cost.contiguous(), tmpl_feats.float().contiguous(),
                tmpl_valid, prop_valid,
                epsilon=cfg.matching.epsilon,
                iters=cfg.matching.sinkhorn_iters,
                iou_weight=cfg.cost.iou_weight,
                epsilon_init=cfg.matching.epsilon_init or None)
        else:
            prop_feats = self.pool_mask_features(feats, prop_masks)
            X = self.match_step(tmpl_masks, prop_masks, tmpl_feats, prop_feats,
                                tmpl_valid, prop_valid)
        return feats, X

    def decode_from_assignment(self, feats, X, prop_masks, tmpl_valid,
                               state: FrameState
                               ) -> Tuple[FrameOutput, FrameState]:
        """Aggregation + refinement from a (possibly hardened) assignment."""
        cfg = self.config
        mdt = _mask_dtype(cfg)
        prop_masks = _to_mask_grid(prop_masks.to(mdt), mask_hw(cfg))
        agg = self.aggregate(X, prop_masks, tmpl_valid)
        out_hw = (mask_hw(cfg) if cfg.model.logits_res == "mask"
                  else tuple(cfg.model.image_size))
        logits, dec_state = self.decoder(feats, agg, state.decoder_state,
                                         out_hw=out_hw)
        logits = torch.where(tmpl_valid[..., None, None], logits,
                             torch.full_like(logits, -1e4))
        out = FrameOutput(logits=logits, assignment=X, agg_masks=agg)
        if cfg.model.template_update == "aggregation":
            new_templates = agg.clamp(0.0, 1.0)
        else:
            new_templates = _to_mask_grid(torch.sigmoid(logits), mask_hw(cfg))
        new_state = FrameState(template_masks=new_templates.to(mdt),
                               decoder_state=dec_state)
        return out, new_state

    def init_state(self, tmpl_masks: torch.Tensor) -> FrameState:
        return init_frame_state(self.config, tmpl_masks)
