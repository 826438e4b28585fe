#!/usr/bin/env python3
"""Import torchvision ``maskrcnn_resnet50_fpn`` weights for the PyTorch/CUDA
port's detector (models/proposal/maskrcnn.MaskRCNN): the counterpart of
tools/import_maskrcnn_weights.py, with its own copy of the mapping onto the
JAX package's flax tree:

  backbone.body.*                  -> backbone (import_torch_weights_torch)
  backbone.fpn.inner_blocks.{i}    -> fpn lateral_c{i+2}
  backbone.fpn.layer_blocks.{i}    -> fpn post_p{i+2}
  rpn.head.conv / cls_logits / bbox_pred  -> rpn
  roi_heads.box_head.fc6/fc7       -> box_head fc6/fc7
  roi_heads.box_predictor.*        -> box_head cls_score/bbox_pred
  roi_heads.mask_head.mask_fcn{i}  -> mask_head mask_fcn{i}
  roi_heads.mask_predictor.*       -> mask_head conv5_mask/mask_fcn_logits

Two layouts need more than a transpose: torchvision's box head flattens
its ROI features as (C, H, W) and flax as (H, W, C), so fc6's input axis is
reordered; and a torch transposed conv convolves where flax's correlates,
so conv5_mask's kernel is flipped spatially as well.

Usage:
  python tools/import_maskrcnn_weights_torch.py --pth maskrcnn.pth --out mrcnn.msgpack

The msgpack is the JAX package's ``{"params", "batch_stats"}`` blob, byte
for byte as tools/import_maskrcnn_weights.py writes it; both packages'
tools/extract_proposals*.py read it with --params (R-50-FPN, 81 classes).
"""

import argparse
import os
import sys
from typing import Dict, Mapping, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.import_torch_weights_torch import load_torch_resnet, read_pth  # noqa: E402


def _t(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))       # OIHW -> HWIO


def _t_deconv(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (in, out, kh, kw), which convolves -> flax
    ConvTranspose (kh, kw, in, out) with transpose_kernel=False, which
    correlates: the layout transpose plus a spatial flip."""
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1].copy()


def _dense(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))             # (out, in) -> (in, out)


def _dense_from_chw(w: np.ndarray, c: int, h: int, ww: int) -> np.ndarray:
    """A dense layer over flattened conv features: torch flattens (C, H, W),
    flax (H, W, C); reorder the input axis."""
    out = w.shape[0]
    w = w.reshape(out, c, h, ww).transpose(0, 2, 3, 1).reshape(out, -1)
    return np.transpose(w, (1, 0))


def _get(sd: Mapping[str, np.ndarray], *names: str) -> np.ndarray:
    """The first key present (torchvision renamed its conv containers
    across versions: 'rpn.head.conv.weight' vs 'rpn.head.conv.0.0.weight')."""
    for n in names:
        if n in sd:
            return sd[n]
    raise KeyError(f"none of {names} in state dict")


def _conv(sd, *prefixes: str) -> Dict:
    return {"kernel": _t(_get(sd, *(f"{p}.weight" for p in prefixes))),
            "bias": _get(sd, *(f"{p}.bias" for p in prefixes))}


def load_torchvision_maskrcnn(state_dict: Mapping[str, np.ndarray]
                              ) -> Tuple[Dict, Dict]:
    """(params, batch_stats) in the layout of the JAX package's
    models/proposal/maskrcnn.MaskRCNN, which the port's weight bridge
    (weights.load_flax_variables) loads into the port's MaskRCNN."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    body = {k[len("backbone.body."):]: v for k, v in sd.items()
            if k.startswith("backbone.body.")}
    bb_params, bb_stats = load_torch_resnet(body, (3, 4, 6, 3),
                                            bottleneck=True)
    fpn: Dict = {}
    for i, lvl in enumerate(("c2", "c3", "c4", "c5")):
        fpn[f"lateral_{lvl}"] = _conv(sd, f"backbone.fpn.inner_blocks.{i}",
                                      f"backbone.fpn.inner_blocks.{i}.0")
    for i, lvl in enumerate(("p2", "p3", "p4", "p5")):
        fpn[f"post_{lvl}"] = _conv(sd, f"backbone.fpn.layer_blocks.{i}",
                                   f"backbone.fpn.layer_blocks.{i}.0")
    rpn = {"conv": _conv(sd, "rpn.head.conv", "rpn.head.conv.0.0"),
           "cls_logits": _conv(sd, "rpn.head.cls_logits"),
           "bbox_pred": _conv(sd, "rpn.head.bbox_pred")}
    pred = "roi_heads.box_predictor"
    box_head = {
        # fc6 takes the flattened 7x7x256 ROI features: CHW -> HWC
        "fc6": {"kernel": _dense_from_chw(
                    sd["roi_heads.box_head.fc6.weight"], 256, 7, 7),
                "bias": sd["roi_heads.box_head.fc6.bias"]},
        "fc7": {"kernel": _dense(sd["roi_heads.box_head.fc7.weight"]),
                "bias": sd["roi_heads.box_head.fc7.bias"]},
        "cls_score": {"kernel": _dense(sd[f"{pred}.cls_score.weight"]),
                      "bias": sd[f"{pred}.cls_score.bias"]},
        "bbox_pred": {"kernel": _dense(sd[f"{pred}.bbox_pred.weight"]),
                      "bias": sd[f"{pred}.bbox_pred.bias"]},
    }
    mask_head = {f"mask_fcn{i}": _conv(sd, f"roi_heads.mask_head.mask_fcn{i}",
                                       f"roi_heads.mask_head.{i - 1}.0")
                 for i in range(1, 5)}
    mask_head["conv5_mask"] = {
        "kernel": _t_deconv(sd["roi_heads.mask_predictor.conv5_mask.weight"]),
        "bias": sd["roi_heads.mask_predictor.conv5_mask.bias"]}
    mask_head["mask_fcn_logits"] = _conv(
        sd, "roi_heads.mask_predictor.mask_fcn_logits")
    params = {"backbone": bb_params, "fpn": fpn, "rpn": rpn,
              "box_head": box_head, "mask_head": mask_head}
    return params, {"backbone": bb_stats}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pth", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from dmm_net_tpu_torch.utils.checkpoint import msgpack_serialize

    params, stats = load_torchvision_maskrcnn(read_pth(args.pth))
    with open(args.out, "wb") as f:
        f.write(msgpack_serialize({"params": params, "batch_stats": stats}))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
