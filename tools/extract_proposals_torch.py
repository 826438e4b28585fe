#!/usr/bin/env python3
"""Offline proposal extraction with the PyTorch/CUDA port (stage 0 of the
two-stage system): the counterpart of tools/extract_proposals.py.

Runs the port's Mask R-CNN over every frame of a DAVIS or YouTube-VOS split
and caches its detections per frame as json, ``<out>/<seq>/<stem>.json``
holding ``[{"bbox", "score", "rle": {"size", "counts"}}]`` (the masks
pasted at --image-size and RLE-encoded). Both packages' DAVIS and
YouTube-VOS readers consume it, keyed by the raw frame's stem.

Usage:
  python tools/extract_proposals_torch.py --dataset ytvos --root /data/YouTubeVOS \
      --out /data/proposals [--params maskrcnn.msgpack] [--sequences a b]
  python tools/extract_proposals_torch.py ... --device cpu

--params takes the {"params", "batch_stats"} flax msgpack that
tools/import_maskrcnn_weights.py and train_proposal.py write; it is read
without flax and loaded strictly. Without it the net runs with random
weights (seed 0), useful only to test the plumbing. Runs on CUDA unless
--device says otherwise.
"""

import argparse
import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["davis", "ytvos"], default="davis")
    ap.add_argument("--root", required=True)
    ap.add_argument("--split", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--params", default=None)
    ap.add_argument("--image-size", type=int, nargs=2, default=(256, 448))
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--num-classes", type=int, default=81,
                    help="must match the trained net (train_proposal.py "
                    "trains 3 classes on the synthetic detection set)")
    ap.add_argument("--max-detections", type=int, default=64)
    ap.add_argument("--score-thresh", type=float, default=0.05)
    ap.add_argument("--sequences", nargs="*", default=None)
    ap.add_argument("--input-norm", choices=["raw01", "imagenet"],
                    default="raw01",
                    help="input distribution the WEIGHTS were trained on: "
                    "the in-repo trainers feed raw [0, 1] RGB (raw01); "
                    "torch/COCO-imported weights expect ImageNet-normalised "
                    "inputs (imagenet)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dmm_net_tpu_torch.data.pipeline import normalize_frames
    from dmm_net_tpu_torch.models.proposal.maskrcnn import MaskRCNN, paste_masks
    from dmm_net_tpu_torch.ops import rle as rle_codec
    from dmm_net_tpu_torch.utils.checkpoint import msgpack_restore
    from dmm_net_tpu_torch.weights import load_flax_variables

    logging.basicConfig(format="%(asctime)s extract %(levelname)s: "
                        "%(message)s", level=logging.INFO)
    log = logging.getLogger("extract")
    H, W = args.image_size
    model = MaskRCNN(image_size=(H, W), backbone_name=args.backbone,
                     num_classes=args.num_classes,
                     score_thresh=args.score_thresh,
                     max_detections=args.max_detections, device=args.device)
    if args.params:
        with open(args.params, "rb") as f:
            load_flax_variables(model, msgpack_restore(f.read()))
        log.info("loaded params from %s", args.params)
    else:
        log.warning("running with RANDOM weights: plumbing test only")

    if args.dataset == "davis":
        from dmm_net_tpu_torch.data.davis import DavisDataset
        ds = DavisDataset(args.root, split=args.split or "val", image_size=(H, W))
        seqs = args.sequences or ds.sequences
    else:
        from dmm_net_tpu_torch.data.ytvos import YTVOSDataset
        ds = YTVOSDataset(args.root, split=args.split or "valid",
                          image_size=(H, W))
        seqs = args.sequences or ds.videos

    for seq in seqs:
        frames = ds.frame_paths(seq)
        os.makedirs(os.path.join(args.out, seq), exist_ok=True)
        for fp in frames:
            # the cache key is the raw frame's stem (on YouTube-VOS stems and
            # loop indices diverge); every reader resolves frames by stem
            stem = os.path.splitext(os.path.basename(fp))[0]
            img = torch.tensor(ds.load_frame(fp), device=model.device)
            x = (normalize_frames(img) if args.input_norm == "imagenet"
                 else img.float() / 255.0)
            out = model(x.permute(2, 0, 1)[None])
            full = paste_masks(out["masks"], out["boxes"], out["valid"], (H, W))
            boxes, scores, valid, masks = (out["boxes"].cpu().numpy(),
                                           out["scores"].cpu().numpy(),
                                           out["valid"].cpu().numpy(),
                                           full.cpu().numpy())
            props = []
            for i in np.flatnonzero(valid):
                rle = rle_codec.encode(masks[i] > 0.5)
                props.append({"bbox": boxes[i].tolist(),
                              "score": float(scores[i]),
                              "rle": {"size": [int(s) for s in rle["size"]],
                                      "counts": rle["counts"].decode("latin1")}})
            with open(os.path.join(args.out, seq, f"{stem}.json"), "w") as f:
                json.dump(props, f)
        log.info("%s: %d frames", seq, len(frames))


if __name__ == "__main__":
    main()
