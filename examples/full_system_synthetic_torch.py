#!/usr/bin/env python3
"""Full-system synthetic benchmark with the PyTorch/CUDA port: LEARNED
proposals end to end, the counterpart of examples/full_system_synthetic.py.

The reference's production topology is two-stage: a Mask R-CNN produces
mask proposals, and DMM-Net matches and refines them. This script runs it
with no ground truth in the proposal path:

  frames -> trained Mask R-CNN -> compact detections (boxes, 28x28 masks,
         valid) -> InferenceEngine.run_stream_chunked -> labels -> J&F

and reports, over held-out synthetic videos:
  * J&F with DETECTOR proposals (the production topology);
  * J&F with PLANTED proposals (the jittered ground truth the generator
    emits: the upper bound);
  * the detector's per-frame proposal recall@0.5 against the video's
    ground truth (mask IoU, on the device).

Weights:
  * --dmm: anything utils/checkpoint.load_checkpoint reads (a JAX-package
    msgpack blob such as artifacts/dmm128_fallback.msgpack, or the port's
    torch checkpoint), with its config; --set overrides the config;
  * --mrcnn: the {"params", "batch_stats"} msgpack that train_proposal.py
    or train_proposal_torch.py --save writes.

Usage:
  python examples/full_system_synthetic_torch.py \
      --dmm artifacts/dmm128_fallback.msgpack --mrcnn runs/p/mrcnn.msgpack \
      [--eval-seqs 8] [--frames 8] [--device cpu]

--min-jf and --min-recall gate the detector-proposal J&F and the recall:
below either, the script exits non-zero. Runs on CUDA unless --device
says otherwise.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dmm", required=True)
    ap.add_argument("--mrcnn", required=True)
    ap.add_argument("--mrcnn-backbone", default="resnet18")
    ap.add_argument("--mrcnn-classes", type=int, default=3)
    ap.add_argument("--eval-seqs", type=int, default=8)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed0", type=int, default=5000,
                    help="first sequence seed (held out: training pools use "
                    "seeds < distinct_batches and >= 10000 for detection)")
    ap.add_argument("--score-thresh", type=float, default=0.05)
    ap.add_argument("--chunk", type=int, default=4,
                    help="frames per chunk of run_stream_chunked")
    ap.add_argument("--min-jf", type=float, default=0.0,
                    help="exit non-zero if the mean detector-proposal J&F "
                    "falls below this")
    ap.add_argument("--min-recall", type=float, default=0.0,
                    help="exit non-zero if the mean proposal recall@0.5 "
                    "falls below this")
    ap.add_argument("--set", nargs="*", default=[],
                    help="dotted overrides of the DMM's config, e.g. "
                    "matching.use_pallas=true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
    from dmm_net_tpu_torch.eval.davis_jf import evaluate_sequence
    from dmm_net_tpu_torch.infer.compact import compact_stream
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.models.dmm import DMMNet
    from dmm_net_tpu_torch.models.proposal.maskrcnn import MaskRCNN, paste_masks
    from dmm_net_tpu_torch.utils.checkpoint import load_checkpoint, msgpack_restore
    from dmm_net_tpu_torch.utils.cli import parse_overrides
    from dmm_net_tpu_torch.weights import load_flax_variables

    cfg, loaded = load_checkpoint(args.dmm)
    if cfg is None:
        raise SystemExit(f"{args.dmm}: carries no config")
    cfg = cfg.override(**parse_overrides(getattr(args, "set")))
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals

    det = MaskRCNN(image_size=(H, W), backbone_name=args.mrcnn_backbone,
                   num_classes=args.mrcnn_classes,
                   score_thresh=args.score_thresh, max_detections=N,
                   device=args.device)
    with open(args.mrcnn, "rb") as f:
        load_flax_variables(det, msgpack_restore(f.read()))

    model = None
    if "state_dict" in loaded:
        model = DMMNet(cfg, device=args.device)
        model.load_state_dict(loaded["state_dict"])
    engine = InferenceEngine(cfg, model=model, variables=loaded.get("variables"),
                             update_templates=True, device=args.device)
    dev = det.device

    def detect(frame, gt):
        """One frame (H, W, 3) and its gt masks (G, H, W) -> compact
        detections (boxes (D, 4), masks28 (D, 28, 28), valid (D,)) and each
        gt's best mask IoU (G,), computed on the device."""
        x = torch.from_numpy(frame).to(dev).permute(2, 0, 1)[None].float()
        out = det(x)
        fb = paste_masks(out["masks"], out["boxes"], out["valid"], (H, W))
        g = torch.from_numpy(gt).to(dev).float()
        inter = torch.einsum("dhw,ghw->dg", fb, g)
        union = fb.sum((1, 2))[:, None] + g.sum((1, 2))[None, :] - inter
        iou = inter / union.clamp_min(1.0)
        iou = torch.where(out["valid"][:, None], iou, torch.zeros_like(iou))
        return (out["boxes"].cpu().numpy(), out["masks"].cpu().numpy(),
                out["valid"].cpu().numpy(), iou.max(0).values.cpu().numpy())

    def pad_m(x):
        return np.pad(x, [(0, M - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

    def run(seq, items):
        res = engine.run_stream_chunked(iter(items), pad_m(seq["tmpl_masks"])[None],
                                        pad_m(seq["tmpl_valid"])[None],
                                        seq["frames"][0][None], chunk=args.chunk)
        labels = res["labels"][:, 0]
        gt_labels = np.zeros_like(labels)
        for i in range(seq["gt_masks"].shape[1]):
            gt_labels[seq["gt_masks"][:, i] > 0.5] = i + 1
        return evaluate_sequence(gt_labels, labels)

    rows = []
    for s in range(args.seed0, args.seed0 + args.eval_seqs):
        seq = synthetic_sequence(seed=s, T=args.frames, H=H, W=W,
                                 num_objects=2, num_proposals=N)
        det_items, recalls = [], []
        for t in range(seq["frames"].shape[0]):
            gt_t = seq["gt_masks"][t] > 0.5
            boxes, m28, valid, best_iou = detect(seq["frames"][t], gt_t)
            det_items.append({"frame": seq["frames"][t][None],
                              "prop_boxes": boxes[None],
                              "prop_masks28": m28[None],
                              "prop_valid": valid[None]})
            live = gt_t.any(axis=(1, 2))
            recalls.append(((best_iou >= 0.5) & live).sum() / max(live.sum(), 1))
        r_det = run(seq, det_items)
        r_gt = run(seq, compact_stream(seq["frames"], seq["prop_masks"],
                                       seq["prop_valid"]))
        rows.append((s, float(np.mean(recalls)), r_det["J&F"], r_gt["J&F"]))
        print(f"seq {s}: recall@0.5={np.mean(recalls):.3f}  "
              f"J&F detector={r_det['J&F']:.3f}  planted={r_gt['J&F']:.3f}")

    rec = float(np.mean([r[1] for r in rows]))
    jf_det = float(np.mean([r[2] for r in rows]))
    jf_gt = float(np.mean([r[3] for r in rows]))
    print(f"\nmean over {len(rows)} held-out sequences:")
    print(f"  detector-proposal recall@0.5 : {rec:.3f}")
    print(f"  J&F with DETECTOR proposals  : {jf_det:.3f}")
    print(f"  J&F with PLANTED proposals   : {jf_gt:.3f}")
    if jf_det < args.min_jf or rec < args.min_recall:
        print(f"FAIL: detector-proposal J&F {jf_det:.3f} < {args.min_jf} "
              f"or recall {rec:.3f} < {args.min_recall}")
        raise SystemExit(1)
    print("OK")
    return {"recall": rec, "jf_detector": jf_det, "jf_planted": jf_gt,
            "rows": rows}


if __name__ == "__main__":
    main()
