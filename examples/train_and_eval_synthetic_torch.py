#!/usr/bin/env python3
"""End-to-end learning proof for the PyTorch/CUDA port: train DMM-Net from
scratch on synthetic clips, then run the port's streaming inference engine
with the trained model and score DAVIS J&F. The counterpart of
examples/train_and_eval_synthetic.py, with its defaults (ResNet-18 at
64x64, 300 steps, epsilon 0.03, template_update="aggregation").

Usage: python examples/train_and_eval_synthetic_torch.py [--steps 300]
           [--size 64] [--set matching.use_pallas=true] [--device cpu]

Expected: decoder J&F rises from ~0 (untrained) to > 0.7: the decoder
learns to refine the matcher-aggregated masks. --mrcnn <msgpack> trains on
a Mask R-CNN's detections in place of the planted proposals: every frame of
every training batch goes through the detector (its flax msgpack, as
train_proposal_torch.py --save writes it), and its pasted, thresholded
masks, ordered by score, replace the batch's proposals on the device.
Runs on CUDA unless --device says otherwise.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", type=int, default=64, help="image height")
    ap.add_argument("--width", type=int, default=0,
                    help="image width (0 = square --size x --size)")
    ap.add_argument("--eval-frames", type=int, default=6)
    ap.add_argument("--objects", type=int, default=2,
                    help="objects per synthetic video (train and eval)")
    ap.add_argument("--decoder-variant", default="shared",
                    choices=["shared", "legacy"])
    ap.add_argument("--obj-dim", type=int, default=16)
    ap.add_argument("--backbone", default="resnet18")
    ap.add_argument("--feature-dim", type=int, default=32)
    ap.add_argument("--decoder-dim", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", default=None,
                    help="start from these weights instead of --seed's: "
                    "flax variables in msgpack, as the JAX package's "
                    "example writes them with --save (after --steps 0: its "
                    "initial weights), so both packages train from one "
                    "init")
    ap.add_argument("--distinct-batches", type=int, default=64,
                    help="synthetic batches are made once, on the device, "
                    "and cycled")
    ap.add_argument("--save", default=None,
                    help="write the trained model as the JAX example's flax "
                    "msgpack blob {config, variables} (served by "
                    "infer_torch.py --ckpt, infer.py --ckpt and both "
                    "full-system examples); named *.unverified until the "
                    "J&F gate passes")
    ap.add_argument("--mrcnn", default=None,
                    help="train on detector proposals: replace the planted "
                    "proposals of every training batch with detections of "
                    "this Mask R-CNN msgpack (the reference trains on "
                    "cached Mask R-CNN proposals)")
    ap.add_argument("--mrcnn-backbone", default="resnet18")
    ap.add_argument("--mrcnn-classes", type=int, default=4)
    ap.add_argument("--set", nargs="*", default=[],
                    help="dotted config overrides, e.g. "
                    "matching.use_pallas=true")
    ap.add_argument("--eval-seqs", type=int, default=1,
                    help="held-out sequences to score (seeds 999, 998, ...)")
    ap.add_argument("--eval-chunk", type=int, default=4,
                    help="frames per chunk of the chunked eval")
    ap.add_argument("--min-jf", type=float, default=0.5,
                    help="quality gate: exit nonzero if held-out J&F is "
                    "below this")
    ap.add_argument("--per-frame-eval", action="store_true",
                    help="evaluate through run_sequence with full-grid "
                    "proposals instead of run_stream_chunked with compact "
                    "ones")
    ap.add_argument("--ablate", action="store_true",
                    help="after training, score the same weights under "
                    "decode soft/argmax/hungarian and both template-update "
                    "sources")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from dmm_net_tpu_torch.config import (Config, DataConfig, MatchingConfig,
                                          ModelConfig, TrainConfig)
    from dmm_net_tpu_torch.data.synthetic import (synthetic_clip_batch,
                                                  synthetic_sequence)
    from dmm_net_tpu_torch.eval.davis_jf import evaluate_sequence
    from dmm_net_tpu_torch.infer.compact import compact_stream
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.models.dmm import DMMNet
    from dmm_net_tpu_torch.train.loop import (batch_to, create_train_state,
                                              make_train_step)

    S = args.size
    SW = args.width or S
    cfg = Config(
        name="train_and_eval",
        model=ModelConfig(backbone=args.backbone, backbone_dtype="float32",
                          feature_dim=args.feature_dim,
                          decoder_dim=args.decoder_dim,
                          decoder_variant=args.decoder_variant,
                          decoder_obj_dim=args.obj_dim,
                          image_size=(S, SW), template_update="aggregation"),
        matching=MatchingConfig(max_templates=4, max_proposals=8,
                                sinkhorn_iters=15, epsilon=0.03),
        data=DataConfig(dataset="synthetic", batch_size=4, clip_length=3),
        train=TrainConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps,
                          loss_iou_weight=0.5),
    )
    if args.set:
        from dmm_net_tpu_torch.utils.cli import parse_overrides
        cfg = cfg.override(**parse_overrides(args.set))
        print(f"overrides: {args.set}")

    variables = None
    if args.init:
        from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt
        variables = load_msgpack_ckpt(args.init)[1]
        print(f"initial weights from {args.init}")
    state = create_train_state(cfg, seed=args.seed, variables=variables,
                               device=args.device)
    device = state.model.device
    print(f"device: {device}")
    batches = [batch_to(synthetic_clip_batch(
        seed=s, batch=cfg.data.batch_size, T=cfg.data.clip_length, H=S, W=SW,
        num_objects=args.objects, num_proposals=cfg.matching.max_proposals,
        pad_objects=cfg.matching.max_templates), device)
        for s in range(args.distinct_batches)]
    if args.mrcnn:
        t_det = time.time()
        det = load_detector(args, (S, SW), cfg.matching.max_proposals, device)
        for b in batches:
            b["prop_masks"], b["prop_valid"] = detect_batch(det, b["frames"])
        print(f"replaced planted proposals with detector output for "
              f"{len(batches)} batches in {time.time() - t_det:.0f}s")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step = make_train_step(cfg)
    t0 = time.time()
    for i in range(args.steps):
        metrics = step(state, batches[i % args.distinct_batches])
        if i == 0:
            sync()
            print(f"first step: {time.time() - t0:.1f}s")
            t0 = time.time()
        if (i + 1) % 50 == 0:
            print(f"step {i + 1}: loss={float(metrics['loss']):.4f}")
    sync()
    sps = (args.steps - 1) / max(time.time() - t0, 1e-9)
    print(f"steps/sec: {sps:.2f} ({1e3 / max(sps, 1e-9):.1f} ms per step)")
    final_loss = float(metrics["loss"]) if args.steps else None

    saved_tmp = None
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)) or ".",
                    exist_ok=True)
        saved_tmp = args.save + ".unverified"
        from dmm_net_tpu_torch.utils.checkpoint import msgpack_serialize
        from dmm_net_tpu_torch.weights import to_flax_variables
        with open(saved_tmp, "wb") as f:
            f.write(msgpack_serialize({"config": cfg.to_dict(),
                                       "variables": to_flax_variables(state.model)}))
        print(f"saved (unverified) DMM variables + config to {saved_tmp}")

    model = state.model.eval()       # BN back on its running statistics
    engine = InferenceEngine(cfg, model=model, update_templates=True,
                             device=device)
    M = cfg.matching.max_templates

    def pad_m(x, axis=0):
        p = [(0, 0)] * x.ndim
        p[axis] = (0, M - x.shape[axis])
        return np.pad(x, p)

    def stream(seq):
        for t in range(args.eval_frames):
            yield {"frame": seq["frames"][t][None],
                   "prop_masks": seq["prop_masks"][t][None],
                   "prop_valid": seq["prop_valid"][t][None]}

    seq = gt_labels = tmpl_masks = tmpl_valid = None
    jfs = []
    for k in range(args.eval_seqs):
        seq = synthetic_sequence(seed=999 - k, T=args.eval_frames, H=S, W=SW,
                                 num_objects=args.objects,
                                 num_proposals=cfg.matching.max_proposals)
        tmpl_masks = pad_m(seq["tmpl_masks"])[None]
        tmpl_valid = pad_m(seq["tmpl_valid"])[None]
        if args.per_frame_eval:
            res = engine.run_sequence(stream(seq), tmpl_masks, tmpl_valid,
                                      seq["frames"][0][None])
        else:
            res = engine.run_stream_chunked(
                compact_stream(seq["frames"], seq["prop_masks"],
                               seq["prop_valid"]),
                tmpl_masks, tmpl_valid, seq["frames"][0][None],
                chunk=args.eval_chunk)
        labels = res["labels"][:, 0]
        gt_labels = np.zeros_like(labels)
        for i in range(args.objects):
            gt_labels[seq["gt_masks"][:, i] > 0.5] = i + 1
        rk = evaluate_sequence(gt_labels, labels)
        jfs.append(rk)
        print(f"  eval seq {999 - k}: J&F={rk['J&F']:.3f} "
              f"(J={rk['J']:.3f} F={rk['F']:.3f})")
    r = {k: float(np.mean([x[k] for x in jfs])) for k in ("J", "F", "J&F")}
    print(f"decoder (trained {args.steps} steps) J&F = {r['J&F']:.3f} "
          f"(J={r['J']:.3f} F={r['F']:.3f}) over {args.eval_seqs} held-out "
          f"seq(s), {'per-frame' if args.per_frame_eval else 'chunked-compact'}"
          " eval")
    if saved_tmp is not None and r["J&F"] >= args.min_jf:
        os.replace(saved_tmp, args.save)
        print(f"quality gate passed (J&F {r['J&F']:.3f} >= {args.min_jf}); "
              f"verified checkpoint at {args.save}")

    if args.ablate:
        print("\n--- decode / template-update ablation (same weights) ---")
        for decode in ("soft", "argmax", "hungarian"):
            for tupd in ("aggregation", "decoder"):
                for upd in (True, False):
                    if not upd and tupd == "decoder":
                        continue  # template source irrelevant w/o updates
                    c = dataclasses.replace(
                        cfg,
                        matching=dataclasses.replace(cfg.matching,
                                                     decode=decode),
                        model=dataclasses.replace(cfg.model,
                                                  template_update=tupd))
                    m = DMMNet(c, device=device)
                    m.load_state_dict(model.state_dict())
                    eng = InferenceEngine(c, model=m, update_templates=upd,
                                          device=device)
                    rr = eng.run_sequence(stream(seq), tmpl_masks, tmpl_valid,
                                          seq["frames"][0][None])
                    ra = evaluate_sequence(gt_labels, rr["labels"][:, 0])
                    print(f"decode={decode:9s} tmpl={tupd:11s} "
                          f"update={str(upd):5s} J&F={ra['J&F']:.3f} "
                          f"(J={ra['J']:.3f} F={ra['F']:.3f})")

    result = {"jf": r, "steps_per_sec": sps, "steps": args.steps,
              "final_loss": final_loss}
    from dmm_net_tpu_torch.kernels import _build
    report = _build.cuda_report(device)
    if report:
        print(report, flush=True)
    if r["J&F"] < args.min_jf:
        print(f"FAIL: held-out J&F {r['J&F']:.3f} < --min-jf {args.min_jf}"
              + (f" (model left at {saved_tmp}, not promoted)"
                 if saved_tmp else ""))
        sys.exit(1)
    print("OK")
    return result


def load_detector(args, image_size, N: int, device):
    """The --mrcnn detector: N detections a frame, score threshold 0.05."""
    from dmm_net_tpu_torch.models.proposal.maskrcnn import MaskRCNN
    from dmm_net_tpu_torch.utils.checkpoint import msgpack_restore
    from dmm_net_tpu_torch.weights import load_flax_variables

    det = MaskRCNN(image_size=image_size, backbone_name=args.mrcnn_backbone,
                   num_classes=args.mrcnn_classes, score_thresh=0.05,
                   max_detections=N, device=device)
    with open(args.mrcnn, "rb") as f:
        load_flax_variables(det, msgpack_restore(f.read()))
    return det


def detect_batch(det, frames):
    """The detector's detections on every frame of a clip batch (B, T, H, W,
    3) on its device: (prop_masks (B, T, N, H, W) binary float32,
    prop_valid (B, T, N)), ordered by score, the invalid last."""
    import torch

    from dmm_net_tpu_torch.models.proposal.maskrcnn import paste_masks

    B, T, H, W = frames.shape[:4]
    N = det.max_detections
    pm, pv = [], []
    with torch.no_grad():
        for img in frames.reshape(B * T, H, W, -1):
            out = det(img.permute(2, 0, 1)[None].float())
            full = paste_masks(out["masks"], out["boxes"], out["valid"], (H, W))
            order = torch.argsort(-torch.where(
                out["valid"], out["scores"],
                torch.full_like(out["scores"], -float("inf"))), stable=True)
            pm.append((full[order] > 0.5).float())
            pv.append(out["valid"][order])
    return (torch.stack(pm).reshape(B, T, N, H, W),
            torch.stack(pv).reshape(B, T, N))


if __name__ == "__main__":
    main()
