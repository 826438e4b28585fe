#!/usr/bin/env python3
"""Inference + evaluation CLI of the PyTorch/CUDA port (dmm_net_tpu_torch):
the counterpart of infer.py for DAVIS.

Usage:
  python infer_torch.py --ckpt artifacts/dmm128_fallback.msgpack \
                        --davis-root /data/DAVIS [--out results/x]
  python infer_torch.py --preset p3_multi_object --davis-root ... --device cpu

A msgpack checkpoint {"config", "variables"} (the JAX package's format)
carries its own model config, which becomes the base config; --set
overrides apply on top. Without --ckpt the weights are random (seed 0).
The default dispatch runs K frames per chunk (--chunk); --per-frame runs
one frame step at a time and is forced for matching.decode=hungarian.

Writes palette PNGs per sequence and results.json with J, F and J&F per
sequence and overall, scored at the annotation's native resolution
(--score-at-model-res scores against annotations resized to the model's).
Runs on CUDA unless --device says otherwise. Not ported: --dataset ytvos,
--data-parallel (ROADMAP.md §A); the frame stream is iterated directly.
"""

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to the PyTorch package yet "
                      "(see ROADMAP.md §A)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="p3_multi_object")
    ap.add_argument("--set", nargs="*", default=[],
                    help="dot-path overrides, e.g. model.backbone=resnet18")
    ap.add_argument("--dataset", choices=["davis", "ytvos"], default="davis")
    ap.add_argument("--davis-root", default="/root/data/DAVIS")
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames per chunk (chunked dispatch)")
    ap.add_argument("--per-frame", action="store_true",
                    help="one frame step per call (needed for hungarian decode)")
    ap.add_argument("--data-parallel", action="store_true")
    ap.add_argument("--split", default=None)
    ap.add_argument("--proposal-dir", default=None)
    ap.add_argument("--ckpt", default=None, help="flax msgpack checkpoint blob")
    ap.add_argument("--out", default="results/default")
    ap.add_argument("--sequences", nargs="*", default=None)
    ap.add_argument("--no-eval", action="store_true")
    ap.add_argument("--score-at-model-res", action="store_true",
                    help="score against GT resized to the model resolution "
                    "instead of the protocol's native resolution")
    ap.add_argument("--no-template-update", action="store_true",
                    help="keep frame-1 template masks for the cost IoU term")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.dataset == "ytvos":
        raise _not_ported("--dataset ytvos (the YouTube-VOS reader and "
                          "submission writer)")
    if args.data_parallel:
        raise _not_ported("--data-parallel (the multi-device mesh)")

    import numpy as np

    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.data.davis import DavisDataset
    from dmm_net_tpu_torch.eval.davis_jf import evaluate_sequence, upsample_labels
    from dmm_net_tpu_torch.infer.batching import batch_sequence_streams
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt
    from dmm_net_tpu_torch.utils.cli import parse_overrides

    logging.basicConfig(format="%(asctime)s infer_torch %(levelname)s: "
                        "%(message)s", level=logging.INFO)
    log = logging.getLogger("infer_torch")

    variables = None
    cfg = preset(args.preset)
    if args.ckpt:
        try:
            ckpt_cfg, variables = load_msgpack_ckpt(args.ckpt)
        except ValueError as e:
            raise SystemExit(str(e))
        cfg = ckpt_cfg or cfg
        log.info("loaded variables%s from %s",
                 "" if ckpt_cfg is None else " + config", args.ckpt)
    cfg = cfg.override(**parse_overrides(getattr(args, "set")))
    if cfg.matching.decode == "hungarian" and not args.per_frame:
        log.info("hungarian decode requires per-frame dispatch; forcing "
                 "--per-frame")
        args.per_frame = True

    ds = DavisDataset(args.davis_root, split=args.split or "val",
                      image_size=cfg.model.image_size,
                      proposal_dir=args.proposal_dir,
                      max_objects=cfg.matching.max_templates,
                      max_proposals=cfg.matching.max_proposals)
    seqs = args.sequences or ds.sequences
    if not seqs:
        raise SystemExit(f"no sequences found under {args.davis_root}")
    engine = InferenceEngine(cfg, variables=variables,
                             update_templates=not args.no_template_update,
                             device=args.device)

    results = {}
    total_frames = 0
    infer_seconds = 0.0
    for name in seqs:
        sd0 = ds.sequence_stream(name)
        sd = batch_sequence_streams([sd0])
        t0 = time.time()
        if args.per_frame:
            res = engine.run_sequence(sd["frames"], sd["tmpl_masks"],
                                      sd["tmpl_valid"], sd["first_frame"])
        else:
            res = engine.run_stream_chunked(sd["frames"], sd["tmpl_masks"],
                                            sd["tmpl_valid"], sd["first_frame"],
                                            chunk=args.chunk)
        infer_seconds += time.time() - t0
        labels = res["labels"][:sd["lengths"][0], 0]
        total_frames += labels.shape[0]
        for t in range(labels.shape[0]):
            engine.write_png(labels[t], os.path.join(args.out, name,
                                                     f"{t:05d}.png"))
        if args.no_eval:
            continue
        if args.score_at_model_res:
            gt = np.stack([ds.load_annotation(p) for p in sd0["annotations"]])
            pred = labels[:gt.shape[0]]
        else:
            gt = np.stack([ds.load_annotation_native(p)
                           for p in sd0["annotations"]])
            pred = upsample_labels(labels[:gt.shape[0]], gt.shape[1:3])
        object_ids = sd0["object_ids"]
        remap = np.zeros(256, np.int32)          # GT ids -> template slots 1..K
        for i, oid in enumerate(object_ids):
            remap[oid] = i + 1
        r = evaluate_sequence(remap[gt], pred,
                              object_ids=list(range(1, len(object_ids) + 1)))
        results[name] = {k: r[k] for k in ("J", "F", "J&F", "J_recall",
                                           "J_decay", "F_recall", "F_decay")}
        log.info("%s: J&F=%.3f", name, r["J&F"])

    def mean(key):
        return (float(np.mean([r[key] for r in results.values()]))
                if results else None)

    summary = {
        "sequences": results, "J": mean("J"), "F": mean("F"),
        "J&F": mean("J&F"),
        # inference only (engine; no scoring or PNG writing)
        "fps": total_frames / max(infer_seconds, 1e-9),
        "frames": total_frames,
        "dispatch": "per_frame" if args.per_frame else "chunked_scan",
        "chunk": None if args.per_frame else args.chunk,
        "data_parallel": None,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log.info("overall: %s", {k: v for k, v in summary.items()
                             if k != "sequences"})


if __name__ == "__main__":
    main()
