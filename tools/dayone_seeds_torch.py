#!/usr/bin/env python3
"""The day-one drill over several held-out videos, with the detector's
proposals and with planted ones.

The drill (tests/test_torch_port_dayone.py) gates on one video (seed 7001).
This tool runs its commands on one native 854x480 tree per seed
(data/synthetic.write_native_davis_tree, T frames): the cache tool with the
detector, then infer_torch.py with the DMM, scored at native resolution;
the same at model resolution (--score-at-model-res), with planted
proposals (no cache: proposals synthesised from the ground truth), and on
the kernels (matching.use_pallas, stride-4 masks, logits_res=mask). It
tells a hard video from a weak detector or DMM.

Each seed's row also scores the detector's cache itself ("proposals"):
per frame, each annotated object's best mask IoU over the frame's cached
proposals, both at the cache's 256x448 (the annotation NEAREST-resized, as
the reader resizes it); recall at IoU 0.5 and 0.7 is the mean over frames
of the share of the frame's objects whose best IoU reaches it (the full
system's recall, examples/full_system_synthetic_torch.py), and
``best_iou`` the mean best IoU of each object over its frames.

``--mrcnn none`` runs the planted arm alone, with no detector: it scores a
DMM file of any geometry (infer_torch.py reads it from the file's config),
such as a fallback checkpoint.

Usage: python tools/dayone_seeds_torch.py [--seeds 7001 ... 7008]
           [--frames 4] [--dmm runs/torch/dmm448/dmm.msgpack]
           [--mrcnn runs/torch/proposal_video448/mrcnn.msgpack | none]
           [--device cpu]
Prints one JSON line per seed, then one JSON line of each arm's mean and
minimum J&F (and of the proposals' recall and best IoU).
"""
import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

KERNELS = ["matching.use_pallas=true", "model.mask_res=stride4",
           "model.logits_res=mask"]
CACHE_HW = (256, 448)
RECALL_IOUS = (0.5, 0.7)


def proposal_quality(root, cache, max_proposals=8):
    """The cache's proposals against the tree's annotations, at CACHE_HW:
    {"recall@0.5", "recall@0.7", "best_iou": [each object's mean best IoU
    over the frames where it is annotated], "best_iou_mean"}."""
    import numpy as np

    from dmm_net_tpu_torch.data.davis import DavisDataset

    ds = DavisDataset(root, image_size=CACHE_HW, proposal_dir=cache,
                      max_proposals=max_proposals)
    seq = ds.sequences[0]
    gts = [ds.load_annotation(p) for p in ds.annotation_paths(seq)]
    oids = sorted(int(x) for x in set(np.unique(gts[0])) - {0})
    best = np.full((len(gts), len(oids)), np.nan)
    for t, gt in enumerate(gts):
        masks, valid = ds.load_proposals(seq, t)
        props = masks[valid] > 0.5                           # (D, H, W)
        for j, oid in enumerate(oids):
            g = gt == oid
            if not g.any():
                continue
            inter = (props & g).sum((1, 2))
            union = props.sum((1, 2)) + g.sum() - inter
            best[t, j] = (inter / np.maximum(union, 1)).max(initial=0.0)
    out = {f"recall@{thr}": float(np.mean([
        np.mean(row[~np.isnan(row)] >= thr) for row in best
        if (~np.isnan(row)).any()])) for thr in RECALL_IOUS}
    per_object = [float(np.nanmean(best[:, j])) for j in range(len(oids))]
    out["best_iou"] = per_object
    out["best_iou_mean"] = float(np.mean(per_object))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=list(range(7001, 7009)))
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--dmm", default="runs/torch/dmm448/dmm.msgpack")
    ap.add_argument("--mrcnn", default="runs/torch/proposal_video448/mrcnn.msgpack",
                    help="the detector file, or 'none' for the planted arm "
                    "alone")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import importlib.util

    import infer_torch
    from dmm_net_tpu_torch.data.synthetic import write_native_davis_tree

    spec = importlib.util.spec_from_file_location(
        "extract_proposals_torch",
        os.path.join(_ROOT, "tools", "extract_proposals_torch.py"))
    extract = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(extract)

    detector = args.mrcnn != "none"
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for seed in args.seeds:
            root = write_native_davis_tree(str(tmp / f"D{seed}"), T=args.frames,
                                           seeds=(seed,))
            row = {"seed": seed}
            arms = {"planted": []}
            if detector:
                cache = str(tmp / f"P{seed}")
                extract.main(["--dataset", "davis", "--root", root, "--out", cache,
                              "--params", args.mrcnn, "--image-size",
                              *map(str, CACHE_HW), "--backbone", "resnet18",
                              "--num-classes", "4", "--max-detections", "8",
                              "--score-thresh", "0.05", "--device", args.device])
                arms = {"detector": ["--proposal-dir", cache],
                        "detector_model_res": ["--proposal-dir", cache,
                                               "--score-at-model-res"],
                        "planted": [],
                        "detector_kernels": ["--proposal-dir", cache,
                                             "--set", *KERNELS]}
                row["proposals"] = proposal_quality(root, cache)
            for arm, extra in arms.items():
                s = infer_torch.main(["--ckpt", args.dmm, "--davis-root", root,
                                      "--out", str(tmp / f"R{seed}_{arm}"),
                                      "--chunk", "4", "--device", args.device,
                                      *extra])
                row[arm] = {k: s[k] for k in ("J", "F", "J&F")}
            if detector:
                row["detections_per_frame"] = [
                    len(json.loads(p.read_text()))
                    for p in sorted(Path(cache).rglob("*.json"))]
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {arm: {"mean": sum(r[arm]["J&F"] for r in rows) / len(rows),
                     "min": min(r[arm]["J&F"] for r in rows)}
               for arm in arms}
    if detector:
        summary["proposals"] = {
            k: {"mean": sum(r["proposals"][k] for r in rows) / len(rows),
                "min": min(r["proposals"][k] for r in rows)}
            for k in (*(f"recall@{thr}" for thr in RECALL_IOUS), "best_iou_mean")}
    print(json.dumps({"dayone_seeds": summary}), flush=True)
    return rows, summary


if __name__ == "__main__":
    main()
