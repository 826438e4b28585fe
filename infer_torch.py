#!/usr/bin/env python3
"""Inference + evaluation CLI of the PyTorch/CUDA port (dmm_net_tpu_torch):
the counterpart of infer.py.

Usage:
  python infer_torch.py --ckpt artifacts/dmm128_fallback.msgpack \
                        --davis-root /data/DAVIS [--out results/x]
  python infer_torch.py --preset p4_ytvos_stream --dataset ytvos \
                        --ytvos-root /data/YouTubeVOS --proposal-dir /data/props \
                        [--out results/p4]
  python infer_torch.py ... --device cpu
  python infer_torch.py ... --data-parallel

A checkpoint carries its own model config, which becomes the base config;
--set overrides apply on top. --ckpt takes a msgpack blob {"config",
"variables"} (the JAX package's format), a torch checkpoint written by the
port's trainer (train_torch.py: <logdir>/ckpt/step_<n>.pt), or that
checkpoint directory (its latest step). Without --ckpt the weights are random (seed 0).
The default dispatch runs K frames per chunk (--chunk); --per-frame runs
one frame step at a time and is forced for matching.decode=hungarian. Every
stream is staged ahead of the engine by data/pipeline.RingStager (decode on
a producer thread, the next frames already on the device).

DAVIS: palette PNGs per sequence and results.json with J, F and J&F per
sequence and overall, scored at the annotation's native resolution
(--score-at-model-res scores against annotations resized to the model's).
YouTube-VOS: the server's submission tree, Annotations/<vid>/<stem>.png at
the video's original size for every frame meta.json lists; objects that
appear mid-video are live from their first annotated frame. Runs on CUDA
unless --device says otherwise.

--data-parallel runs the sequences in groups of one per rank, a rank per
visible card (as infer.py takes every JAX device; on the CPU the ranks of
an initialised group), the last group padded with duplicates: each rank
runs its sequence through the chunked engine and the labels are gathered
(infer/engine.py). Rank 0 alone scores and writes. Under torchrun's
environment the script joins torchrun's group; otherwise it starts its
ranks itself. --per-frame and --data-parallel are exclusive, as in
infer.py.
"""

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PER_FRAME_LIVE_FROM = ("--per-frame does not support mid-video objects "
                       "(live_from > 0 in this sequence group); use the "
                       "default chunked dispatch")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="p3_multi_object")
    ap.add_argument("--set", nargs="*", default=[],
                    help="dot-path overrides, e.g. model.backbone=resnet18")
    ap.add_argument("--dataset", choices=["davis", "ytvos"], default="davis")
    ap.add_argument("--davis-root", default="/root/data/DAVIS")
    ap.add_argument("--ytvos-root", default="data/YouTubeVOS")
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames per chunk (chunked dispatch)")
    ap.add_argument("--per-frame", action="store_true",
                    help="one frame step per call (needed for hungarian decode)")
    ap.add_argument("--data-parallel", action="store_true",
                    help="one sequence per rank, a rank per visible card")
    ap.add_argument("--split", default=None)
    ap.add_argument("--proposal-dir", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="flax msgpack blob, or a train_torch.py checkpoint "
                    "(file or directory)")
    ap.add_argument("--out", default="results/default")
    ap.add_argument("--sequences", nargs="*", default=None)
    ap.add_argument("--no-eval", action="store_true")
    ap.add_argument("--score-at-model-res", action="store_true",
                    help="score against GT resized to the model resolution "
                    "instead of the protocol's native resolution")
    ap.add_argument("--no-template-update", action="store_true",
                    help="keep frame-1 template masks for the cost IoU term")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.data.pipeline import RingStager
    from dmm_net_tpu_torch.eval.davis_jf import evaluate_sequence, upsample_labels
    from dmm_net_tpu_torch.infer.batching import batch_sequence_streams
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.models.dmm import DMMNet
    from dmm_net_tpu_torch.parallel import launch, make_mesh, visible_ranks
    from dmm_net_tpu_torch.utils.checkpoint import load_checkpoint
    from dmm_net_tpu_torch.utils.cli import parse_overrides

    logging.basicConfig(format="%(asctime)s infer_torch %(levelname)s: "
                        "%(message)s", level=logging.INFO)
    log = logging.getLogger("infer_torch")

    loaded = {}
    cfg = preset(args.preset)
    if args.ckpt:
        try:
            ckpt_cfg, loaded = load_checkpoint(args.ckpt)
        except ValueError as e:
            raise SystemExit(str(e))
        cfg = ckpt_cfg or cfg
        log.info("loaded %s%s from %s", next(iter(loaded)),
                 "" if ckpt_cfg is None else " + config", args.ckpt)
    cfg = cfg.override(**parse_overrides(getattr(args, "set")))
    if cfg.matching.decode == "hungarian" and not args.per_frame:
        log.info("hungarian decode requires per-frame dispatch; forcing "
                 "--per-frame")
        args.per_frame = True
    if args.per_frame and args.data_parallel:
        raise SystemExit("--per-frame and --data-parallel are exclusive "
                         "(the sharded path is the chunked one)")
    mesh, group_size = None, 1
    if args.data_parallel:
        if not dist.is_initialized():
            return launch(main, visible_ranks(args.device),
                          torch.device(args.device).type, argv)[0]
        mesh = make_mesh(device_type=torch.device(args.device).type)
        group_size = mesh.world
        log.info("data-parallel inference over %d rank(s), rank %d",
                 group_size, mesh.rank)
    lead = mesh is None or mesh.rank == 0

    kw = dict(image_size=cfg.model.image_size, proposal_dir=args.proposal_dir,
              max_objects=cfg.matching.max_templates,
              max_proposals=cfg.matching.max_proposals)
    if args.dataset == "davis":
        from dmm_net_tpu_torch.data.davis import DavisDataset
        ds = DavisDataset(args.davis_root, split=args.split or "val", **kw)
        seqs = args.sequences or ds.sequences
        if not seqs:
            raise SystemExit(f"no sequences found under {args.davis_root}")
    else:
        from dmm_net_tpu_torch.data.ytvos import YTVOSDataset
        ds = YTVOSDataset(args.ytvos_root, split=args.split or "valid", **kw)
        seqs = args.sequences or ds.videos
        if not seqs:
            raise SystemExit(f"no videos found under {args.ytvos_root}")
    device = args.device if mesh is None else mesh.device
    model = None
    if "state_dict" in loaded:
        model = DMMNet(cfg, device=device)
        model.load_state_dict(loaded["state_dict"])
    engine = InferenceEngine(cfg, model=model,
                             variables=loaded.get("variables"),
                             update_templates=not args.no_template_update,
                             mesh=mesh, device=device)

    def eval_davis(name, labels, sd0):
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

    def write_ytvos(name, labels, sd0):
        from dmm_net_tpu_torch.data.ytvos import write_submission
        # the server wants a PNG for every frame meta.json lists (the valid
        # split's Annotations/ holds only each object's first frame)
        meta_objs = ds.meta.get(name, {}).get("objects", {})
        meta_stems = sorted({s for od in meta_objs.values()
                             for s in od.get("frames", [])})
        stems = meta_stems or sd0["annotated_stems"] or sd0["frame_stems"]
        pick = [sd0["frame_stems"].index(s) for s in stems
                if s in sd0["frame_stems"]]
        full_size = None        # the server expects original-size PNGs
        ann_dir = os.path.join(args.ytvos_root, args.split or "valid",
                               "Annotations", name)
        if os.path.isdir(ann_dir):
            first = sorted(os.listdir(ann_dir))
            if first:
                from PIL import Image
                with Image.open(os.path.join(ann_dir, first[0])) as im:
                    full_size = (im.height, im.width)
        write_submission(args.out, name, [sd0["frame_stems"][i] for i in pick],
                         labels[pick], sd0["object_ids"], full_size=full_size)
        log.info("%s: %d frames -> submission", name, labels.shape[0])

    results = {}
    total_frames = 0
    infer_seconds = 0.0
    for g in range(0, len(seqs), group_size):
        names = list(seqs[g:g + group_size])
        names += names[-1:] * (group_size - len(names))  # pad the last group
        # one stream per lane: a duplicate must not share its generator
        sds = [ds.sequence_stream(name) for name in names]
        sd = batch_sequence_streams(sds)
        lf = sd.get("live_from")
        if args.per_frame and lf is not None and np.any(np.asarray(lf) > 0):
            # run_sequence has no live_from gating: a mid-video object would
            # be matched from frame 0 with frame-0 template features
            raise SystemExit(PER_FRAME_LIVE_FROM)
        stream = RingStager(sd["frames"], depth=2, device=engine.device)
        t0 = time.time()
        if args.per_frame:
            res = engine.run_sequence(iter(stream), sd["tmpl_masks"],
                                      sd["tmpl_valid"], sd["first_frame"])
        else:
            res = engine.run_stream_chunked(
                iter(stream), sd["tmpl_masks"], sd["tmpl_valid"],
                sd["first_frame"], chunk=args.chunk, live_from=lf,
                tmpl_frames=sd.get("tmpl_frames"))
        infer_seconds += time.time() - t0
        done = set()
        for b, name in enumerate(names):
            if name in done or not lead:     # a padding duplicate, or rank > 0
                continue
            done.add(name)
            labels = res["labels"][:sd["lengths"][b], b]
            total_frames += labels.shape[0]
            if args.dataset == "ytvos":
                write_ytvos(name, labels, sds[b])
                continue
            for t in range(labels.shape[0]):
                engine.write_png(labels[t], os.path.join(args.out, name,
                                                         f"{t:05d}.png"))
            if not args.no_eval:
                eval_davis(name, labels, sds[b])
    if not lead:
        return None

    def mean(key):
        return (float(np.mean([r[key] for r in results.values()]))
                if results else None)

    summary = {
        "sequences": results, "J": mean("J"), "F": mean("F"),
        "J&F": mean("J&F"),
        # inference only (engine and staging; no scoring or PNG writing)
        "fps": total_frames / max(infer_seconds, 1e-9),
        "frames": total_frames,
        "dispatch": "per_frame" if args.per_frame else "chunked_scan",
        "chunk": None if args.per_frame else args.chunk,
        "data_parallel": group_size if args.data_parallel else None,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log.info("overall: %s", {k: v for k, v in summary.items()
                             if k != "sequences"})
    return summary


if __name__ == "__main__":
    main()
