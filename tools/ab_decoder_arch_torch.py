#!/usr/bin/env python3
"""Paired quality A/B over per-object decoder architectures: the
counterpart of tools/ab_decoder_arch.py.

Trains K decoder variants (obj_fuse mode x fine-level width taper, and the
later levers below) in ONE process over the SAME synthetic batches, seed
and LR schedule, then scores each on the same held-out sequences: the
paired protocol, so that differences between variants are not differences
between data. Training runs the port's train step (B1 forward, B1' its
backward, when matching.use_pallas is set); scoring runs its engine.

Usage:
  python tools/ab_decoder_arch_torch.py                 # every variant
  python tools/ab_decoder_arch_torch.py --variants base conv1 none taper \
      --steps 2000 --size 128 --backbone resnet34 [--device cpu | --cpu]
Prints the variants' table, then one JSON line last:
{"ab_decoder_arch": {variant: {"jf", "per_seq", "loss", "steps_per_s",
"compile_s", "knobs"}}} (compile_s: the first step's seconds).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> (decoder_obj_fuse, decoder_obj_dim_fine relative mode)
# taper values are halves of --obj-dim, resolved at runtime.
VARIANTS = {
    "base": {"decoder_obj_fuse": "conv3", "decoder_obj_dim_fine": 0},
    "conv1": {"decoder_obj_fuse": "conv1", "decoder_obj_dim_fine": 0},
    "none": {"decoder_obj_fuse": "none", "decoder_obj_dim_fine": 0},
    "taper": {"decoder_obj_fuse": "conv3", "decoder_obj_dim_fine": "half"},
    "none+taper": {"decoder_obj_fuse": "none", "decoder_obj_dim_fine": "half"},
    # levers on top of taper: a 1x1 fuse at every level, and the SHARED
    # FPN path tapered at the finest level (its merge/fuse 3x3 convs are
    # the decoder's largest FLOP block)
    "conv1+taper": {"decoder_obj_fuse": "conv1",
                    "decoder_obj_dim_fine": "half"},
    # lane-utilization levers stacked on conv1+taper:
    "mergek1": {"decoder_obj_fuse": "conv1", "decoder_obj_dim_fine": "half",
                "decoder_obj_merge_fine_k": 1},
    "objc3": {"decoder_obj_fuse": "conv1", "decoder_obj_dim_fine": "half",
              "decoder_obj_fine_level": "c3"},
    "objc3+k1": {"decoder_obj_fuse": "conv1", "decoder_obj_dim_fine": "half",
                 "decoder_obj_fine_level": "c3",
                 "decoder_obj_merge_fine_k": 1},
    # shared stride-4 taper stacked on objc3
    "objc3+shared_half": {"decoder_obj_fuse": "conv1",
                          "decoder_obj_dim_fine": "half",
                          "decoder_obj_fine_level": "c3",
                          "decoder_dim_fine": "half_f"},
    # a wider dynamic-mix basis
    "objc3+detail32": {"decoder_obj_fuse": "conv1",
                       "decoder_obj_dim_fine": "half",
                       "decoder_obj_fine_level": "c3",
                       "decoder_detail_dim": 32},
    # a pointwise basis conv
    "objc3+basisk1": {"decoder_obj_fuse": "conv1",
                      "decoder_obj_dim_fine": "half",
                      "decoder_obj_fine_level": "c3",
                      "decoder_detail_basis_k": 1},
    "taper+shared_half": {"decoder_obj_fuse": "conv3",
                          "decoder_obj_dim_fine": "half",
                          "decoder_dim_fine": "half_f"},
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--backbone", default="resnet34")
    ap.add_argument("--obj-dim", type=int, default=32)
    ap.add_argument("--seqs", type=int, default=8)
    ap.add_argument("--eval-frames", type=int, default=6)
    ap.add_argument("--objects", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distinct-batches", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        # before training anything: a typo in a later variant must not
        # waste the earlier variants' runs
        ap.error(f"unknown variants {unknown}; have {sorted(VARIANTS)}")
    device = "cpu" if args.cpu else args.device

    import dataclasses

    import numpy as np
    import torch

    from dmm_net_tpu_torch.config import (Config, DataConfig, MatchingConfig,
                                          ModelConfig, TrainConfig)
    from dmm_net_tpu_torch.data.synthetic import (synthetic_clip_batch,
                                                  synthetic_sequence)
    from dmm_net_tpu_torch.eval.davis_jf import evaluate_sequence
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.train.loop import (batch_to, create_train_state,
                                              make_train_step)

    S = args.size
    base_cfg = Config(
        name="ab_decoder_arch",
        model=ModelConfig(backbone=args.backbone, backbone_dtype="float32",
                          feature_dim=32, decoder_dim=32,
                          decoder_variant="shared",
                          decoder_obj_dim=args.obj_dim,
                          image_size=(S, S), template_update="aggregation"),
        matching=MatchingConfig(max_templates=4, max_proposals=8,
                                sinkhorn_iters=15, epsilon=0.03),
        data=DataConfig(dataset="synthetic", batch_size=4, clip_length=3),
        train=TrainConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps,
                          loss_iou_weight=0.5),
    )
    print(f"device: {device}  backbone={args.backbone} size={S} "
          f"steps={args.steps} obj_dim={args.obj_dim}")

    batches = [batch_to(synthetic_clip_batch(
        seed=s, batch=base_cfg.data.batch_size, T=base_cfg.data.clip_length,
        H=S, W=S, num_objects=args.objects,
        num_proposals=base_cfg.matching.max_proposals,
        pad_objects=base_cfg.matching.max_templates), device)
        for s in range(args.distinct_batches)]
    eval_seqs = [synthetic_sequence(seed=990 + s, T=args.eval_frames, H=S, W=S,
                                    num_objects=args.objects,
                                    num_proposals=base_cfg.matching.max_proposals)
                 for s in range(args.seqs)]

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def run(name):
        kn = dict(VARIANTS[name])
        if kn["decoder_obj_dim_fine"] == "half":
            kn["decoder_obj_dim_fine"] = max(args.obj_dim // 2, 4)
        if kn.get("decoder_dim_fine") == "half_f":
            kn["decoder_dim_fine"] = max(base_cfg.model.decoder_dim // 2, 8)
        cfg = dataclasses.replace(
            base_cfg, model=dataclasses.replace(base_cfg.model, **kn))
        state = create_train_state(cfg, seed=args.seed, device=device)
        step = make_train_step(cfg)
        t0, tc, metrics = time.time(), None, None
        for i in range(args.steps):
            metrics = step(state, batches[i % len(batches)])
            if i == 0:
                sync()
                tc = time.time() - t0
                t0 = time.time()
        loss = float(metrics["loss"])
        sps = (args.steps - 1) / max(time.time() - t0, 1e-9)

        eng = InferenceEngine(cfg, model=state.model.eval(),
                              update_templates=True, device=device)
        M = cfg.matching.max_templates
        jfs = []
        for seq in eval_seqs:
            def pad_m(x):
                return np.pad(x, [(0, M - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

            def stream():
                for t in range(args.eval_frames):
                    yield {"frame": seq["frames"][t][None],
                           "prop_masks": seq["prop_masks"][t][None],
                           "prop_valid": seq["prop_valid"][t][None]}

            labels = eng.run_sequence(stream(), pad_m(seq["tmpl_masks"])[None],
                                      pad_m(seq["tmpl_valid"])[None],
                                      seq["frames"][0][None])["labels"][:, 0]
            gt = np.zeros_like(labels)
            for i in range(args.objects):
                gt[seq["gt_masks"][:, i] > 0.5] = i + 1
            jfs.append(float(evaluate_sequence(gt, labels)["J&F"]))
        return {"jf": float(np.mean(jfs)), "per_seq": jfs, "loss": loss,
                "steps_per_s": sps, "compile_s": tc, "knobs": kn}

    results = {}
    for name in args.variants:
        print(f"\n=== {name} ===", flush=True)
        results[name] = r = run(name)
        print(f"{name}: J&F={r['jf']:.4f} loss={r['loss']:.4f} "
              f"steps/s={r['steps_per_s']:.1f} first step={r['compile_s']:.1f}s "
              f"per-seq {[round(x, 3) for x in r['per_seq']]}", flush=True)

    print("\n| variant | obj_fuse | g_fine | held-out J&F | steps/s |")
    print("|---|---|---|---|---|")
    for name, r in results.items():
        print(f"| {name} | {r['knobs']['decoder_obj_fuse']} | "
              f"{r['knobs']['decoder_obj_dim_fine'] or args.obj_dim} | "
              f"{r['jf']:.4f} | {r['steps_per_s']:.1f} |")
    print(json.dumps({"ab_decoder_arch": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
