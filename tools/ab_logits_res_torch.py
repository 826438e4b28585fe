#!/usr/bin/env python3
"""Quality A/B of model.logits_res on trained weights: the counterpart of
tools/ab_logits_res.py.

Loads a {"config", "variables"} msgpack (the flagship
runs/torch/dmm448/dmm.msgpack by default), scores held-out synthetic
sequences at the checkpoint's geometry under logits_res="full" (the decoder
upsamples its logits) and "mask" (B2, the fused upsample and argmax of
kernels/resolve.py), with the rest of the fast path (bf16 masks and
decoder, stride-4 mask grid) held fixed. The evidence for
docs/DAYONE_torch.md §5: the fused resolve does not change quality.

Usage: python tools/ab_logits_res_torch.py [--ckpt PATH] [--seqs 6]
           [--frames 6] [--device cpu | --cpu]
Prints one JSON line last: {"ab_logits_res": {"full": {"jf", "per_seq"},
"mask": {...}}, "delta_per_seq": [mask - full], "device": ...}.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="runs/torch/dmm448/dmm.msgpack")
    ap.add_argument("--seqs", type=int, default=6)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    import numpy as np

    from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
    from dmm_net_tpu_torch.eval.davis_jf import evaluate_sequence
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt

    cfg0, variables = load_msgpack_ckpt(args.ckpt)
    H, W = cfg0.model.image_size
    print(f"ckpt={args.ckpt} image={H}x{W} backbone={cfg0.model.backbone}")

    def score(logits_res):
        cfg = cfg0.override(**{"model.mask_dtype": "bfloat16",
                               "model.decoder_dtype": "bfloat16",
                               "model.mask_res": "stride4",
                               "model.logits_res": logits_res})
        eng = InferenceEngine(cfg, variables=variables, update_templates=True,
                              device=device)
        M = cfg.matching.max_templates
        jfs = []
        for s in range(args.seqs):
            seq = synthetic_sequence(seed=990 + s, T=args.frames, H=H, W=W,
                                     num_objects=2,
                                     num_proposals=cfg.matching.max_proposals)

            def pad_m(x):
                return np.pad(x, [(0, M - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

            def stream():
                for t in range(args.frames):
                    yield {"frame": seq["frames"][t][None],
                           "prop_masks": seq["prop_masks"][t][None],
                           "prop_valid": seq["prop_valid"][t][None]}

            labels = eng.run_sequence(stream(), pad_m(seq["tmpl_masks"])[None],
                                      pad_m(seq["tmpl_valid"])[None],
                                      seq["frames"][0][None])["labels"][:, 0]
            gt = np.zeros_like(labels)
            for i in range(2):
                gt[seq["gt_masks"][:, i] > 0.5] = i + 1
            jfs.append(float(evaluate_sequence(gt, labels)["J&F"]))
        return jfs

    per = {lr: score(lr) for lr in ("full", "mask")}
    for lr, jfs in per.items():
        print(f"logits_res={lr:4s}  held-out J&F = {float(np.mean(jfs)):.4f}  "
              f"per-seq {[round(x, 4) for x in jfs]}  (device={device})")
    d = [m - f for f, m in zip(per["full"], per["mask"])]
    print(f"per-seq delta (mask - full): {[round(x, 4) for x in d]}")
    result = {"ab_logits_res": {lr: {"jf": float(np.mean(jfs)), "per_seq": jfs}
                                for lr, jfs in per.items()},
              "delta_per_seq": d, "device": device}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
