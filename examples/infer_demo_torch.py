#!/usr/bin/env python3
"""Whole-pipeline inference demo of the PyTorch/CUDA port: a synthetic
moving-shape video -> per-frame streamed inference -> DAVIS J&F and palette
PNG masks. The counterpart of examples/infer_demo.py, with its
configuration (R-18 float32 at 64x64, M=4, N=8, epsilon 0.02, 20 Sinkhorn
iterations, template_update="aggregation").

Usage: python examples/infer_demo_torch.py [--out results/infer_demo] [--device cpu]

The model is untrained (seeded random weights): the demo checks the
plumbing. It reports the J&F of the matcher-aggregated masks (the matcher's
quality: ~1, since the synthetic proposals hold near-perfect candidates),
the J&F of the planted assignment (the proposals' ceiling) and the
decoder's (untrained, low), and fails when the matcher falls 0.03 below
the ceiling. Runs on CUDA unless --device says otherwise; --set
matching.use_pallas=true runs the matcher on B1.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/infer_demo")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--set", nargs="*", default=[],
                    help="dotted config overrides, e.g. matching.use_pallas=true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from dmm_net_tpu_torch.config import Config, MatchingConfig, ModelConfig
    from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
    from dmm_net_tpu_torch.eval.davis_jf import evaluate_sequence
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.utils.cli import parse_overrides

    cfg = Config(
        name="infer_demo",
        model=ModelConfig(backbone="resnet18", backbone_dtype="float32",
                          feature_dim=32, decoder_dim=16,
                          image_size=(args.size, args.size),
                          template_update="aggregation"),
        matching=MatchingConfig(max_templates=4, max_proposals=8,
                                sinkhorn_iters=20, epsilon=0.02),
    ).override(**parse_overrides(args.set))
    T, H, W = args.frames, args.size, args.size
    seq = synthetic_sequence(seed=3, T=T, H=H, W=W, num_objects=2,
                             num_proposals=8)
    M = cfg.matching.max_templates

    def pad_m(x, axis=0):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, M - x.shape[axis])
        return np.pad(x, pad)

    tmpl_masks = pad_m(seq["tmpl_masks"])[None]
    tmpl_valid = pad_m(seq["tmpl_valid"])[None]
    # template_update="aggregation": the templates follow the objects by the
    # matcher's own aggregated masks (the untrained decoder's cannot be fed
    # back yet)
    engine = InferenceEngine(cfg, update_templates=True, device=args.device,
                             seed=0)
    print(f"device: {engine.device}")

    def stream():
        for t in range(T):
            yield {"frame": seq["frames"][t][None],
                   "prop_masks": seq["prop_masks"][t][None],
                   "prop_valid": seq["prop_valid"][t][None]}

    res = engine.run_sequence(stream(), tmpl_masks, tmpl_valid,
                              seq["frames"][0][None])
    labels = res["labels"][:, 0]                       # (T, H, W)

    # the matcher's quality: the planted proposals aggregated with its X
    X = res["assignments"][:, 0]                       # (T, M, N)
    agg = np.einsum("tmn,tnhw->tmhw", X, seq["prop_masks"])
    agg_labels = np.zeros((T, H, W), np.int32)
    for t in range(T):
        scores = np.concatenate([np.full((1, H, W), 0.5), agg[t, :2]], 0)
        agg_labels[t] = np.argmax(scores, 0)
    gt_labels = np.zeros_like(agg_labels)
    for i in range(2):
        gt_labels[seq["gt_masks"][:, i] > 0.5] = i + 1
    # the ceiling set by the proposals' jitter: the planted assignment
    oracle_labels = np.zeros_like(agg_labels)
    for t in range(T):
        picks = seq["prop_masks"][t][seq["gt_assignment"][t]]
        scores = np.concatenate([np.full((1, H, W), 0.5), picks], 0)
        oracle_labels[t] = np.argmax(scores, 0)

    r_agg = evaluate_sequence(gt_labels, agg_labels)
    r_orc = evaluate_sequence(gt_labels, oracle_labels)
    r_dec = evaluate_sequence(gt_labels, labels)
    print(f"matcher-aggregated J&F = {r_agg['J&F']:.3f} "
          f"(J={r_agg['J']:.3f} F={r_agg['F']:.3f})")
    print(f"oracle-assignment  J&F = {r_orc['J&F']:.3f}  <- proposal ceiling")
    print(f"decoder (untrained) J&F = {r_dec['J&F']:.3f}")

    os.makedirs(args.out, exist_ok=True)
    for t in range(T):
        engine.write_png(labels[t], os.path.join(args.out, f"{t:05d}.png"))
    print(f"wrote {T} palette PNGs to {args.out}")
    if r_agg["J&F"] <= r_orc["J&F"] - 0.03:
        raise SystemExit("matcher pipeline degraded: aggregated J&F "
                         f"{r_agg['J&F']:.3f} vs ceiling {r_orc['J&F']:.3f}")
    return {"aggregated": r_agg, "oracle": r_orc, "decoder": r_dec}


if __name__ == "__main__":
    main()
