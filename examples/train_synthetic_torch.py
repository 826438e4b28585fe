#!/usr/bin/env python3
"""End-to-end training demo of the PyTorch/CUDA port on synthetic clips (no
dataset required): the counterpart of examples/train_synthetic.py, with its
configuration (R-18 float32 at 64x64, M=4, N=8, B=2 clips of T=3).

Usage: python examples/train_synthetic_torch.py [--steps N] [--device cpu]

Exercises the whole training path: synthetic data -> the clip-BPTT train
step (backbone, matcher, decoder over the frame loop) -> the loss curve.
Runs on CUDA unless --device says otherwise; --set
matching.use_pallas=true puts B1 (and its backward B1') in the step.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--set", nargs="*", default=[],
                    help="dotted config overrides, e.g. matching.use_pallas=true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dmm_net_tpu_torch.config import (Config, DataConfig, MatchingConfig,
                                          ModelConfig, TrainConfig)
    from dmm_net_tpu_torch.data.synthetic import synthetic_clip_batch
    from dmm_net_tpu_torch.train.loop import (batch_to, create_train_state,
                                              make_train_step)
    from dmm_net_tpu_torch.utils.cli import parse_overrides

    cfg = Config(
        name="train_synthetic",
        model=ModelConfig(backbone="resnet18", backbone_dtype="float32",
                          feature_dim=32, decoder_dim=16,
                          image_size=(args.size, args.size)),
        matching=MatchingConfig(max_templates=4, max_proposals=8,
                                sinkhorn_iters=10),
        data=DataConfig(dataset="synthetic", batch_size=2, clip_length=3),
        train=TrainConfig(lr=1e-3, warmup_steps=5, total_steps=1000),
    ).override(**parse_overrides(args.set))
    state = create_train_state(cfg, seed=0, device=args.device)
    device = state.model.device
    print(f"device: {device}")
    batch = batch_to(synthetic_clip_batch(
        seed=0, batch=2, T=3, H=args.size, W=args.size, num_objects=2,
        num_proposals=cfg.matching.max_proposals,
        pad_objects=cfg.matching.max_templates), device)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"params: {n_params / 1e6:.2f} M")
    step = make_train_step(cfg)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        metrics = step(state, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        if i == 0:
            print(f"first step: {time.time() - t0:.1f}s")
            t0 = time.time()
        if (i + 1) % 5 == 0 or i == 0:
            print(f"step {i + 1}: loss={losses[-1]:.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f}")
    dt = (time.time() - t0) / max(args.steps - 1, 1)
    print(f"steady-state step time: {dt * 1e3:.1f} ms")
    return {"losses": losses, "step_ms": dt * 1e3}


if __name__ == "__main__":
    main()
