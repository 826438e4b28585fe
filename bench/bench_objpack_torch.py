#!/usr/bin/env python3
"""Per-object conv layouts at the p3 decoder's shapes, on cuDNN: the
counterpart of bench/bench_objpack.py (three of its layouts).

The SharedFPNDecoder's per-object path convs run at g = 16-32 channels
with weights shared across the M object slots, so the same math admits
several layouts:

  obj_batch   (B*M, g, h, w)   conv g -> g            (the shipped layout)
  grouped     (B, M*g, h, w)   groups=M               (objects as groups)
  dense_ref   (B, M*g, h, w)   dense M*g -> M*g       (a ruler: M x the
                               FLOPs at full width; not a candidate)

bf16 operands; ms per conv with CUDA events after a warm-up; the grouped
layout is checked against obj_batch once (bf16 tolerance 0.15).

Usage: python bench/bench_objpack_torch.py [--image-size 256 448]
           [--objects 16] [--device cuda]   (BENCH_BATCH, default 8;
                                             BENCH_REPS, default 50)
Prints one JSON line per (level, g, layout) and returns them.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image-size", type=int, nargs=2, default=[256, 448])
    ap.add_argument("--objects", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    from bench_torch import ms_per_call
    from dmm_net_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    B, M = int(os.environ.get("BENCH_BATCH", "8")), args.objects
    reps = int(os.environ.get("BENCH_REPS", "50"))
    H, W = args.image_size
    rng = np.random.RandomState(0)

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)

    rows = []
    with torch.inference_mode():
        for stride in (4, 8, 32):
            h, w = H // stride, W // stride
            for g in (16, 32):
                flops = 2 * B * M * h * w * 9 * g * g      # the real math
                x_bm = rng.randn(B * M, g, h, w).astype(np.float32)
                k_g = (rng.randn(g, g, 3, 3) * 0.1).astype(np.float32)
                x_pk = x_bm.reshape(B, M * g, h, w)         # objects as groups
                k_pk = np.tile(k_g, (M, 1, 1, 1))            # (M*g, g, 3, 3)
                k_fat = (rng.randn(M * g, M * g, 3, 3) * 0.01).astype(np.float32)
                xb, kb = bf16(x_bm), bf16(k_g)
                xp, kp, kf = bf16(x_pk), bf16(k_pk), bf16(k_fat)

                ref = F.conv2d(xb, kb, padding=1).float()
                got = F.conv2d(xp, kp, padding=1, groups=M).float()
                err = float((got.reshape(ref.shape) - ref).abs().max())
                if not err < 0.15:
                    raise RuntimeError(f"grouped layout off obj_batch by {err} "
                                       f"(stride {stride}, g {g})")
                for name, fn, fl in (
                        ("obj_batch", lambda: F.conv2d(xb, kb, padding=1), flops),
                        ("grouped", lambda: F.conv2d(xp, kp, padding=1, groups=M),
                         flops),
                        ("dense_ref", lambda: F.conv2d(xp, kf, padding=1),
                         flops * M)):
                    ms = ms_per_call(fn, reps, dev)
                    row = {"level": f"stride{stride}", "g": g, "layout": name,
                           "ms": ms, "eff_tflops": fl / (ms / 1e3) / 1e12}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
