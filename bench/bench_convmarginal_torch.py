#!/usr/bin/env python3
"""Marginal cost of one conv at the decoder's shapes from chain-depth
deltas, on cuDNN: the counterpart of bench/bench_convmarginal.py.

A call runs a chain of DEPTH 3x3 bf16 convs; (t_deep - t_1) / (DEPTH - 1)
is the cost of one more conv with the per-call overhead (launch and
dispatch) differenced out. It asks whether the decoder's convs are
overhead-bound (marginals tiny next to a single conv's time) or slow per
conv, and what a conv at 128 channels costs against 16 or 32 at the same
pixels.

Usage: python bench/bench_convmarginal_torch.py [--batch 16] [--objects 16]
           [--image-size 256 448] [--device cuda]
           (BENCH_REPS calls per timing, default 30; BENCH_DEPTH, default 9)
Prints one JSON line per case and returns them.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--objects", type=int, default=16)
    ap.add_argument("--image-size", type=int, nargs=2, default=[256, 448])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    from bench_torch import ms_per_call
    from dmm_net_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    reps = int(os.environ.get("BENCH_REPS", "30"))
    depth = int(os.environ.get("BENCH_DEPTH", "9"))
    B, M = args.batch, args.objects
    H, W = args.image_size
    rng = np.random.RandomState(0)
    # decoder-shaped cases: (batch, channels, h, w)
    cases = [
        (B * M, 16, H // 4, W // 4),     # per-object stride 4, tapered
        (B * M, 32, H // 4, W // 4),     # per-object stride 4, untapered
        (B * M, 32, H // 32, W // 32),   # GRU grid (stride 32)
        (B, 128, H // 4, W // 4),        # shared path stride 4
        (B, 64, H // 32, W // 32),       # a GRU-at-B grid
    ]
    rows = []
    with torch.inference_mode():
        for shape in cases:
            g = shape[1]
            k = torch.from_numpy(rng.randn(g, g, 3, 3) * 0.1).to(dev, torch.bfloat16)
            x = torch.from_numpy(rng.randn(*shape)).to(dev, torch.bfloat16)

            def chain(d):
                def run():
                    out = x
                    for _ in range(d):
                        out = F.conv2d(out, k, padding=1)
                    return out
                return run
            t1 = ms_per_call(chain(1), reps, dev)
            td = ms_per_call(chain(depth), reps, dev)
            marg = (td - t1) / (depth - 1)
            fl = 2 * int(np.prod(shape)) * 9 * g
            row = {"shape_nchw": list(shape), "t1_ms": t1, "marginal_ms": marg,
                   "eff_tflops": fl / (max(marg, 1e-6) / 1e3) / 1e12,
                   "eff_gbps": 2 * int(np.prod(shape)) * 2
                   / (max(marg, 1e-6) / 1e3) / 1e9}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
