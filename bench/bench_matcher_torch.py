#!/usr/bin/env python3
"""Matcher microbenchmark of the port: the plain PyTorch version of the
fused pool + cost + Sinkhorn against B1 (csrc/matcher.cu), the
counterpart of bench/bench_matcher.py.

Usage: python bench/bench_matcher_torch.py [--batch 8] [--iters 50]
           [--device cuda]
Prints ms per call of each (CUDA events after a warm-up; on the CPU, where
the wrapper runs the plain version, the host clock) and returns them.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--N", type=int, default=128)
    ap.add_argument("--P", type=int, default=448)    # 16x28 emb pixels
    ap.add_argument("--D", type=int, default=256)
    ap.add_argument("--Pc", type=int, default=4096)  # 64x64 cost pixels
    ap.add_argument("--sinkhorn", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from bench_torch import ms_per_call
    from dmm_net_tpu_torch import resolve_device
    from dmm_net_tpu_torch.kernels.matcher import (fused_pool_cost_match,
                                                   pool_cost_match_plain)

    dev = resolve_device(args.device)
    B, M, N, P, D, Pc = (args.batch, args.M, args.N, args.P, args.D, args.Pc)
    rng = np.random.RandomState(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    inputs = (t(rng.randn(B, P, D)), t(rng.rand(B, N, P) > 0.7),
              t(rng.rand(B, M, Pc) > 0.7), t(rng.rand(B, N, Pc) > 0.7),
              t(rng.randn(B, M, D)), torch.ones((B, M), dtype=torch.bool, device=dev),
              torch.ones((B, N), dtype=torch.bool, device=dev))
    kw = dict(epsilon=0.05, iters=args.sinkhorn, iou_weight=0.3)
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}), "
          f"B={B} M={M} N={N} P={P} D={D} Pc={Pc}")
    out = {}
    with torch.inference_mode():
        for name, fn in (("plain", pool_cost_match_plain),
                         ("kernel", fused_pool_cost_match)):
            ms = ms_per_call(lambda: fn(*inputs, **kw), args.iters, dev)
            out[f"{name}_ms"] = ms
            label = "plain PyTorch" if name == "plain" else (
                "B1 (csrc/matcher.cu)" if dev.type == "cuda"
                else "B1's wrapper (plain version on the CPU)")
            print(f"{label:40s} {ms:9.4f} ms/call ({B / ms * 1e3:9.1f} frames/sec)")
    return out


if __name__ == "__main__":
    main()
