#!/usr/bin/env python3
"""Matcher microbenchmark of the port: the plain PyTorch version of the
fused pool + cost + Sinkhorn against B1 (csrc/matcher.cu), the
counterpart of bench/bench_matcher.py.

Usage: python bench/bench_matcher_torch.py [--batch 8] [--iters 50]
           [--device cuda] [--train] [--device-ms CALLS] [--root DIR]
           [--shape B,M,N ...]
Prints ms per call of each (CUDA events after a warm-up; on the CPU, where
the wrapper runs the plain version, the host clock) and returns them.

--train times the forward with the float inputs requiring a gradient (on
the card B1 then also keeps its Sinkhorn duals for B1'); --device-ms adds
B1's device ms per call by kernel over that many profiled calls
(torch.profiler); --root imports the package from another checkout, so that
two commits are timed by the same script on the same card.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_ms_by_kernel(fn, calls: int, warmup: int = 2) -> dict:
    """Device ms per call of ``fn()`` by kernel name, from torch.profiler's
    CUDA activity over ``calls`` calls after ``warmup``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
        if us > 0:
            out[ev.key] = us / 1e3 / calls
    if not out:
        raise RuntimeError("torch.profiler recorded no device time")
    return out


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
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--device-ms", type=int, default=0)
    ap.add_argument("--root", default=None)
    ap.add_argument("--shape", action="append", default=[],
                    help="B,M,N (repeatable; instead of --batch, --M, --N)")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    from bench_torch import ms_per_call
    from dmm_net_tpu_torch import resolve_device
    from dmm_net_tpu_torch.kernels.matcher import (fused_pool_cost_match,
                                                   pool_cost_match_plain)

    dev = resolve_device(args.device)
    shapes = ([tuple(int(x) for x in sh.split(",")) for sh in args.shape]
              if args.shape else [(args.batch, args.M, args.N)])
    out = {}
    for B, M, N in shapes:
        r = _time_shape(args, dev, B, M, N, ms_per_call, fused_pool_cost_match,
                        pool_cost_match_plain)
        if not args.shape:
            return r
        out[f"B={B} M={M} N={N}"] = r
    return out


def _time_shape(args, dev, B, M, N, ms_per_call, fused_pool_cost_match,
                pool_cost_match_plain) -> dict:
    import numpy as np
    import torch
    P, D, Pc = args.P, args.D, args.Pc
    rng = np.random.RandomState(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    inputs = (t(rng.randn(B, P, D)), t(rng.rand(B, N, P) > 0.7),
              t(rng.rand(B, M, Pc) > 0.7), t(rng.rand(B, N, Pc) > 0.7),
              t(rng.randn(B, M, D)), torch.ones((B, M), dtype=torch.bool, device=dev),
              torch.ones((B, N), dtype=torch.bool, device=dev))
    kw = dict(epsilon=0.05, iters=args.sinkhorn, iou_weight=0.3)
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}), "
          f"B={B} M={M} N={N} P={P} D={D} Pc={Pc}" + (", train" if args.train else ""))
    if args.train:
        inputs = tuple(t.requires_grad_(True) if t.is_floating_point() else t
                       for t in inputs)
    out = {}
    with torch.inference_mode(not args.train):
        for name, fn in (("plain", pool_cost_match_plain),
                         ("kernel", fused_pool_cost_match)):
            ms = ms_per_call(lambda: fn(*inputs, **kw), args.iters, dev)
            out[f"{name}_ms"] = ms
            label = "plain PyTorch" if name == "plain" else (
                "B1 (csrc/matcher.cu)" if dev.type == "cuda"
                else "B1's wrapper (plain version on the CPU)")
            print(f"{label:40s} {ms:9.4f} ms/call ({B / ms * 1e3:9.1f} frames/sec)")
        if args.device_ms and dev.type == "cuda":
            per = device_ms_by_kernel(lambda: fused_pool_cost_match(*inputs, **kw),
                                      args.device_ms)
            out["kernel_device_ms"] = sum(per.values())
            out["kernel_device_ms_by_name"] = per
            print(f"B1 on the device {sum(per.values()):.4f} ms/call: "
                  + ", ".join(f"{k[:48]} {v:.4f}" for k, v in per.items()))
    return out


if __name__ == "__main__":
    main()
