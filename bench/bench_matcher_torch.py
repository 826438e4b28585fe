#!/usr/bin/env python3
"""Matcher microbenchmark of the port: the plain PyTorch version of the
fused pool + cost + Sinkhorn against B1 (csrc/matcher.cu), the
counterpart of bench/bench_matcher.py.

Usage: python bench/bench_matcher_torch.py [--batch 8] [--iters 50]
           [--device cuda] [--train | --backward] [--device-ms CALLS]
           [--root DIR] [--shape B,M,N | p5 | p3 | p4 ...] [--epsilon E]
Prints ms per call of each (CUDA events after a warm-up; on the CPU, where
the wrapper runs the plain version, the host clock) and returns them.

--train times the forward with the float inputs requiring a gradient (on
the card B1 then also keeps what B1' reads); --backward times the forward
and B1' (the gradients of all five float inputs for a seeded upstream
gradient) and, on the card, B1''s device ms per call apart from the
forward's and the four products' (torch.profiler over --device-ms calls,
50 by default); --device-ms adds B1's device ms per call by kernel over
that many profiled calls; --root imports the package from another
checkout, so that two commits are timed by the same script on the same
card. The named shapes are chip_smoke.py phase 7a's: p5 (B=4, M=8, N=64,
epsilon 0.03), p3 (4, 16, 128) and p4 (4, 32, 256) at 0.05.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# this checkout's timers, also where --root imports another checkout's package
from bench_torch import device_ms_by_kernel, ms_per_call  # noqa: E402


# chip_smoke.py 7a's shapes: (B, M, N, epsilon)
NAMED_SHAPES = {"p5": (4, 8, 64, 0.03), "p3": (4, 16, 128, 0.05),
                "p4": (4, 32, 256, 0.05)}
FORWARD_KERNELS = ("matcher_pool_kernel", "matcher_cost_kernel", "matcher_sinkhorn_kernel")


def _shape(text: str, epsilon):
    if text in NAMED_SHAPES:
        B, M, N, eps = NAMED_SHAPES[text]
        return text, (B, M, N), eps if epsilon is None else epsilon
    B, M, N = (int(x) for x in text.split(","))
    return f"B={B} M={M} N={N}", (B, M, N), 0.05 if epsilon is None else epsilon


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
    ap.add_argument("--backward", action="store_true")
    ap.add_argument("--epsilon", type=float, default=None)
    ap.add_argument("--device-ms", type=int, default=0)
    ap.add_argument("--root", default=None)
    ap.add_argument("--shape", action="append", default=[],
                    help="B,M,N or p5, p3, p4 (repeatable; instead of --batch, "
                         "--M, --N)")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    from dmm_net_tpu_torch import resolve_device
    from dmm_net_tpu_torch.kernels.matcher import (fused_pool_cost_match,
                                                   pool_cost_match_plain)

    dev = resolve_device(args.device)
    shapes = ([_shape(sh, args.epsilon) for sh in args.shape] if args.shape else
              [_shape(f"{args.batch},{args.M},{args.N}", args.epsilon)])
    out = {}
    for key, (B, M, N), eps in shapes:
        r = _time_shape(args, dev, B, M, N, eps, ms_per_call, fused_pool_cost_match,
                        pool_cost_match_plain)
        if not args.shape:
            return r
        out[key] = r
    return out


def _time_shape(args, dev, B, M, N, epsilon, ms_per_call, fused_pool_cost_match,
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
    kw = dict(epsilon=epsilon, iters=args.sinkhorn, iou_weight=0.3)
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}), "
          f"B={B} M={M} N={N} P={P} D={D} Pc={Pc} epsilon={epsilon}"
          + (", train" if args.train else "") + (", backward" if args.backward else ""))
    if args.backward:
        gX = t(rng.randn(B, M, N))
        return _time_backward(args, dev, B, inputs, gX, kw, ms_per_call,
                              fused_pool_cost_match, pool_cost_match_plain)
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


def _time_backward(args, dev, B, inputs, gX, kw, ms_per_call, fused_pool_cost_match,
                   pool_cost_match_plain) -> dict:
    """The forward and B1' (all five float inputs' gradients) per call of
    each version; on the card B1''s device ms apart from the forward's and
    the products'."""
    import torch
    masks = inputs[5:]

    def step(fn):
        xs = [a.detach().requires_grad_(True) for a in inputs[:5]]
        return torch.autograd.grad(fn(*xs, *masks, **kw), xs, gX)

    out = {}
    for name, fn in (("plain", pool_cost_match_plain), ("kernel", fused_pool_cost_match)):
        out[f"{name}_ms"] = ms_per_call(lambda: step(fn), args.iters, dev)
        print(f"{name + ' forward + backward':40s} {out[f'{name}_ms']:9.4f} ms/call")
    if dev.type != "cuda":
        return out
    per = device_ms_by_kernel(lambda: step(fused_pool_cost_match), args.device_ms or 50)
    fwd = {k: v for k, v in per.items() if any(f in k for f in FORWARD_KERNELS)}
    bwd = {k: v for k, v in per.items() if "matcher_" in k and k not in fwd}
    out["forward_device_ms"] = sum(fwd.values())
    out["backward_kernel_ms"] = sum(bwd.values())
    out["products_ms"] = sum(v for k, v in per.items() if k not in fwd and k not in bwd)
    out["backward_device_ms"] = out["backward_kernel_ms"] + out["products_ms"]
    out["device_ms_by_name"] = per
    print(f"B1' on the device {out['backward_device_ms']:.4f} ms/call: kernels "
          f"{out['backward_kernel_ms']:.4f} ("
          + ", ".join(f"{k[:48]} {v:.4f}" for k, v in bwd.items())
          + f"), the products and the rest {out['products_ms']:.4f}; the forward "
          f"{out['forward_device_ms']:.4f}")
    return out


if __name__ == "__main__":
    main()
