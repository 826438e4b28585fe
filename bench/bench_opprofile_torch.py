#!/usr/bin/env python3
"""Per-kernel device-time profile of the port's chunked step, the
counterpart of bench/bench_opprofile.py (which reads XLA ops from the
xplane): torch.profiler's ``key_averages()`` over a few
``InferenceEngine._chunk_step_compact`` calls on bench_torch.py's inputs,
summed by kernel name.

Usage: python bench/bench_opprofile_torch.py [--calls 2] [--top 45]
           [--device cuda]   (BENCH_BATCH / BENCH_CHUNK / BENCH_PRESET /
                              BENCH_SET as in bench_torch.py)
Prints the top kernels by total device time over the traced calls (on the
CPU: the top operators by self CPU time) and returns them as (name, ms).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--top", type=int, default=45)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_torch import bench_config, compact_inputs
    from dmm_net_tpu_torch import resolve_device
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.utils.bench_inputs import make_frame_inputs

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    B = int(os.environ.get("BENCH_BATCH", "16"))
    K = int(os.environ.get("BENCH_CHUNK", "16"))
    cfg, _ = bench_config()
    with torch.inference_mode():
        engine = InferenceEngine(cfg, device=dev, seed=0)
        _, _, _, tf_, tv, state = make_frame_inputs(cfg, B, device=dev)
        chunk_args = (*compact_inputs(cfg, B, K, dev), tf_, tv, state)
        engine._chunk_step_compact(*chunk_args)          # warm
        if cuda:
            torch.cuda.synchronize(dev)
        activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
        with profile(activities=[activity]) as prof:
            for _ in range(args.calls):
                engine._chunk_step_compact(*chunk_args)
            if cuda:
                torch.cuda.synchronize(dev)
    per = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
              if cuda else ev.self_cpu_time_total)
        if us > 0:
            per[ev.key] = per.get(ev.key, 0.0) + us / 1e3
    if not per:
        raise RuntimeError("torch.profiler recorded no time")
    rows = sorted(per.items(), key=lambda kv: -kv[1])[:args.top]
    what = "device" if cuda else "self CPU"
    print(f"{what} time {sum(per.values()):.2f} ms over {args.calls} calls of "
          f"K={K}, B={B} ({cfg.name}); {len(per)} names")
    for name, ms in rows:
        print(f"{ms:9.3f} ms  {name[:120]}")
    return rows


if __name__ == "__main__":
    main()
