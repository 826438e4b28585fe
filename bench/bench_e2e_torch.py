#!/usr/bin/env python3
"""End-to-end frame-step benchmark of the port: frames/s against the
batch size B, for a bf16 and a float32 decoder, with the plain matcher or
B1 (--pallas), the counterpart of bench/bench_e2e.py.

Usage: python bench/bench_e2e_torch.py [--batches 1 2 4 8] [--iters 20]
           [--pallas] [--decoder-dtypes bfloat16 float32] [--device cuda]
           [--set key=value ...]
One frame step per call (the model and the labels, B2 resolving them),
the carried state fed back, timed with CUDA events after a warm-up.
Returns the rows it prints.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--pallas", action="store_true",
                    help="B1 for the matcher (default: the plain matcher)")
    ap.add_argument("--decoder-dtypes", nargs="*",
                    default=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", nargs="*", default=[],
                    help="dot-overrides of the p3 preset, e.g. model.image_size=64,64")
    args = ap.parse_args(argv)

    import torch

    from bench_torch import ms_per_call
    from dmm_net_tpu_torch import resolve_device
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.utils.bench_inputs import make_frame_inputs
    from dmm_net_tpu_torch.utils.cli import parse_overrides

    dev = resolve_device(args.device)
    base = preset("p3_multi_object").override(
        **{"matching.use_pallas": args.pallas, **parse_overrides(args.set)})
    H, W = base.model.image_size
    print(f"device={dev} image={H}x{W} M={base.matching.max_templates} "
          f"N={base.matching.max_proposals} pallas={args.pallas}")
    rows = []
    with torch.inference_mode():
        for dtype in args.decoder_dtypes:
            cfg = base.override(**{"model.decoder_dtype": dtype})
            engine = InferenceEngine(cfg, device=dev, seed=0)
            for B in args.batches:
                frame, pm, pv, tf_, tv, st = make_frame_inputs(cfg, B, seed=B,
                                                               device=dev)
                carried = [st]

                def step():
                    carried[0] = engine._frame_step(frame, pm, pv, tf_, tv,
                                                    carried[0])[2]
                ms = ms_per_call(step, args.iters, dev)
                rows.append({"decoder_dtype": dtype, "B": B, "ms_per_step": ms,
                             "frames_per_s": B / ms * 1e3})
                print(f"decoder {dtype:8s} B={B:2d}: {ms:8.2f} ms/step  "
                      f"{B / ms * 1e3:8.1f} frames/sec")
            del engine
    return rows


if __name__ == "__main__":
    main()
