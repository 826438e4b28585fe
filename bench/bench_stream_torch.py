#!/usr/bin/env python3
"""Streaming-pipeline benchmark of the port, the counterpart of
bench/bench_stream.py: does staging the next frames while the card
computes hide the host's decode?

The production streaming path at p4_ytvos_stream: compact proposals
(boxes + 28x28 box-local masks) pasted on the device, uint8 frames
normalised on the device. Host decode is simulated by a sleep, as in the
reference. Frames/s three ways, each through ``run_sequence`` (one
dispatch per frame) and through ``run_stream_chunked`` (K frames per
chunk):
  1. serial:   decode a frame, then step (no overlap);
  2. prefetch: decode and stage ahead on a producer thread, depth 3
               (data/pipeline.Prefetcher per frame; RingStager, the same
               with the decoding iterator on the producer, for chunks);
  3. ceiling:  every frame decoded beforehand (the device-bound rate).
Each run ends in a host copy of the labels, which waits for the card.

Usage: python bench/bench_stream_torch.py [--frames 48] [--decode-ms 8]
           [--objects 3] [--chunk 8] [--device cuda] [--set ...]
Returns {dispatch: {feed: frames/s}}.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--decode-ms", type=float, default=8.0)
    ap.add_argument("--objects", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", nargs="*", default=[],
                    help="dot-overrides of the p4_ytvos_stream preset")
    args = ap.parse_args(argv)

    import numpy as np

    from dmm_net_tpu_torch import resolve_device
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.data.pipeline import Prefetcher, RingStager
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.utils.cli import parse_overrides

    dev = resolve_device(args.device)
    cfg = preset("p4_ytvos_stream").override(**parse_overrides(args.set))
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals
    rng = np.random.RandomState(0)

    # compact proposals made once (full-grid masks never exist on the host)
    def make_item(t):
        r = np.random.RandomState(t)
        boxes = np.zeros((1, N, 4), np.float32)
        m28 = np.zeros((1, N, 28, 28), np.float32)
        pv = np.zeros((1, N), bool)
        n = min(16, N)
        x1 = r.rand(n) * (W - 60)
        y1 = r.rand(n) * (H - 60)
        boxes[0, :n] = np.stack([x1, y1, x1 + 30 + r.rand(n) * 30,
                                 y1 + 30 + r.rand(n) * 30], 1)
        m28[0, :n] = r.rand(n, 28, 28) > 0.4
        pv[0, :n] = True
        frame = (r.rand(1, H, W, 3) * 255).astype(np.uint8)
        return {"frame": frame, "prop_boxes": boxes, "prop_masks28": m28,
                "prop_valid": pv}

    T = args.frames
    pregen = [make_item(t) for t in range(T)]

    def decode(t):
        time.sleep(args.decode_ms / 1e3)   # simulated JPEG decode
        return pregen[t]

    tmpl_masks = np.zeros((1, M, H, W), np.float32)
    tmpl_valid = np.zeros((1, M), bool)
    tmpl_masks[0, :args.objects] = rng.rand(args.objects, H, W) > 0.8
    tmpl_valid[0, :args.objects] = True
    first = (rng.rand(1, H, W, 3) * 255).astype(np.uint8)
    engine = InferenceEngine(cfg, device=dev, seed=0)

    runs = {
        "per_frame": lambda it: engine.run_sequence(it, tmpl_masks, tmpl_valid,
                                                    first),
        "chunked": lambda it: engine.run_stream_chunked(
            it, tmpl_masks, tmpl_valid, first, chunk=args.chunk)}
    feeds = {
        "per_frame": {
            "serial": lambda: (decode(t) for t in range(T)),
            "prefetch": lambda: iter(Prefetcher(range(T), decode, depth=3,
                                                device=dev)),
            "ceiling": lambda: iter(pregen)},
        "chunked": {
            "serial": lambda: (decode(t) for t in range(T)),
            "prefetch": lambda: iter(RingStager((decode(t) for t in range(T)),
                                                depth=3, device=dev)),
            "ceiling": lambda: iter(pregen)}}
    out = {}
    print(f"decode={args.decode_ms} ms/frame, {T} frames, {H}x{W}, "
          f"{args.objects} objects (bucketed), compact proposals, device {dev}")
    for dispatch, run in runs.items():
        run(iter(pregen[:args.chunk]))                   # warm
        out[dispatch] = {}
        for feed, make in feeds[dispatch].items():
            t0 = time.perf_counter()
            run(make())                  # returns host labels: waits for the card
            out[dispatch][feed] = T / (time.perf_counter() - t0)
            print(f"{dispatch:9s} {feed:9s} {out[dispatch][feed]:8.1f} fps")
        r = out[dispatch]
        if r["ceiling"] > r["serial"]:
            rec = 100 * (r["prefetch"] - r["serial"]) / (r["ceiling"] - r["serial"])
            print(f"{dispatch}: overlap recovers {rec:.0f}% of the decode stall")
    return out


if __name__ == "__main__":
    main()
