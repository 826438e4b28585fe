#!/usr/bin/env python3
"""Per-stage cost of the port's frame step from cumulative prefixes, the
counterpart of bench/bench_breakdown.py.

Each measurement runs a PREFIX of the frame step (backbone; +match;
+aggregate; +decoder; +resolve = full) and the deltas between prefixes are
the stages' costs. Each prefix makes the same calls as the frame step up to
its stage, so its work is a part of the next prefix's. The reference's
prefixes each return a reduction of all live outputs, which keeps XLA from
dropping a stage; eager PyTorch drops no work, and a full reduction adds to
each prefix a different cost (a float32 sum over the backbone's pyramid in
the aggregate prefix cost more than the decoder, whose delta then came out
negative), so here a prefix returns its outputs and nothing is added.
A prefix is timed two ways on the card: wall ms, CUDA events over
BENCH_ITERS calls whose last ends in a synchronize (the best of 3 runs),
and device ms, every kernel torch.profiler records over BENCH_ITERS calls
(bench_torch.device_ms_per_call). The step is partly host-bound, so only
the device times nest; the deltas are theirs (on the CPU, the wall
times'). Per-stage FLOPs come from torch.utils.flop_counter.FlopCounterMode
(plus B1's and B2's operations, which it cannot see on the card:
bench_torch.count_flops) and bytes from the port's bytes model
(utils/bytes_model.py, a lower bound), with the effective rate over the
device delta and its share of the H100's 3.35 TB/s.
The reference's intra-decoder prefixes (BENCH_DECODER) need the decoder's
``stop_at``, which the port's decoder does not have.

Usage: python bench/bench_breakdown_torch.py [--device cuda] [--set ...]
       (BENCH_BATCH, default 8; BENCH_ITERS, default 30)
Returns the rows it prints.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", nargs="*", default=[],
                    help="dot-overrides of the p3 preset")
    args = ap.parse_args(argv)

    import torch

    from bench_torch import (H100_HBM_PEAK_BYTES, count_flops, device_ms_per_call,
                             kernel_ops, ms_per_call)
    from dmm_net_tpu_torch import resolve_device
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.models.dmm import (DMMNet, _mask_dtype, _to_mask_grid,
                                              mask_hw)
    from dmm_net_tpu_torch.utils.bench_inputs import make_frame_inputs
    from dmm_net_tpu_torch.utils.bytes_model import chunk_step_bytes
    from dmm_net_tpu_torch.utils.cli import parse_overrides

    dev = resolve_device(args.device)
    B = int(os.environ.get("BENCH_BATCH", "8"))
    iters = int(os.environ.get("BENCH_ITERS", "30"))
    cfg = preset("p3_multi_object").override(**parse_overrides(args.set))
    H, W = cfg.model.image_size
    engine = InferenceEngine(cfg, device=dev, seed=0)
    model = engine.model
    inputs = make_frame_inputs(cfg, B, device=dev)
    frame, pm, pv, tf_, tv, state = inputs

    mdt, mhw = _mask_dtype(cfg), mask_hw(cfg)

    def backbone():
        return model.extract_features(frame)

    def match():
        return model.match_assignment(*inputs)

    def agg():
        # the soft decode's first step, as decode_from_assignment makes it
        feats, X = model.match_assignment(*inputs)
        return feats, X, DMMNet.aggregate(X, _to_mask_grid(pm.to(mdt), mhw), tv)

    def decoder():
        return model(*inputs)

    def full():
        return engine._frame_step(*inputs)

    # the bytes model's stages that each prefix adds (MB per frame)
    mb = chunk_step_bytes(cfg, B)["stages"]
    stage_mb = {"backbone+proj": ("frame_in", "backbone", "weights_backbone"),
                "(+)pool/cost/match": ("matcher",),
                "(+)aggregate": ("aggregate",),
                "(+)decoder": ("decoder", "weights_decoder", "logits"),
                "(+)resolve = FULL": ("resolve_labels",)}
    ops = kernel_ops(cfg, B, tv, pv)
    print(f"B={B} image={H}x{W} M={cfg.matching.max_templates} "
          f"N={cfg.matching.max_proposals} mask_res={cfg.model.mask_res} device={dev}")
    rows, prev = [], (0.0, 0.0)
    with torch.inference_mode():
        for name, fn in (("backbone+proj", backbone), ("(+)pool/cost/match", match),
                         ("(+)aggregate", agg), ("(+)decoder", decoder),
                         ("(+)resolve = FULL", full)):
            ms = min(ms_per_call(fn, iters, dev) for _ in range(3))
            dev_ms = device_ms_per_call(fn, iters, dev)
            gf = count_flops(fn, (), ops) / 1e9
            t = ms if dev_ms is None else dev_ms
            d_ms, d_gf = t - prev[0], gf - prev[1]
            d_mb = B * sum(mb[k] for k in stage_mb[name])
            eff = d_mb / max(d_ms, 0.005)     # MB/ms == GB/s; deltas under
            row = {"stage": name, "ms": ms, "device_ms": dev_ms,  # 5 us are noise
                   "delta_ms": d_ms, "delta_gflop": d_gf, "delta_mb": d_mb,
                   "eff_gb_per_s": eff}
            if dev.type == "cuda":
                row["pct_of_hbm"] = 100 * eff * 1e9 / H100_HBM_PEAK_BYTES
            rows.append(row)
            print(f"{name:20s} {ms:8.3f} ms"
                  + (f", device {dev_ms:8.3f} ms" if dev_ms is not None else "")
                  + f"  (delta {d_ms:7.3f} ms, {d_gf:7.2f} GF, "
                  f"{d_mb:8.1f} MB, {eff:6.0f} GB/s eff"
                  + (f" = {row['pct_of_hbm']:3.0f}% of H100 HBM)" if "pct_of_hbm" in row
                     else ")"))
            prev = (t, gf)
    return rows


if __name__ == "__main__":
    main()
