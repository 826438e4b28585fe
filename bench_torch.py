#!/usr/bin/env python3
"""End-to-end frames per second of the PyTorch/CUDA port (matching +
refine), the counterpart of the JAX package's bench.py.

    python3 bench_torch.py                   # on the card; one JSON line
    BENCH_DEVICE=cpu python3 bench_torch.py  # on the CPU, when asked

Measures the flagship ResNet-50 multi-object configuration (p3: 256x448,
M=16 templates, N=128 proposals, B1 for the matcher and B2 for the labels,
bf16 mask path) with seeded random weights. Proposal generation is
excluded, as in the reference's offline-proposal protocol.

Measured region (``BENCH_MODE=chunked_scan``, the default): the streaming
dispatch, ``InferenceEngine._chunk_step_compact`` over a K-frame chunk of
uint8 frames and compact proposals (boxes + 28x28 box-local masks, pasted
on the device frame by frame) with the carried template and decoder state,
what ``run_stream_chunked`` runs per chunk. The inputs are bench.py's,
from ``np.random.RandomState(0)``, at B=16 and K=16. ``BENCH_MODE=frame``
times one frame step (the model and the labels) per call instead.

Knobs (environment), as bench.py's: BENCH_BATCH (16), BENCH_CHUNK (16),
BENCH_ITERS (10 calls per window; at least 30 in frame mode),
BENCH_WINDOWS (5), BENCH_PRESET (p3_multi_object; p3_480p or
p4_ytvos_stream for the other geometries), BENCH_SET (dot-overrides,
space- or ;-separated, echoed in the JSON as ``overrides``), and
BENCH_DEVICE (the card unless it is ``cpu``; with no card and no
BENCH_DEVICE=cpu the bench exits non-zero).

Each window ends in ``torch.cuda.synchronize()``: the host returns before
the card finishes, so a window without it would time the enqueue.
``value`` is the best window's frames/s and ``fps_windows`` lists all.
``pallas_parity_max_abs`` holds X from the kernels against X from the
plain matcher (``matching.use_pallas=false``) on the same weights and
inputs, and must stay under 5e-3, as bench.py's check.

``gflop_per_frame``: ``torch.utils.flop_counter.FlopCounterMode`` over
one frame step of the measured dispatch (the reference's cost analysis
counts its scan body, one B-frame batch, once), plus the operations of the
B1 and B2 launches, which the counter cannot see (their formulas are the
kernels' bounds in chip_smoke.py; on the CPU the plain versions run as
ordinary ops and the counter sees them). ``mfu_pct_bf16_peak`` divides it
by the H100 SXM's dense bf16 peak. ``mb_per_frame_hand`` is the port's
bytes model (dmm_net_tpu_torch/utils/bytes_model.py, a lower bound) and
``hbm_roofline_pct_hand`` its share of the card's memory rate. The
reference's ``mb_per_frame`` / ``hbm_roofline_pct`` come from XLA's "bytes
accessed", which has no counterpart here: they stay in the line as null.
A CPU run prints ``device: "cpu"`` and null for every share of a device
peak. ``peak_mem_gib`` is ``torch.cuda.max_memory_allocated()`` over the
run.

``vs_baseline`` / ``vs_estimate`` divide by the reference-GPU estimate of
BASELINE.md (no published number exists), as bench.py does.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Reference GPU end-to-end fps (matching + refine): an ESTIMATE recorded in
# BASELINE.md, not a published number; the JSON says so ("vs_estimate" and
# its note; "vs_baseline" is kept because bench.py's line has it).
REFERENCE_GPU_FPS_ESTIMATE = 10.0

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate, at
# the full 700 W power limit (the JSON carries the card's limit).
H100_BF16_PEAK_FLOPS = 989e12
H100_HBM_PEAK_BYTES = 3.35e12

PARITY_LIMIT = 5e-3


def bench_config():
    """The config BENCH_PRESET and BENCH_SET select, and the overrides."""
    from dmm_net_tpu_torch.config import preset
    cfg = preset(os.environ.get("BENCH_PRESET", "p3_multi_object"))
    overrides = os.environ.get("BENCH_SET", "")
    if overrides:
        from dmm_net_tpu_torch.utils.cli import parse_overrides
        cfg = cfg.override(**parse_overrides(overrides.replace(";", " ").split()))
    return cfg, overrides


def device_info(device):
    """(name, power limit in W) of the card from nvidia-smi; ("cpu", None)
    on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    import torch
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    line = r.stdout.strip().splitlines()[device.index or 0]
    watts = line.rsplit(",", 1)[1].strip().split()[0]
    return torch.cuda.get_device_name(device), float(watts)


def kernel_ops(cfg, B: int, tmpl_valid, prop_valid):
    """Operations of one B1 and one B2 launch of a frame step of batch B
    (see ``pool_cost_match_ops`` and ``resolve_upsample_ops``)."""
    from dmm_net_tpu_torch.kernels.matcher import pool_cost_match_ops
    from dmm_net_tpu_torch.kernels.resolve import resolve_upsample_ops
    from dmm_net_tpu_torch.models.dmm import mask_hw
    H, W = cfg.model.image_size
    M, N = tmpl_valid.shape[1], prop_valid.shape[1]
    P = (H // 16) * (W // 16)                    # embedding pixels (c4)
    Pc = int(math.prod(cfg.cost.mask_size))
    pairs = int((tmpl_valid[:, :, None] & prop_valid[:, None, :]).sum())
    return {"fused_pool_cost_match": pool_cost_match_ops(
                B, M, N, P, cfg.model.feature_dim, Pc,
                cfg.matching.sinkhorn_iters, pairs),
            "fused_resolve_upsample": resolve_upsample_ops(
                int(tmpl_valid.sum()), mask_hw(cfg)[0], H, W)}


def count_flops(step, args, ops_per_launch) -> float:
    """FLOPs of ``step(*args)``: what FlopCounterMode counts of the ops it
    dispatches, plus ``ops_per_launch`` for each kernel launch made meanwhile
    (a kernel bound through ctypes is invisible to the counter). Raises
    when nothing is counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from dmm_net_tpu_torch.kernels import launch_counts
    before = launch_counts()
    with FlopCounterMode(display=False) as counter:
        step(*args)
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    flops = float(counter.get_total_flops()) + sum(
        n * ops_per_launch[k] for k, n in launched.items() if n)
    if not flops > 0:
        raise RuntimeError("the FLOP count of the frame step is 0")
    return flops


def ms_per_call(fn, iters: int, device, warmup: int = 2) -> float:
    """Mean ms per call of ``fn()`` over ``iters`` calls after ``warmup``:
    CUDA events around the calls, read after a synchronize, on the card;
    the host clock on the CPU. (The bench/*_torch.py tools time with it.)"""
    import torch
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn, calls: int, warmup: int = 2) -> dict:
    """Device ms per call of ``fn()`` on the card by kernel name: every
    kernel, copy and fill that torch.profiler's CUDA activity records over
    ``calls`` calls after ``warmup``. Raises where it records none."""
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


def device_ms_per_call(fn, calls: int, device, warmup: int = 2):
    """Mean device time per call of ``fn()``: ``device_ms_by_kernel``
    summed (one stream, so they do not overlap). Unlike ``ms_per_call`` it
    leaves out the host's gaps between launches. None on the CPU."""
    import torch
    if torch.device(device).type != "cuda":
        return None
    with torch.cuda.device(device):
        return sum(device_ms_by_kernel(fn, calls, warmup).values())


def compact_inputs(cfg, B: int, K: int, device):
    """bench.py's chunked-mode inputs from np.random.RandomState(0): uint8
    frames (K, B, H, W, 3), boxes (K, B, N, 4), 28x28 box-local masks
    (K, B, N, 28, 28) uint8, all proposals valid."""
    import numpy as np
    import torch
    H, W = cfg.model.image_size
    N = cfg.matching.max_proposals
    rng = np.random.RandomState(0)
    frames = (rng.rand(K, B, H, W, 3) * 255).astype(np.uint8)
    cy = rng.rand(K, B, N, 1) * H
    cx = rng.rand(K, B, N, 1) * W
    bh = rng.rand(K, B, N, 1) * H * 0.3 + 8
    bw = rng.rand(K, B, N, 1) * W * 0.3 + 8
    boxes = np.concatenate([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                            cy + bh / 2], axis=-1).astype(np.float32)
    m28 = (rng.rand(K, B, N, 28, 28) > 0.4).astype(np.uint8)
    return (torch.from_numpy(frames).to(device),
            torch.from_numpy(boxes).to(device),
            torch.from_numpy(m28).to(device),
            torch.ones((K, B, N), dtype=torch.bool, device=device))


def parity(cfg, model, inputs) -> float:
    """max |X_kernels - X_plain|: the frame step's assignment with B1 and
    with the unfused matcher, on the same weights and inputs."""
    import torch

    from dmm_net_tpu_torch.models.dmm import DMMNet
    plain = DMMNet(cfg.override(**{"matching.use_pallas": False}),
                   device=model.device)
    plain.load_state_dict(model.state_dict())
    xa = model(*inputs)[0].assignment
    xb = plain(*inputs)[0].assignment
    err = float((xa - xb).abs().max())
    del plain
    if model.device.type == "cuda":
        torch.cuda.empty_cache()
    return err


def main() -> dict:
    import torch

    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.utils.bench_inputs import make_frame_inputs
    from dmm_net_tpu_torch.utils.bytes_model import chunk_step_bytes

    asked = os.environ.get("BENCH_DEVICE", "")
    device = torch.device(asked or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch.py: no CUDA device (BENCH_DEVICE=cpu "
                         "runs it on the CPU)")
    mode = os.environ.get("BENCH_MODE", "chunked_scan")
    if mode not in ("chunked_scan", "frame"):
        raise SystemExit(f"bench_torch.py: BENCH_MODE={mode!r}, expected "
                         "chunked_scan or frame")
    B = int(os.environ.get("BENCH_BATCH", "16"))
    K = int(os.environ.get("BENCH_CHUNK", "16"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    windows = int(os.environ.get("BENCH_WINDOWS", "5"))
    cfg, overrides = bench_config()
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    with torch.inference_mode():
        engine = InferenceEngine(cfg, device=device, seed=0)
        frame, pm, pv, tf_, tv, state = make_frame_inputs(cfg, B, device=device)
        err = None
        if cfg.matching.use_pallas:
            err = parity(cfg, engine.model, (frame, pm, pv, tf_, tv, state))
            if not err < PARITY_LIMIT:
                raise RuntimeError(f"kernels vs plain matcher: max |dX| {err} "
                                   f"(limit {PARITY_LIMIT})")
        window_fps = []
        if mode == "frame":
            args = (frame, pm, pv, tf_, tv, state)
            step = engine._frame_step
            step(*args)
            sync()
            n_iters = max(iters, 30)
            for _ in range(windows):
                t0 = time.perf_counter()
                for _ in range(n_iters):
                    step(*args)
                sync()
                window_fps.append(n_iters * B / (time.perf_counter() - t0))
            count = (step, args, pv)
        else:
            del pm                                # 0.94 GB at p3, B=16
            frames_u8, boxes, m28, pvk = compact_inputs(cfg, B, K, device)
            chunk = engine._chunk_step_compact
            chunk(frames_u8, boxes, m28, pvk, tf_, tv, state)
            sync()
            st = state
            for _ in range(windows):
                t0 = time.perf_counter()
                for _ in range(iters):
                    _, _, st = chunk(frames_u8, boxes, m28, pvk, tf_, tv, st)
                sync()
                window_fps.append(iters * K * B / (time.perf_counter() - t0))
            count = (engine._frame_step_compact,
                     (frames_u8[0], boxes[0], m28[0], pvk[0], tf_, tv, state),
                     pvk[0])
        step, args, prop_valid = count
        flops = count_flops(step, args, kernel_ops(cfg, B, tv, prop_valid))
        sync()

    fps = max(window_fps)
    gflop_per_frame = flops / B / 1e9
    mb_hand = chunk_step_bytes(cfg, B)["total_mb_per_frame"]
    name, watts = device_info(device)
    out = {
        "metric": "end_to_end_frames_per_sec_per_chip_matching_refine",
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": fps / REFERENCE_GPU_FPS_ESTIMATE,
        "vs_estimate": fps / REFERENCE_GPU_FPS_ESTIMATE,
        "baseline_note": ("reference GPU fps never published; denominator "
                          f"is the {REFERENCE_GPU_FPS_ESTIMATE} fps estimate "
                          "recorded in BASELINE.md - read absolute "
                          "fps/MFU/roofline instead"),
        "mode": mode,
        "batch": B,
        "chunk": None if mode == "frame" else K,
        "preset": cfg.name,
        "image_size": [H, W],
        "M": M, "N": N,
        "decoder_variant": cfg.model.decoder_variant,
        "decoder_obj_dim_fine": cfg.model.decoder_obj_dim_fine,
        "decoder_obj_fuse": cfg.model.decoder_obj_fuse,
        "decoder_obj_fine_level": cfg.model.decoder_obj_fine_level,
        "decoder_obj_merge_fine_k": cfg.model.decoder_obj_merge_fine_k,
        "decoder_detail_dim": cfg.model.decoder_detail_dim,
        "decoder_detail_basis_k": cfg.model.decoder_detail_basis_k,
        "mask_dtype": cfg.model.mask_dtype,
        "use_pallas": cfg.matching.use_pallas,
        "fps_windows": window_fps,
        "pallas_parity_max_abs": err,
        "gflop_per_frame": gflop_per_frame,
        "mfu_pct_bf16_peak": (100.0 * flops / B * fps / H100_BF16_PEAK_FLOPS
                              if cuda else None),
        "mb_per_frame": None,
        "hbm_roofline_pct": None,
        "mb_per_frame_hand": mb_hand,
        "hbm_roofline_pct_hand": (100.0 * mb_hand * 1e6 * fps / H100_HBM_PEAK_BYTES
                                  if cuda else None),
        "device": name,
        "power_limit_w": watts,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if cuda else None),
        **({"overrides": overrides} if overrides else {}),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
