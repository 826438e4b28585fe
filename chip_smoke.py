#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dmm_net_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version at the p3 shapes
     (and B1 at the p4 shapes) and time both with CUDA events, over enough
     input copies that every launch reads from device memory, not L2;
  4. drive the p3_multi_object streaming path at full width (ResNet-50,
     256x448, M=16, N=128, B=4, K=8, three chunks; seeded random weights)
     through InferenceEngine.run_stream_chunked with every launch counter
     set to 0 just before and read just after;
  5. run a small float32 configuration on the card and on the CPU (plain
     versions only) with the same weights and inputs, and compare.

Prints one JSON line {"kernels": [...]} with each kernel's launches, error,
time, plain-version time and bound, then the nvidia-smi line, then
{"ok": true, "device": {...}} as the last line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, inputs, iters: int) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``inputs``
    (CUDA events, after a warm-up)."""
    import torch
    for a in inputs[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, inputs, iters: int, kernel_names) -> float:
    """Mean device time per call of the CUDA kernels whose names contain one
    of ``kernel_names`` (torch.profiler over ``iters`` calls); falls back to
    CUDA events around the calls when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for a in inputs[:3]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        hit = [n for n in kernel_names if n in ev.key]
        if hit:
            us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
            total_us += us
            log(f"  {hit[0]}: {us / 1e3 / iters:.4f} ms per call on the device")
    if total_us <= 0:
        log("profiler recorded no device time; timing with CUDA events")
        return time_ms(fn, inputs, iters)
    return total_us / 1e3 / iters


def copies_for(nbytes: int) -> int:
    """Input copies to cycle so that consecutive launches miss the 50 MB L2."""
    return max(2, int(np.ceil(120e6 / max(nbytes, 1))))


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def matcher_inputs(gen, B, M, N, P, D, Pc):
    """B1 inputs at the frame step's shapes: binary masks on the embedding
    and cost grids, unit-variance features, ~80% valid rows and columns."""
    import torch
    dev = "cuda"
    emb = torch.randn(B, P, D, device=dev, generator=gen)
    pm_pool = (torch.rand(B, N, P, device=dev, generator=gen) > 0.7).float()
    tm = (torch.rand(B, M, Pc, device=dev, generator=gen) > 0.7).float()
    pm = (torch.rand(B, N, Pc, device=dev, generator=gen) > 0.7).float()
    tf = torch.randn(B, M, D, device=dev, generator=gen)
    rm = torch.rand(B, M, device=dev, generator=gen) > 0.2
    rm[:, 0] = True
    cm = torch.rand(B, N, device=dev, generator=gen) > 0.2
    return [emb, pm_pool, tm, pm, tf, rm, cm]


def matcher_bound(args, iters: int):
    emb, pm_pool, tm, pm, tf, rm, cm = args
    B, P, D = emb.shape
    M, Pc = tm.shape[1:]
    N = pm.shape[1]
    pairs = int((rm[:, :, None] & cm[:, None, :]).sum().item())
    byts = nbytes(*args) + B * M * N * 4                    # + X written
    ops = (2 * B * N * P * D + B * N * P           # pooling + mask areas
           + 2 * B * M * N * Pc + B * (M + N) * Pc  # intersections + areas
           + 2 * B * M * N * D + 2 * B * (M + N) * D  # cosine + norms
           + 10 * (iters + 1) * pairs)              # Sinkhorn row/col LSEs
    return byts, ops


def resolve_bound(logits, valid, H, W):
    B, M, h, w = logits.shape
    mv = int(valid.sum().item())                    # valid (b, m) slots
    byts = nbytes(logits, valid) + B * H * W        # + uint8 labels written
    ops = 3 * mv * h * W + 3 * mv * H * W + mv * H * W   # col pass, row pass, argmax
    return byts, ops


def bound_ms(byts, ops):
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def check_matcher(name, shape, iters=30, timed=True, eps_init=None):
    import torch
    from dmm_net_tpu_torch.kernels.matcher import (fused_pool_cost_match,
                                                   pool_cost_match_plain)
    gen = torch.Generator(device="cuda").manual_seed(11)
    args = matcher_inputs(gen, *shape)
    got = fused_pool_cost_match(*args, iters=iters, epsilon_init=eps_init)
    want = pool_cost_match_plain(*args, iters=iters, epsilon_init=eps_init)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rm, cm = args[5], args[6]
    pad_zero = bool((got[~rm] == 0).all() and (got.transpose(1, 2)[~cm] == 0).all())
    log(f"B1 fused_pool_cost_match {name} B,M,N,P,D,Pc={shape} "
        f"eps_init={eps_init}: max|dX|={err:.3e} (limit 2e-4), "
        f"padded entries zero={pad_zero}")
    if not (err <= 2e-4 and pad_zero and torch.isfinite(got).all()):
        fail(f"B1 disagrees with its plain version at {name}")
    if not timed:
        return None
    byts, ops = matcher_bound(args, iters)
    copies = [matcher_inputs(gen, *shape) for _ in range(copies_for(byts) - 1)]
    inputs = [args] + copies
    kernel = lambda *a: fused_pool_cost_match(*a, iters=iters)  # noqa: E731
    ms = device_ms(kernel, inputs, 100, ("pool_cost_kernel", "sinkhorn_kernel"))
    call = time_ms(kernel, inputs, 200)
    plain = time_ms(lambda *a: pool_cost_match_plain(*a, iters=iters), inputs, 20)
    b_ms, b_by = bound_ms(byts, ops)
    log(f"B1 {name} time: kernel {ms:.4f} ms on the device ({call:.4f} ms per "
        f"wrapper call), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {byts / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
    return {"max_abs_err": err, "ms": ms, "call_ms": call, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by}


def check_resolve(name, B, M, h, w, H, W):
    import torch
    from dmm_net_tpu_torch.kernels.resolve import (fused_resolve_upsample,
                                                   resolve_upsample_plain)
    gen = torch.Generator(device="cuda").manual_seed(12)

    def make():
        lg = torch.randn(B, M, h, w, device="cuda", generator=gen) * 3.0
        v = torch.rand(B, M, device="cuda", generator=gen) > 0.25
        v[:, 0] = True
        lg[~v] = 50.0                    # invalid slots carry the largest logits
        return [lg, v]

    args = make()
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        got = fused_resolve_upsample(args[0].to(dt), args[1], (H, W))
        want = resolve_upsample_plain(args[0].to(dt), args[1], (H, W))
        torch.cuda.synchronize()
        mism = (got != want).float().mean().item()
        err = (got.int() - want.int()).abs().max().item()
        log(f"B2 fused_resolve_upsample {name} logits {dt} {tuple(args[0].shape)}"
            f" -> ({B}, {H}, {W}): label mismatch {mism:.3e} (limit 1e-3)")
        if mism >= 1e-3 or got.dtype != torch.uint8:
            fail(f"B2 disagrees with its plain version at {name} ({dt})")
        worst = max(worst, err)
    byts, ops = resolve_bound(*args, H, W)
    inputs = [args] + [make() for _ in range(copies_for(byts) - 1)]
    kernel = lambda lg, v: fused_resolve_upsample(lg, v, (H, W))  # noqa: E731
    ms = device_ms(kernel, inputs, 200, ("resolve_kernel",))
    call = time_ms(kernel, inputs, 500)
    plain = time_ms(lambda lg, v: resolve_upsample_plain(lg, v, (H, W)), inputs, 20)
    b_ms, b_by = bound_ms(byts, ops)
    log(f"B2 {name} time (f32 logits): kernel {ms:.4f} ms on the device "
        f"({call:.4f} ms per wrapper call), plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {byts / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
    return {"max_abs_err": float(worst), "mismatch_frac": mism, "ms": ms,
            "call_ms": call, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by}


# ---------------------------------------------------------------------------
# phase 4/5: the streaming path
# ---------------------------------------------------------------------------

def make_stream(seed, T, B, M, N, H, W, n_valid):
    """Host-side inputs as a proposal cache would give them: uint8 frames,
    boxes + 28x28 box-local masks, frame-1 template masks (disks)."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (T, B, H, W, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:H, :W]
    tmpl = np.zeros((B, M, H, W), np.float32)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        valid[b, :n_valid[b]] = True
        for m in range(n_valid[b]):
            cy, cx = rng.randint(H // 8, H - H // 8), rng.randint(W // 8, W - W // 8)
            r2 = (rng.uniform(0.03, 0.15) * min(H, W)) ** 2
            tmpl[b, m] = ((yy - cy) ** 2 + (xx - cx) ** 2) < r2
    g = np.linspace(-1, 1, 28)
    disk = (g[None] ** 2 + g[:, None] ** 2 < 0.8).astype(np.float32)
    items = []
    for t in range(T):
        xy = rng.rand(B, N, 2) * np.array([W * 0.8, H * 0.8])
        wh = 8 + rng.rand(B, N, 2) * np.array([W, H]) * 0.3
        noise = rng.rand(B, N, 28, 28) > 0.85
        items.append({"frame": frames[t],
                      "prop_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
                      "prop_masks28": np.logical_xor(disk > 0, noise).astype(np.float32),
                      "prop_valid": rng.rand(B, N) > 0.15})
    return frames, tmpl, valid, items


def main_path():
    import torch
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg = preset("p3_multi_object")
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals
    B, K, chunks = cfg.data.batch_size, 8, 3
    T = K * chunks
    engine = InferenceEngine(cfg, seed=0)
    log(f"main path: {cfg.name} {cfg.model.backbone} {H}x{W} M={M} N={N} "
        f"B={B} K={K} chunks={chunks} mask_res={cfg.model.mask_res} "
        f"logits_res={cfg.model.logits_res} dtypes backbone={cfg.model.backbone_dtype} "
        f"decoder={cfg.model.decoder_dtype} masks={cfg.model.mask_dtype}")
    frames, tmpl, valid, items = make_stream(1, T, B, M, N, H, W,
                                             n_valid=[16, 13, 9, 5])
    # warm-up on one chunk (cuDNN plans, allocator); not counted
    engine.run_stream_chunked(iter(items[:K]), tmpl, valid, frames[0], chunk=K)
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.run_stream_chunked(iter(items), tmpl, valid, frames[0], chunk=K)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()

    labels, X = out["labels"], out["assignments"]
    if labels.shape != (T, B, H, W) or labels.dtype != np.uint8:
        fail(f"labels {labels.shape} {labels.dtype}, expected {(T, B, H, W)} uint8")
    if X.shape != (T, B, M, N) or not np.isfinite(X).all():
        fail(f"assignments {X.shape} not finite or wrong shape")
    row_err = float(np.abs(X.sum(-1)[:, valid] - 1.0).max())
    if row_err > 1e-3:
        fail(f"valid rows of X sum to 1 +- {row_err:.2e} (> 1e-3)")
    if (X[:, ~valid] != 0).any():
        fail("padded rows of X are not exactly 0")
    for k, n in counts.items():
        if n < T:
            fail(f"kernel {k} launched {n} times in {T} frame steps")
    labelled = float((labels > 0).mean())
    log(f"main path: {T} frame steps x B={B} in {secs:.3f} s -> "
        f"{T * B / secs:.1f} frames/s ({T / secs:.2f} frame steps/s), "
        f"launches {counts}, max|rowsum-1|={row_err:.2e}, "
        f"labelled pixels {labelled:.3f}")
    profile_chunk(engine, items[:K], tmpl, valid, frames[0], K)
    return counts, T * B / secs


def profile_chunk(engine, items, tmpl, valid, frame0, K):
    """One more chunk under torch.profiler: device busy share (kernel time
    over wall time; one stream, so kernels do not overlap) and the kernels
    that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_stream_chunked(iter(items), tmpl, valid, frame0, chunk=K)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(per_name.values())
    log(f"profiled chunk ({K} frame steps): wall {wall_us / 1e3:.2f} ms, device "
        f"kernels {busy / 1e3:.2f} ms in {n_kernels} launches -> device busy "
        f"{busy / wall_us:.3f}, idle {1 - busy / wall_us:.3f}")
    per_cat: dict = {}
    for name, us in per_name.items():
        per_cat[kernel_category(name)] = per_cat.get(kernel_category(name), 0.0) + us
    for cat, us in sorted(per_cat.items(), key=lambda kv: -kv[1]):
        log(f"  {us / 1e3 / K:8.4f} ms/step {us / busy:6.3f}  [{cat}]")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / 1e3 / K:8.4f} ms/step {us / busy:6.3f}  {name[:110]}")


def kernel_category(name: str) -> str:
    n = name.lower()
    if "memcpy" in n or "memset" in n:
        return "host/device copies"
    if any(k in name for k in ("pool_cost_kernel", "sinkhorn_kernel",
                               "resolve_kernel")):
        return "port CUDA kernels B1+B2"
    if "upsample" in n:
        return "resize (antialiased bilinear)"
    if any(k in n for k in ("conv", "cudnn", "xmma", "gemm", "cutlass",
                            "nhwc", "nchw", "sm90")):
        return "convolution / matmul (cuDNN, cuBLAS)"
    if "reduce" in n:
        return "reductions"
    return "elementwise / casts / copies"


def small_reference():
    """The same small float32 configuration on the card (CUDA kernels,
    cuDNN) and on the CPU (plain versions), same weights and inputs."""
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.infer.engine import InferenceEngine

    cfg = preset("p3_multi_object").override(**{
        "model.backbone": "resnet18", "model.image_size": (64, 96),
        "model.backbone_dtype": "float32", "model.decoder_dtype": "float32",
        "model.mask_dtype": "float32", "matching.max_templates": 4,
        "matching.max_proposals": 8})
    frames, tmpl, valid, items = make_stream(2, 4, 2, 4, 8, 64, 96, [3, 2])
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngine(cfg, device=dev, seed=3)
        outs[dev] = eng.run_stream_chunked(iter(items), tmpl, valid, frames[0],
                                           chunk=2)
    mism = float((outs["cuda"]["labels"] != outs["cpu"]["labels"]).mean())
    xerr = float(np.abs(outs["cuda"]["assignments"]
                        - outs["cpu"]["assignments"]).max())
    log(f"small f32 reference (R-18 64x96, M=4, N=8, B=2, T=4): card vs CPU "
        f"label mismatch {mism:.3e} (limit 1e-3), max|dX| {xerr:.3e} (limit 2e-3)")
    if mism >= 1e-3 or xerr > 2e-3:
        fail("card and CPU disagree on the small float32 run")


def main() -> int:
    if not (ROOT / "dmm_net_tpu_torch" / "csrc").is_dir():
        fail("dmm_net_tpu_torch/ not found next to chip_smoke.py; run it from "
             "a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    from dmm_net_tpu_torch.kernels import _build

    smi = smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"gpu: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"tf32 cudnn={torch.backends.cudnn.allow_tf32} "
        f"matmul={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {len(_build.SOURCES)} CUDA sources in "
        f"{time.perf_counter() - t0:.1f} s ({_build.BUILD_DIR.relative_to(ROOT)})")

    # kernels against their plain versions: p3 bench batch (B=16), the main
    # path's batch (B=4), p4's M=32/N=256, and an annealed schedule
    b1 = check_matcher("p3 B=16", (16, 16, 128, 448, 256, 4096))
    check_matcher("p3 B=4", (4, 16, 128, 448, 256, 4096), timed=False)
    check_matcher("p4 B=4", (4, 32, 256, 448, 256, 4096))
    check_matcher("p3 B=4 annealed", (4, 16, 128, 448, 256, 4096), timed=False,
                  eps_init=0.5)
    b2 = check_resolve("p3 B=16", 16, 16, 64, 112, 256, 448)
    check_resolve("p3 B=4", 4, 16, 64, 112, 256, 448)

    counts, fps = main_path()
    small_reference()

    kernels = [
        dict(name="fused_pool_cost_match", route="cuda",
             source="dmm_net_tpu_torch/csrc/matcher.cu",
             replaces="dmm_net_tpu/kernels/matcher.py:262",
             launches=counts["fused_pool_cost_match"], shape="p3 B=16",
             library_ms=None, **b1),
        dict(name="fused_resolve_upsample", route="cuda",
             source="dmm_net_tpu_torch/csrc/resolve.cu",
             replaces="dmm_net_tpu/kernels/resolve.py:117",
             launches=counts["fused_resolve_upsample"], shape="p3 B=16",
             library_ms=None, **b2),
    ]
    print(json.dumps({"kernels": kernels, "frames_per_s": fps}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
