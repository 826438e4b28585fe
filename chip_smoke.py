#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dmm_net_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version and time both, over
     enough input copies that every launch reads from device memory, not
     L2: B1 at p3 B=16 and B=4 (each of its launches' device time, and the
     Sinkhorn's per iteration), also at p4, annealed and N=100; B2 timed at
     p3 B=16 and B=4, its labels equal to the plain version's there and at
     p4, p3_480p, M=40, an unaligned 17x29 -> 67x115 and with a batch
     element that has no valid slot, f32 and bf16 logits; B3 at
     B=16/P=4096, unaligned and p4 sizes; B4 multi-level
     (one launch per head) at the detector's 256x448 pyramid with K=128
     boxes for the 7x7 box head and the 14x14 mask head, timed per head and
     per image, plus the single-level form on every level (border and
     sub-pixel boxes included), 7x7 and 14x14, checked only;
  4. drive the p3_multi_object streaming path at full width (ResNet-50,
     256x448, M=16, N=128, B=4, K=8, three chunks; seeded random weights)
     through InferenceEngine.run_stream_chunked with every launch counter
     set to 0 just before and read just after;
  4b. drive the detector path: the full-width Mask R-CNN (R-50-FPN, 81
     classes, 256x448, pre/post/max 256/128/128, float32, seeded random
     weights, score_thresh 0) on every frame of one K=8 chunk of B=4 noise
     sequences, its detections fed as compact proposals into the same p3
     engine; counters set to 0 just before and read just after; then one
     detector image under torch.profiler;
  5a. the legacy decoder (decoder_variant=legacy) at full p3 width through
     InferenceEngine.run_sequence_chunked: full-grid uint8 proposals, B=2,
     K=8, T=16; B1 and B2 exactly once per frame step; one profiled chunk;
  5b. the Hungarian decode (p3, shared decoder) through run_sequence, B=2,
     T=4: X one-hot, no proposal used twice, B1 and B2 once per step, the
     host time of the scipy decode;
  5c. the PGD solver (p3, unfused matcher) through run_sequence, B=2, T=4:
     rows sum to 1, columns at most 1, no B1 launch (B2 resolves labels);
  5d. the git-tracked checkpoint, read with the port's own msgpack reader,
     on 8 synthetic videos, as saved (no kernel) and on the kernels (B1, B2
     once per step): J&F > 0.85 and within 0.01 of the JAX package's; the
     as-saved run against the CPU on two videos; infer_torch.py on a
     DAVIS-layout tree;
  6. YouTube-VOS serving through its files and entry points, each tree
     written to a temporary directory with PNG frames (no JPEG codec in
     play): (6a) tools/extract_proposals_torch.py --dataset ytvos at full
     width (R-50-FPN, 81 classes, 256x448, seeded random weights, score
     threshold 0) on 2 videos x 15 frames at 360x640, objects first
     annotated at frame 0 and at frame 5 or 10 with ids that are not
     contiguous, meta.json listing every 5th frame: one JSON per frame,
     each read back by YTVOSDataset, B4 twice per frame; (6b)
     infer_torch.py --preset p4_ytvos_stream --dataset ytvos on that cache
     (R-50 256x448, M=32, N=256, bf16, random weights): a complete
     submission tree at native size, B1 and B2 once per frame step, the
     frames/s inside the engine, one profiled chunk staged from the tree,
     and the chunk's parts (reader, stager, engine) timed one after
     another; (6c) the checkpoint through infer_torch.py --dataset ytvos on 4
     synthetic videos (T=15, one object appearing mid-video, a stem-keyed
     cache from the ground truth), as saved and on the kernels, scored by
     eval/ytvos_local: G within 0.01 of the JAX package's (`JAX_YTVOS_G`,
     recomputed by tests/test_torch_port_ytvos.py), and one video on the
     card against the CPU;
  7. training: (7a) B1' (the fused matcher's autograd.Function: B1's
     kernel forward, B1''s two kernels, the sweep and the tail, and four
     products) at p5_train's shapes and epsilon 0.03 and at p3's and p4's
     M, N at 0.05, X and all five gradients against autograd through the
     plain version and the explicit plain backward on the card, two
     backwards bit-equal, one counted launch per backward, with the device
     ms of the backward and of each kernel, the old route's (autograd
     through the plain version) and the bound; (7b) train_torch.py --preset p5_train --set
     matching.use_pallas=true at full width (R-50 256x448 bf16 backbone,
     M=8, N=64, B=4 clips of T=4, seeded random weights) on a DAVIS-layout
     tree written to a temporary directory, 6 steps with the counters set
     to 0 just before and read just after (B1 and B1' launches and B1'
     backward calls exactly steps x T),
     loss and grad_norm finite, ms per step, one profiled step, peak
     memory, 2 steps with remat (lower peak, the same step-1 loss), and the
     checkpoint served by infer_torch.py --ckpt on the tree's val split;
     (7c) 3 train steps from the git-tracked checkpoint, as saved and on
     the kernel, against the JAX package's (JAX_TRAIN_STEPS, recomputed by
     tests/test_torch_port_train_ckpt.py) and the card's CPU to 1e-4;
     (7d) examples/train_and_eval_synthetic_torch.py at its defaults (from
     scratch, then the engine and J&F on 16 held-out videos), with and
     without the kernel, each over the example's own --min-jf gate and
     under a bound on the last step's loss;
  8. run a small float32 configuration on the card and on the CPU (plain
     versions only) with the same weights and inputs, and compare; the
     same for a small detector (R-18, 64x128, 8 classes);
  9. the detector's training, scoring, the full system and DCNv2: (9a) B4'
     (multilevel_roi_align's autograd.Function: B4's kernel forward, B4''s
     kernel backward) on a 256x448 R-50-FPN pyramid at K=32 and K=128, both
     heads, forward and the four level gradients against autograd through
     the plain version and the explicit plain backward, two backwards
     bit-equal, one counted launch per backward (its two kernels, the
     per-box prep and the gather), device ms per backward and per kernel
     beside the old route's; (9b) train_proposal_torch.py at full width (R-50-FPN, 81
     classes, 256x448, batch 2, 8 steps, seeded random weights) with B4 and
     B4' 2 x batch launches and B4' 2 x batch backward calls per step, every loss
     part finite, ms per step, peak memory, one profiled step, and the saved
     file served by tools/extract_proposals_torch.py --params; (9c) the
     small detector's 3 train steps against the JAX package's
     (JAX_PROPOSAL_STEPS, recomputed by
     tests/test_torch_port_detector_train.py) and the card's CPU to 1e-4;
     (9d) the learning proof: R-18 at 128x224 for 800 steps on synthetic
     detection frames, box and mask AP50 on 32 held-out frames over floors
     set by the JAX package's CPU runs; (9e)
     examples/full_system_synthetic_torch.py with the checkpoint and 9d's
     detector on 4 held-out videos, as saved and on the kernels: planted J&F
     against the JAX package's, detector recall and J&F over floors; (9f) a
     full-width DCNv2 detector (c3..c5) forward and train steps, and a small
     one card vs CPU;
  10. data parallelism (parallel/mesh.py), profiling, debug, the examples
     and the importers: (10a) a one-rank mesh over NCCL at full p5_train
     width (B1, B1'): its losses equal to the meshless step's and its
     gradients as close as meshless steps are to each other, ms per step
     of both; (10b) two ranks sharing the card over gloo at p5_train
     width (float32 backbone) and at a small width with train-mode BN,
     fused matcher and remat, the halves' valid counts unequal: loss, grad norm, every gradient and the BN statistics against
     one process on the whole batch; (10c) the p3 engine on two ranks at
     full width (B=4, K=8), its per-step logits, X and decided labels
     against phase 4's engine (LOGIT_REL, LABEL_TIE), and (in 5d)
     infer_torch.py --data-parallel, a one-rank NCCL mesh, giving the J&F
     of the same CLI without it; (10d) the R-50-FPN detector's train step
     at 256x448, batch 2, on two ranks (one image each) against one
     process; (10e) utils/profiling.trace around a p3 chunk naming B1's and
     B2's kernels, StageTimer, and utils/debug.checked on a NaN in B1's
     input; (10f) examples/train_synthetic_torch.py, infer_demo_torch.py,
     matcher_only_torch.py and train_and_eval_synthetic_torch.py --mrcnn on
     the card, and a seeded torchvision-layout Mask R-CNN state dict
     through tools/import_maskrcnn_weights_torch.py into the full-width
     detector's forward (B4). Two ranks on one card make no speed number.
  11. the native host path, the day-one drill, the artifact chain and the
     A/B tools: (11a, run on phase 6b's tree) a g++ -E probe of libjpeg's
     and libpng's headers; where they are present the image loader
     (csrc/host/imgloader.cpp) must build and be used, its frames within
     +-1 of PIL, labels equal at their own size, batches equal to
     one-by-one decodes; where not, the readers decode with PIL and say
     so; the C++ RLE codec against numpy on the cache CLI's masks; the p4
     reader's host ms per step with each decoder and codec that builds;
     (11b) infer_torch.py with the git-tracked checkpoint on the day-one
     tree (JPEG at the native 854x480, seed 7003, T=4, --chunk 4), as
     saved and on the kernels: chunked dispatch, J&F > 0.85 and within 0.01
     of the JAX package's (JAX_DAYONE_FALLBACK_JF); (11c)
     tools/regen_artifacts_torch.sh up to its drill at full width (R-18
     detector and R-50 DMM at 256x448, the full system), cut to 100
     detector and 10 DMM steps with the J&F gates off (CHAIN_KNOBS), in a
     copy of the files it reads: every stage exits 0 and writes its file,
     with each stage's ms per step, peak memory and B1/B1'/B4/B4' counts;
     then the drill's commands (flagship_drill) on those files, ungated;
     (11d)
     tools/ab_logits_res_torch.py on the checkpoint, tools/ab_480p_torch.py
     on 11c's files and the same 480x864 run on the kernels (B1, B2 and B4
     at 480x864 against their plain versions), and
     tools/ab_decoder_arch_torch.py with 2 variants.
  12. the bench tools and graft_entry_torch.py: (12a) bench_torch.py at
     p3 full width, B=16, K=16, 2 windows of 2 chunks (BENCH_ENV): its JSON
     line with this card's name and power limit, B1 within 1e-5 of the
     plain matcher (BENCH_PARITY; the bench's own is bench.py's 5e-3),
     frames/s > 0, the bf16-peak and memory-rate shares in
     (0, 100], B1 and B2 counted; (12b) each bench/*_torch.py tool once at
     a small setting (BENCH_TOOLS), the breakdown's device-time deltas
     none below -BREAKDOWN_NOISE_MS; (12c) graft_entry_torch.entry() run
     twice with its state fed back (B1, B2 once per step) and
     dryrun_multichip(2) on two ranks sharing the card over gloo.
  13. the JAX package's orbax checkpoints: the committed fixture
     (artifacts/orbax_jax_fixture/, written by the JAX package's
     Checkpointer: two runs, grad_accum 1 and 2, two steps each and an
     unfinished save) read by the port's own reader (OCDBT, zarr, zstd
     through the system's libzstd; no JAX, orbax or tensorstore here),
     every leaf bit-equal to digests.json, the host ms and MB/s of the
     read, the trees moved to the card and back unchanged, the CLIs' route
     (checkpoint_kind, latest_orbax_step, load_checkpoint's params of the
     latest step), and each run's optax state in the port's Optimizer
     taking its next update on the card, within ORBAX_UPDATE_REL of JAX's
     and of the CPU's.

PIL is required (phases 5d, 6, 7, 9 and 11 read and write image trees;
phase 6c reads with PIL, as the JAX package's reference was computed). Prints
one JSON line {"kernels": [...]} with each kernel's launches (on the p3
stream and the detector; ``launches_by_path`` for every path that runs it),
error, time, plain-version time and bound (the backward kernels B1' and
B4' have entries of their own, launched by the training paths; their
"plain" column is the old route, autograd through the plain version), then
the nvidia-smi line, then {"ok": true, "device": {...}} as the last line.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
B1_KERNELS = ("matcher_pool_kernel", "matcher_cost_kernel", "matcher_sinkhorn_kernel")
B2_KERNEL = "resolve_band_kernel"

# Phase 5d: the git-tracked checkpoint on 8 synthetic videos, run as saved and
# on the kernels. JAX_CKPT_JF is the JAX package's mean J&F (on the CPU) for
# the same sequences and settings; tests/test_torch_port_cli.py recomputes it.
CKPT = "artifacts/dmm128_fallback.msgpack"
CKPT_SEEDS = tuple(range(7003, 7011))
CKPT_RUNS = {"as_saved": {},
             "kernels": {"matching.use_pallas": True, "model.mask_res": "stride4",
                         "model.logits_res": "mask"}}
JAX_CKPT_JF = {"as_saved": 0.9517428566667083, "kernels": 0.9380313546158888}

# Phase 6: YouTube-VOS trees of synthetic videos. 6a/6b: 2 videos at 360x640,
# the last object of each first annotated at frame 5 or 10, meta.json every
# 5th frame. 6c: the checkpoint on 4 videos at 240x427 whose stems advance by
# 5 (as the release's valid split names its frames), every frame listed, and
# the last object appearing at frame 4-6. JAX_YTVOS_G is the JAX package's
# overall G (infer.py --dataset ytvos and its scorer, on the CPU) on 6c's
# tree; tests/test_torch_port_ytvos.py recomputes it.
P4_VIDEOS = dict(seeds=(7201, 7202), ids=((1, 3), (2, 5)), late=(5, 10), T=15,
                 hw=(360, 640), meta_every=5)
YTVOS_VIDEOS = dict(seeds=(7301, 7302, 7303, 7304),
                    ids=((1, 2), (1, 2, 3), (2, 4), (1, 3, 4)), late=(5, 4, 6, 5),
                    T=15, hw=(240, 427), stem_step=5)
YTVOS_CHUNK = 5
JAX_YTVOS_G = {"as_saved": 0.9119563155066384, "kernels": 0.9120987107961782}

# Phase 11: the day-one drill's tree (data/synthetic.write_native_davis_tree,
# JPEG frames at the native 854x480) and the JAX package's J&F of the
# fallback drill on it (infer.py --chunk 4 with its own native decode, on the
# CPU); tests/test_torch_port_dayone.py recomputes it.
DAYONE_TREE = dict(T=4, seeds=(7003,))
JAX_DAYONE_FALLBACK_JF = {"as_saved": 0.975638071596101, "kernels": 0.9760336387045565}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require_pil(what: str):
    """PIL's Image module; fatal when PIL is missing."""
    try:
        from PIL import Image
    except ImportError:
        fail(f"{what} needs PIL to read and write image trees")
    return Image


@contextlib.contextmanager
def plain_path(module):
    """``module`` (data/native_loader or ops/rle) on its plain path inside
    the block, PIL decode or numpy RLE: the pin the tests use, its ``_TRIED``
    and ``_LIB``."""
    saved = module._TRIED, module._LIB
    module._TRIED, module._LIB = True, None
    try:
        yield
    finally:
        module._TRIED, module._LIB = saved


def pil_decode():
    """The port's readers decode with PIL inside the block, as the JAX
    package's reference values of phase 6c were computed."""
    from dmm_net_tpu_torch.data import native_loader
    return plain_path(native_loader)


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


def device_ms(fn, inputs, iters: int, kernel_names):
    """Mean device time per call of the CUDA kernels whose names contain one
    of ``kernel_names`` (torch.profiler over ``iters`` calls), and that time
    by name; fatal when the profiler records no device time under one of
    the names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for a in inputs[:3]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        hit = [n for n in kernel_names if n in ev.key]
        if hit:
            us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
            per[hit[0]] = per.get(hit[0], 0.0) + us / 1e3 / iters
            log(f"  {hit[0]}: {us / 1e3 / iters:.4f} ms per call on the device")
    missing = [n for n in kernel_names if per.get(n, 0.0) <= 0]
    if missing:
        fail(f"torch.profiler recorded no device time for {missing}")
    return sum(per.values()), per


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
    from dmm_net_tpu_torch.kernels.matcher import pool_cost_match_ops
    pairs = int((rm[:, :, None] & cm[:, None, :]).sum().item())
    byts = nbytes(*args) + B * M * N * 4                    # + X written
    return byts, pool_cost_match_ops(B, M, N, P, D, Pc, iters, pairs)


def resolve_bound(logits, valid, H, W):
    """Only the valid slots' logits can change a label, so only they count."""
    from dmm_net_tpu_torch.kernels.resolve import resolve_upsample_ops
    B, M, h, w = logits.shape
    mv = int(valid.sum().item())                    # valid (b, m) slots
    byts = (mv * h * w * logits.element_size() + nbytes(valid)
            + B * H * W)                            # + uint8 labels written
    return byts, resolve_upsample_ops(mv, h, H, W), mv


def bound_ms(byts, ops):
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def check_matcher(name, shape, iters=30, timed=True, eps_init=None,
                  epsilon=0.05):
    import torch
    from dmm_net_tpu_torch.kernels.matcher import (fused_pool_cost_match,
                                                   pool_cost_match_plain)
    gen = torch.Generator(device="cuda").manual_seed(11)
    args = matcher_inputs(gen, *shape)
    got = fused_pool_cost_match(*args, epsilon=epsilon, iters=iters,
                                epsilon_init=eps_init)
    want = pool_cost_match_plain(*args, epsilon=epsilon, iters=iters,
                                 epsilon_init=eps_init)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rm, cm = args[5], args[6]
    pad_zero = bool((got[~rm] == 0).all() and (got.transpose(1, 2)[~cm] == 0).all())
    log(f"B1 fused_pool_cost_match {name} B,M,N,P,D,Pc={shape} "
        f"epsilon={epsilon} eps_init={eps_init} iters={iters}: max|dX|={err:.3e} (limit 2e-4), "
        f"padded entries zero={pad_zero}")
    if not (err <= 2e-4 and pad_zero and torch.isfinite(got).all()):
        fail(f"B1 disagrees with its plain version at {name}")
    if not timed:
        return None
    byts, ops = matcher_bound(args, iters)
    copies = [matcher_inputs(gen, *shape) for _ in range(copies_for(byts) - 1)]
    inputs = [args] + copies
    kernel = lambda *a: fused_pool_cost_match(*a, iters=iters)  # noqa: E731
    ms, per = device_ms(kernel, inputs, 100, B1_KERNELS)
    call = time_ms(kernel, inputs, 200)
    plain = time_ms(lambda *a: pool_cost_match_plain(*a, iters=iters), inputs, 20)
    b_ms, b_by = bound_ms(byts, ops)
    sink_iter = per.get("matcher_sinkhorn_kernel", float("nan")) / (iters + 1)
    log(f"B1 {name} time: kernel {ms:.4f} ms on the device ({call:.4f} ms per "
        f"wrapper call), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {byts / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP); Sinkhorn "
        f"{sink_iter * 1e3:.3f} us per iteration ({iters + 1} row passes)")
    return {"max_abs_err": err, "ms": ms, "call_ms": call, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "launch_ms": per,
            "sinkhorn_iter_ms": sink_iter}


def check_resolve(name, B, M, h, w, H, W, timed=False, dead=False):
    """B2 against its plain version, float32 and bfloat16 logits: labels
    must be equal (each product is of two bf16 values and each sum has at
    most two nonzero terms, so both round the same). ~75% valid slots whose
    invalid slots carry the largest logits; ``dead``: the last batch
    element has none valid."""
    import torch
    from dmm_net_tpu_torch.kernels.resolve import (fused_resolve_upsample,
                                                   resolve_upsample_plain)
    gen = torch.Generator(device="cuda").manual_seed(12)

    def make():
        lg = torch.randn(B, M, h, w, device="cuda", generator=gen) * 3.0
        v = torch.rand(B, M, device="cuda", generator=gen) > 0.25
        v[:, 0] = True
        if dead:
            v[-1] = False
        lg[~v] = 50.0                    # invalid slots carry the largest logits
        return [lg, v]

    args = make()
    err = mism_max = 0.0
    for dt in (torch.float32, torch.bfloat16):
        got = fused_resolve_upsample(args[0].to(dt), args[1], (H, W))
        want = resolve_upsample_plain(args[0].to(dt), args[1], (H, W))
        torch.cuda.synchronize()
        mism = (got != want).float().mean().item()
        err = max(err, (got.int() - want.int()).abs().max().item())
        mism_max = max(mism_max, mism)
        log(f"B2 fused_resolve_upsample {name} logits {dt} {tuple(args[0].shape)}"
            f" -> ({B}, {H}, {W}): label mismatch {mism:.3e} (must be 0), "
            f"labelled {(got > 0).float().mean().item():.3f}")
        if not torch.equal(got, want):
            fail(f"B2 labels differ from its plain version at {name} ({dt})")
        if dead and (got[-1] != 0).any():
            fail(f"B2 labelled pixels of a batch element with no valid slot ({name})")
    checked = {"max_abs_err": float(err), "mismatch_frac": mism_max}
    if not timed:
        return checked
    byts, ops, mv = resolve_bound(*args, H, W)
    inputs = [args] + [make() for _ in range(copies_for(byts) - 1)]
    kernel = lambda lg, v: fused_resolve_upsample(lg, v, (H, W))  # noqa: E731
    ms, _ = device_ms(kernel, inputs, 200, (B2_KERNEL,))
    call = time_ms(kernel, inputs, 500)
    plain = time_ms(lambda lg, v: resolve_upsample_plain(lg, v, (H, W)), inputs, 20)
    b_ms, b_by = bound_ms(byts, ops)
    log(f"B2 {name} time (f32 logits): kernel {ms:.4f} ms on the device "
        f"({call:.4f} ms per wrapper call), plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {byts / 1e6:.2f} MB with {mv} of {B * M} slots "
        f"valid, {ops / 1e9:.3f} GFLOP)")
    return {**checked, "ms": ms, "call_ms": call, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "valid_slots": mv}


def check_cost_match(name, shape, iters=30, timed=True):
    """B3 at (B, M, N, P, D): random binary masks, unit-variance features,
    ~80% valid rows and columns."""
    import torch
    from dmm_net_tpu_torch.kernels.matcher import (cost_match_plain,
                                                   fused_cost_match)
    B, M, N, P, D = shape
    gen = torch.Generator(device="cuda").manual_seed(13)

    def make():
        dev = "cuda"
        rm = torch.rand(B, M, device=dev, generator=gen) > 0.2
        rm[:, 0] = True
        return [(torch.rand(B, M, P, device=dev, generator=gen) > 0.7).float(),
                (torch.rand(B, N, P, device=dev, generator=gen) > 0.7).float(),
                torch.randn(B, M, D, device=dev, generator=gen),
                torch.randn(B, N, D, device=dev, generator=gen), rm,
                torch.rand(B, N, device=dev, generator=gen) > 0.2]

    args = make()
    got = fused_cost_match(*args, iters=iters)
    want = cost_match_plain(*args, iters=iters)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rm, cm = args[4], args[5]
    pad_zero = bool((got[~rm] == 0).all() and (got.transpose(1, 2)[~cm] == 0).all())
    log(f"B3 fused_cost_match {name} B,M,N,P,D={shape}: max|dX|={err:.3e} "
        f"(limit 1e-4), padded entries zero={pad_zero}")
    if not (err <= 1e-4 and pad_zero and torch.isfinite(got).all()):
        fail(f"B3 disagrees with its plain version at {name}")
    if not timed:
        return None
    pairs = int((rm[:, :, None] & cm[:, None, :]).sum().item())
    byts = nbytes(*args) + B * M * N * 4                    # + X written
    ops = (2 * B * M * N * P + B * (M + N) * P     # intersections + areas
           + 2 * B * M * N * D + 2 * B * (M + N) * D  # cosine + norms
           + 10 * (iters + 1) * pairs)              # Sinkhorn row/col LSEs
    inputs = [args] + [make() for _ in range(copies_for(byts) - 1)]
    kernel = lambda *a: fused_cost_match(*a, iters=iters)  # noqa: E731
    ms, _ = device_ms(kernel, inputs, 100, B1_KERNELS[1:])
    call = time_ms(kernel, inputs, 200)
    plain = time_ms(lambda *a: cost_match_plain(*a, iters=iters), inputs, 20)
    b_ms, b_by = bound_ms(byts, ops)
    log(f"B3 {name} time: kernel {ms:.4f} ms on the device ({call:.4f} ms per "
        f"wrapper call), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {byts / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
    return {"max_abs_err": err, "ms": ms, "call_ms": call, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by}


def detector_boxes(gen, K, H, W, device="cuda"):
    """K boxes in image coordinates: most inside the image, an eighth under
    one pixel wide and high (under one cell at every level), an eighth
    crossing the left and bottom edges, and one covering the whole image."""
    import torch
    dev = device
    xy = torch.rand(K, 2, device=dev, generator=gen) * torch.tensor([W, H], device=dev)
    wh = 1 + torch.rand(K, 2, device=dev, generator=gen) * torch.tensor(
        [W, H], device=dev) * 0.6
    b = torch.cat([xy - 0.2 * wh, xy + wh], 1)
    b[: K // 8, 2:] = b[: K // 8, :2] + 0.4
    b[K // 8: K // 4, 0] = -12.0
    b[K // 8: K // 4, 3] = H + 20.0
    b[-1] = torch.tensor([0.0, 0.0, W, H], device=dev)
    return b.contiguous()


def check_roi_align(level, out_size, K=128, C=256, image=(256, 448)):
    """B4's single-level form on one FPN level of the 256x448 detector at
    the detector's K and C (checked, not timed: the detector calls the
    multi-level form)."""
    import torch
    from dmm_net_tpu_torch.kernels.roi_align import roi_align
    from dmm_net_tpu_torch.ops.roi_pool import roi_align_mxu
    stride = 2 ** level
    H, W = -(-image[0] // stride), -(-image[1] // stride)
    gen = torch.Generator(device="cuda").manual_seed(20 + level)
    s, scale = 2, 1.0 / stride

    args = [torch.randn(C, H, W, device="cuda", generator=gen),
            detector_boxes(gen, K, *image)]
    got = roi_align(*args, out_size, s, scale)
    want = roi_align_mxu(*args, out_size, s, scale)
    name = f"p{level} {H}x{W} -> {out_size[0]}x{out_size[1]}"
    return roi_compare(f"B4 roi_align {name} K={K} C={C}", got, want)


def roi_compare(what, got, want):
    """max |d| and the excess over the limit 1e-4 + 1e-4 |want|; fatal above."""
    import torch
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = diff.max().item()
    excess = (diff - 1e-4 * want.abs()).max().item()
    log(f"{what}: max|d|={err:.3e}, max(|d| - 1e-4|want|)={excess:.3e} (limit 1e-4)")
    if not (excess <= 1e-4 and torch.isfinite(got).all()):
        fail(f"B4 disagrees with its plain version: {what}")
    return err


def pyramid(gen, C=256, image=(256, 448), device="cuda"):
    """Random FPN maps p2..p5 of an image, (C, ceil(H / 2**l), ceil(W / 2**l))."""
    import torch
    return [torch.randn(C, -(-image[0] // 2 ** l), -(-image[1] // 2 ** l),
                        device=device, generator=gen) for l in (2, 3, 4, 5)]


def check_multilevel(head, out_size, K=128, C=256, image=(256, 448), timed=True):
    """B4 as the detector calls it: one launch per head, each box on its own
    level of the 256x448 pyramid, K boxes of every size (so every level is
    taken), C=256."""
    import torch
    from dmm_net_tpu_torch.kernels.roi_align import (fpn_levels,
                                                     multilevel_roi_align,
                                                     multilevel_roi_align_plain)
    gen = torch.Generator(device="cuda").manual_seed(30 + out_size[0])
    s = 2

    def make():
        return [pyramid(gen, C, image), detector_boxes(gen, K, *image)]

    args = make()
    got = multilevel_roi_align(*args, out_size, s)
    want = multilevel_roi_align_plain(*args, out_size, s)
    per_level = torch.bincount(fpn_levels(args[1]), minlength=4).tolist()
    name = f"{head} head -> {out_size[0]}x{out_size[1]}"
    err = roi_compare(f"B4 multilevel_roi_align {name} K={K} C={C} boxes per "
                      f"level p2..p5 {per_level}", got, want)
    if not timed:
        return err
    oh, ow = out_size
    byts = nbytes(*args[0], args[1]) + K * C * oh * ow * 4   # pyramid once + output
    ops = 10 * K * C * oh * ow * s * s                        # 4 taps, 3 lerps per sample
    inputs = [args] + [make() for _ in range(copies_for(byts) - 1)]
    kernel = lambda lv, b: multilevel_roi_align(lv, b, out_size, s)  # noqa: E731
    ms, _ = device_ms(kernel, inputs, 100, ("roi_align_kernel",))
    call = time_ms(kernel, inputs, 200)
    plain = time_ms(lambda lv, b: multilevel_roi_align_plain(lv, b, out_size, s),
                    inputs, 20)
    b_ms, b_by = bound_ms(byts, ops)
    log(f"B4 {name} time: kernel {ms:.4f} ms on the device ({call:.4f} ms per "
        f"wrapper call), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {byts / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
    return {"max_abs_err": err, "ms": ms, "call_ms": call, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by}


# ---------------------------------------------------------------------------
# phase 4/5: the streaming path
# ---------------------------------------------------------------------------

def disk_templates(rng, B, M, H, W, n_valid):
    """Frame-1 template masks (disks), n_valid[b] valid slots from 0."""
    yy, xx = np.mgrid[:H, :W]
    tmpl = np.zeros((B, M, H, W), np.float32)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        valid[b, :n_valid[b]] = True
        for m in range(n_valid[b]):
            cy, cx = rng.randint(H // 8, H - H // 8), rng.randint(W // 8, W - W // 8)
            r2 = (rng.uniform(0.03, 0.15) * min(H, W)) ** 2
            tmpl[b, m] = ((yy - cy) ** 2 + (xx - cx) ** 2) < r2
    return tmpl, valid


def make_stream(seed, T, B, M, N, H, W, n_valid):
    """Host-side inputs as a proposal cache would give them: uint8 frames,
    boxes + 28x28 box-local masks, frame-1 template masks (disks)."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (T, B, H, W, 3)).astype(np.uint8)
    tmpl, valid = disk_templates(rng, B, M, H, W, n_valid)
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
    for k in ("fused_pool_cost_match", "fused_resolve_upsample"):
        if counts[k] < T:
            fail(f"kernel {k} launched {counts[k]} times in {T} frame steps")
    labelled = float((labels > 0).mean())
    log(f"main path: {T} frame steps x B={B} in {secs:.3f} s -> "
        f"{T * B / secs:.1f} frames/s ({T / secs:.2f} frame steps/s), "
        f"launches {counts}, max|rowsum-1|={row_err:.2e}, "
        f"labelled pixels {labelled:.3f}")
    profile_chunk(engine, items[:K], tmpl, valid, frames[0], K)
    return counts, T * B / secs, engine


def profile_chunk(engine, items, tmpl, valid, frame0, K):
    """One more chunk under torch.profiler (see ``profiled``)."""
    profiled(f"profiled chunk ({K} frame steps)", "step", K,
             lambda: engine.run_stream_chunked(iter(items), tmpl, valid,
                                               frame0, chunk=K))


def profiled(what, unit, n, fn, ranges=""):
    """Run ``fn`` once under torch.profiler: device busy share (kernel time
    over wall time; kernels on one stream do not overlap, so only a staged
    stream, whose copies run on a stream of their own, can overlap them),
    pinned and pageable host-to-device copy time, device time by
    kernel category and the kernels that take the most of it, per ``unit``
    (``n`` of them in the run). With ``ranges``, also the device time of
    the record_function ranges whose names start with it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name: dict = {}
    per_range: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or (
                    ranges and e.name.startswith(ranges)):
                continue        # a range's span on the device timeline, not a kernel
            n_kernels += 1
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        elif ranges and e.name.startswith(ranges):
            us = (e.device_time_total if hasattr(e, "device_time_total")
                  else e.cuda_time_total)
            dev_us, host_us = per_range.get(e.name, (0.0, 0.0))
            per_range[e.name] = (dev_us + us, host_us + e.cpu_time_total)
    busy = max(sum(per_name.values()), 1e-9)
    log(f"{what}: wall {wall_us / 1e3:.2f} ms, device kernels {busy / 1e3:.2f} ms "
        f"in {n_kernels} launches -> device busy {busy / wall_us:.3f}, "
        f"idle {1 - busy / wall_us:.3f}")
    per_cat: dict = {}
    for name, us in per_name.items():
        per_cat[kernel_category(name)] = per_cat.get(kernel_category(name), 0.0) + us
    for cat, us in sorted(per_cat.items(), key=lambda kv: -kv[1]):
        log(f"  {us / 1e3 / n:8.4f} ms/{unit} {us / busy:6.3f}  [{cat}]")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / 1e3 / n:8.4f} ms/{unit} {us / busy:6.3f}  {name[:110]}")
    for name, (us, host) in sorted(per_range.items(), key=lambda kv: -kv[1][0]):
        log(f"  {us / 1e3 / n:8.4f} ms/{unit} {us / busy:6.3f}  range {name} "
            f"(host {host / 1e3 / n:.4f} ms, {host / wall_us:.3f} of wall)")
    copy_ms = {kind: sum(us for name, us in per_name.items()
                         if "Memcpy HtoD" in name and kind in name) / 1e3
               for kind in ("Pinned", "Pageable")}
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle": 1 - busy / wall_us, "pinned_copy_ms": copy_ms["Pinned"],
            "pageable_copy_ms": copy_ms["Pageable"],
            "ranges_ms": {k: {"device": d / 1e3, "host": h / 1e3}
                          for k, (d, h) in per_range.items()},
            "categories_ms": {k: v / 1e3 for k, v in per_cat.items()}}


def kernel_category(name: str) -> str:
    n = name.lower()
    if "memcpy" in n or "memset" in n:
        return "host/device copies"
    if any(k in name for k in B1_KERNELS + (B2_KERNEL,)):
        return "port CUDA kernels B1+B2"
    if "roi_align_kernel" in name:
        return "port CUDA kernel B4 (ROI-Align)"
    if "upsample" in n:
        return "resize (antialiased bilinear)"
    if any(k in n for k in ("conv", "cudnn", "xmma", "gemm", "cutlass",
                            "nhwc", "nchw", "sm90")):
        return "convolution / matmul (cuDNN, cuBLAS)"
    if "reduce" in n:
        return "reductions"
    return "elementwise / casts / copies"


# ---------------------------------------------------------------------------
# phases 5a-5d: the legacy decoder, the Hungarian decode, PGD, the checkpoint
# ---------------------------------------------------------------------------

def full_grid_stream(seed, T, B, M, N, H, W, n_valid):
    """uint8 frames, binary full-grid proposal boxes (T, B, N, H, W) as
    uint8 (0/1 exact, taken unchanged by both packages), disk templates."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (T, B, H, W, 3)).astype(np.uint8)
    tmpl, valid = disk_templates(rng, B, M, H, W, n_valid)
    y0 = rng.randint(0, H - 16, (T, B, N))
    x0 = rng.randint(0, W - 16, (T, B, N))
    y1 = y0 + 8 + rng.randint(0, H // 3, (T, B, N))
    x1 = x0 + 8 + rng.randint(0, W // 3, (T, B, N))
    rows = (np.arange(H) >= y0[..., None]) & (np.arange(H) < y1[..., None])
    cols = (np.arange(W) >= x0[..., None]) & (np.arange(W) < x1[..., None])
    props = (rows[..., :, None] & cols[..., None, :]).view(np.uint8)
    pvalid = rng.rand(T, B, N) > 0.15
    return frames, props, pvalid, tmpl, valid


def check_assignments(what, X, valid, pvalid, row_tol, one_hot=False):
    """X (T, B, M, N): valid rows sum to 1, padded rows (``valid`` (B, M))
    and padded columns (``pvalid`` (T, B, N)) exactly 0; with ``one_hot``,
    each valid row a single 1 and no proposal used twice in a frame. Returns
    the largest row error and column sum."""
    if not np.isfinite(X).all():
        fail(f"{what}: X not finite")
    row_err = float(np.abs(X.sum(-1)[:, valid] - 1.0).max())
    col_max = float(X.sum(-2).max())
    padded_cols = np.swapaxes(X, -1, -2)[~pvalid]
    if row_err > row_tol or (X[:, ~valid] != 0).any() or (padded_cols != 0).any():
        fail(f"{what}: valid rows sum to 1 +- {row_err:.2e} (limit {row_tol}) "
             "or padded rows or columns not exactly 0")
    if one_hot and not (set(np.unique(X).tolist()) <= {0.0, 1.0}
                        and col_max <= 1.0):
        fail(f"{what}: X is not one-hot, or a proposal is used twice")
    return row_err, col_max


def expect_launches(what, counts, want):
    """The launch counts of the kernels named in ``want`` in a run must be
    exactly ``want``."""
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")
    return got


def legacy_path():
    """Phase 5a: the legacy decoder at full p3 width through
    run_sequence_chunked (full-grid masks, B=2, K=8, T=16)."""
    import torch
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg = preset("p3_multi_object").override(**{"model.decoder_variant": "legacy"})
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals
    B, K, T = 2, 8, 16
    engine = InferenceEngine(cfg, seed=0)
    frames, props, pvalid, tmpl, valid = full_grid_stream(7, T, B, M, N, H, W,
                                                          [16, 6])
    log(f"legacy path: {cfg.name} decoder_variant=legacy decoder_dim="
        f"{cfg.model.decoder_dim} {cfg.model.backbone} {H}x{W} M={M} N={N} B={B} "
        f"K={K} T={T}; full-grid uint8 proposals")
    run = lambda t: engine.run_sequence_chunked(  # noqa: E731
        frames[:t], props[:t], pvalid[:t], tmpl, valid, chunk=K)
    run(K)                      # warm-up (cuDNN plans, allocator); not counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run(T)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = expect_launches("legacy path", launch_counts(),
                               {"fused_pool_cost_match": T,
                                "fused_resolve_upsample": T})
    labels, X = out["labels"], out["assignments"]
    if labels.shape != (T, B, H, W) or labels.dtype != np.uint8:
        fail(f"legacy labels {labels.shape} {labels.dtype}")
    row_err, _ = check_assignments("legacy path", X, valid, pvalid, 1e-3)
    log(f"legacy path: {T} frame steps x B={B} in {secs:.3f} s -> "
        f"{T / secs:.2f} frame steps/s ({secs / T * 1e3:.2f} ms per step), "
        f"launches {launches}, max|rowsum-1|={row_err:.2e}")
    prof = profiled(f"profiled legacy chunk ({K} frame steps)", "step", K,
                    lambda: run(K))
    log(f"legacy path: {prof['busy_ms'] / K:.3f} ms of device time per frame "
        f"step (profiled chunk)")
    return launches, {"ms_per_step": secs / T * 1e3,
                      "device_ms_per_step": prof["busy_ms"] / K,
                      "idle": prof["idle"]}


def run_sequence_phase(what, sets, b1_per_step):
    """Phases 5b and 5c: p3_multi_object with ``sets`` through run_sequence
    on full-grid items (shared decoder, B=2, T=4). B1 must launch
    ``b1_per_step`` times and B2 once per frame step. Returns the engine,
    its output, the template and proposal masks, the launches and the ms
    per frame step."""
    import torch
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts

    B, T = 2, 4
    cfg = preset("p3_multi_object").override(**sets)
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals
    frames, props, pvalid, tmpl, valid = full_grid_stream(8, T, B, M, N, H, W,
                                                          [12, 5])
    items = [{"frame": frames[t], "prop_masks": props[t], "prop_valid": pvalid[t]}
             for t in range(T)]
    engine = InferenceEngine(cfg, seed=0)
    engine.run_sequence(iter(items[:1]), tmpl, valid, frames[0])  # warm-up
    torch.cuda.synchronize()
    engine.hungarian_host_s = 0.0
    reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.run_sequence(iter(items), tmpl, valid, frames[0])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / T * 1e3
    launches = expect_launches(what, launch_counts(),
                               {"fused_pool_cost_match": b1_per_step * T,
                                "fused_resolve_upsample": T})
    if out["labels"].shape != (T, B, H, W):
        fail(f"{what}: labels {out['labels'].shape}")
    return engine, out, valid, pvalid, launches, ms


def hungarian_path():
    """Phase 5b: the Hungarian decode (soft X on the card, scipy on the host,
    the one-hot X decoded on the card)."""
    engine, out, valid, pvalid, launches, ms = run_sequence_phase(
        "hungarian path", {"matching.decode": "hungarian"}, 1)
    T = out["labels"].shape[0]
    row_err, _ = check_assignments("hungarian path", out["assignments"], valid,
                                   pvalid, 0.0, one_hot=True)
    scipy_ms = engine.hungarian_host_s / T * 1e3
    log(f"hungarian path: {T} frame steps x B=2 -> {ms:.2f} ms per frame step; "
        f"launches {launches}; max|rowsum-1|={row_err:.2e}; scipy decode "
        f"{scipy_ms:.3f} ms of host time per frame step")
    return {"launches": launches, "ms_per_step": ms, "scipy_ms_per_step": scipy_ms}


def pgd_path():
    """Phase 5c: the PGD solver (unfused matcher, so B1 never launches)."""
    _, out, valid, pvalid, launches, ms = run_sequence_phase(
        "pgd path", {"matching.solver": "pgd", "matching.use_pallas": False}, 0)
    T = out["labels"].shape[0]
    row_err, col_max = check_assignments("pgd path", out["assignments"], valid,
                                         pvalid, 1e-4)
    if col_max > 1.0 + 1e-4:
        fail(f"pgd path: a column sums to {col_max:.6f} (> 1 + 1e-4)")
    log(f"pgd path: {T} frame steps x B=2 -> {ms:.2f} ms per frame step; "
        f"launches {launches}; max|rowsum-1|={row_err:.2e}; max column sum "
        f"{col_max:.6f}")
    return {"launches": launches, "ms_per_step": ms}


def ckpt_path():
    """Phase 5d: the git-tracked checkpoint, read by the port's own msgpack
    reader, on phase 5d's 8 synthetic videos (T=8 at the model size, B=8,
    chunks of 8): (i) as saved, which runs no kernel; (ii) on the kernels
    (B1 and B2 once per frame step). Each J&F must pass 0.85 and lie within
    0.01 of the JAX package's; B1 and B2 are held against their plain
    versions at run (ii)'s shapes; both runs on two videos on the CPU must
    label the same pixels and give the same X."""
    import torch
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmm_net_tpu_torch.models.dmm import mask_hw
    from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt

    cfg0, variables = load_msgpack_ckpt(str(ROOT / CKPT))
    H, W = cfg0.model.image_size
    M, N = cfg0.matching.max_templates, cfg0.matching.max_proposals
    frames, items, tmpl, valid, gt = ckpt_inputs(M, N, H, W)
    T = frames.shape[0]
    log(f"checkpoint path: {CKPT} ({cfg0.model.backbone} {H}x{W} M={M} N={N} "
        f"decoder_obj_fine_level={cfg0.model.decoder_obj_fine_level!r}); "
        f"{len(CKPT_SEEDS)} synthetic videos x T={T}")
    jf, launches, outs = {}, {}, {}
    for run, sets in CKPT_RUNS.items():
        engine = InferenceEngine(cfg0.override(**sets), variables=variables)
        engine.run_stream_chunked(iter(items[:2]), tmpl, valid, frames[0], chunk=8)
        torch.cuda.synchronize()                   # warm-up; not counted
        reset_launch_counts()
        outs[run] = engine.run_stream_chunked(iter(items), tmpl, valid,
                                              frames[0], chunk=8)
        n = 0 if run == "as_saved" else T
        launches[run] = expect_launches(f"checkpoint {run}", launch_counts(),
                                        {"fused_pool_cost_match": n,
                                         "fused_resolve_upsample": n})
        jf[run] = mean_jf(outs[run]["labels"], gt)
    log("checkpoint J&F: " + ", ".join(
        f"{run} {jf[run]:.4f} (JAX package {JAX_CKPT_JF[run]:.4f})" for run in jf))
    for run in jf:
        if not (jf[run] > 0.85 and abs(jf[run] - JAX_CKPT_JF[run]) <= 0.01):
            fail(f"checkpoint {run}: J&F {jf[run]:.4f}, needs > 0.85 and within "
                 f"0.01 of {JAX_CKPT_JF[run]:.4f}")
    # B1 and B2 against their plain versions at the kernel run's shapes
    kcfg = cfg0.override(**CKPT_RUNS["kernels"])
    B, D = len(CKPT_SEEDS), kcfg.model.feature_dim
    P = (H // 16) * (W // 16)                      # emb is c4, stride 16
    Pc = int(np.prod(kcfg.cost.mask_size))
    check_matcher("checkpoint", (B, M, N, P, D, Pc), timed=False,
                  iters=kcfg.matching.sinkhorn_iters,
                  epsilon=kcfg.matching.epsilon)
    check_resolve("checkpoint", B, M, *mask_hw(kcfg), H, W)
    # both runs on two of the videos on the CPU (plain versions throughout)
    for run, sets in CKPT_RUNS.items():
        cpu = InferenceEngine(cfg0.override(**sets), variables=variables,
                              device="cpu").run_stream_chunked(
            iter([{k: v[:2] for k, v in it.items()} for it in items]),
            tmpl[:2], valid[:2], frames[0, :2], chunk=8)
        card = outs[run]
        mism = float((cpu["labels"] != card["labels"][:, :2]).mean())
        xerr = float(np.abs(cpu["assignments"] - card["assignments"][:, :2]).max())
        log(f"checkpoint {run}, card vs CPU on two videos: label mismatch "
            f"{mism:.3e} (limit 1e-3), max|dX| {xerr:.3e} (limit 2e-3)")
        if mism >= 1e-3 or xerr > 2e-3:
            fail(f"card and CPU disagree on the checkpoint run {run}")
    return jf, launches


def cli_on_card():
    """infer_torch.py on the card, on a 2-sequence DAVIS-layout tree written
    to a temporary directory (PIL writes and reads the tree); then (phase
    10c) the same with --data-parallel, a one-rank mesh over NCCL on the
    one card, which must give the same J&F."""
    import tempfile
    Image = require_pil("phase 5d")
    from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "DAVIS", Path(tmp) / "out"
        names = ["seq0", "seq1"]
        for name, seed in zip(names, CKPT_SEEDS):
            s = synthetic_sequence(seed=seed, T=6, H=240, W=427, num_objects=2,
                                   num_proposals=4)
            for sub in ("JPEGImages", "Annotations"):
                (root / sub / "480p" / name).mkdir(parents=True)
            for t in range(6):
                Image.fromarray((s["frames"][t] * 255).astype(np.uint8)).save(
                    root / "JPEGImages" / "480p" / name / f"{t:05d}.jpg",
                    quality=95)
                lab = np.zeros((240, 427), np.uint8)
                for m in range(2):
                    lab[s["gt_masks"][t, m] > 0.5] = m + 1
                Image.fromarray(lab).save(
                    root / "Annotations" / "480p" / name / f"{t:05d}.png")
        (root / "ImageSets" / "2017").mkdir(parents=True)
        (root / "ImageSets" / "2017" / "val.txt").write_text("\n".join(names))
        summaries = {}
        for flag in ((), ("--data-parallel",)):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, str(ROOT / "infer_torch.py"),
                                "--ckpt", str(ROOT / CKPT), "--davis-root",
                                str(root), "--out", str(out / str(len(flag))),
                                "--device", "cuda", *flag],
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                fail(f"infer_torch.py {' '.join(flag)} failed on the card: "
                     f"{r.stderr[-2000:]}")
            summary = json.loads((out / str(len(flag)) / "results.json")
                                 .read_text())
            summaries[flag] = summary
            log(f"infer_torch.py {' '.join(flag)} on the card: 2 sequences x 6 "
                f"frames at 427x240 native, J&F {summary['J&F']:.4f}, "
                f"{summary['fps']:.1f} frames/s inside the engine, "
                f"data_parallel {summary['data_parallel']}, "
                f"{time.perf_counter() - t0:.1f} s for the command")
    summary, dp = summaries[()], summaries[("--data-parallel",)]
    if not summary["J&F"] > 0.85:
        fail(f"infer_torch.py on the card: J&F {summary['J&F']:.4f} <= 0.85")
    # 10c: --data-parallel on the one card is a one-rank NCCL mesh; each
    # sequence runs alone through the same engine, so the scores are equal
    if dp["J&F"] != summary["J&F"] or dp["data_parallel"] != 1:
        fail(f"10c: infer_torch.py --data-parallel J&F {dp['J&F']} "
             f"(data_parallel {dp['data_parallel']}) != {summary['J&F']}")
    return summary["J&F"]


def ckpt_inputs(M, N, H, W, T=8, seeds=CKPT_SEEDS):
    """Phase 5d's videos: one synthetic sequence per seed (2 objects, N
    proposals), rendered at the model size and batched along B. Returns
    frames (T, B, H, W, 3) float32, full-grid items, templates (B, M, H, W)
    padded to M, valid (B, M) and ground-truth labels (B, T, H, W)."""
    from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
    seqs = [synthetic_sequence(seed=s, T=T, H=H, W=W, num_objects=2,
                               num_proposals=N) for s in seeds]
    frames = np.stack([s["frames"] for s in seqs], 1)
    tmpl = np.zeros((len(seqs), M, H, W), np.float32)
    valid = np.zeros((len(seqs), M), bool)
    gt = np.zeros((len(seqs), T, H, W), np.uint8)
    for b, s in enumerate(seqs):
        tmpl[b, :2] = s["tmpl_masks"]
        valid[b, :2] = True
        for m in range(2):
            gt[b][s["gt_masks"][:, m] > 0.5] = m + 1
    items = [{"frame": frames[t],
              "prop_masks": np.stack([s["prop_masks"][t] for s in seqs]),
              "prop_valid": np.stack([s["prop_valid"][t] for s in seqs])}
             for t in range(T)]
    return frames, items, tmpl, valid, gt


def mean_jf(labels, gt):
    """Mean J&F over the batch: labels (T, B, H, W), gt (B, T, H, W)."""
    from dmm_net_tpu_torch.eval.davis_jf import evaluate_sequence
    return float(np.mean([evaluate_sequence(gt[b], labels[:, b],
                                            object_ids=[1, 2])["J&F"]
                          for b in range(gt.shape[0])]))


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


# ---------------------------------------------------------------------------
# phase 4b: the detector path, frames -> Mask R-CNN -> compact proposals -> DMM
# ---------------------------------------------------------------------------

def detector_path(engine):
    """Full-width detector on every frame of one K=8 chunk of B=4 uint8
    noise sequences; its detections go as compact proposals into the p3
    engine (the production two-stage topology)."""
    import torch
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmm_net_tpu_torch.models.proposal import MaskRCNN

    cfg = engine.cfg
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals
    B, K = 4, 8
    det = MaskRCNN(image_size=(H, W), backbone_name="resnet50", num_classes=81,
                   pre_nms_top_n=256, post_nms_top_n=128, max_detections=N,
                   score_thresh=0.0, seed=0, device="cuda")
    log(f"detector path: Mask R-CNN R-50-FPN float32 {H}x{W}, 81 classes, "
        f"pre/post/max {det.pre_nms_top_n}/{det.post_nms_top_n}/"
        f"{det.max_detections}, score_thresh 0; B={B} sequences x K={K} frames")
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, (K, B, H, W, 3)).astype(np.uint8)
    tmpl, valid = disk_templates(rng, B, M, H, W, [16, 12, 7, 3])

    def image(f):               # uint8 (H, W, 3) -> (1, 3, H, W) in [0, 1]
        return (torch.from_numpy(f).to("cuda").permute(2, 0, 1)[None].float()
                / 255.0)

    det(image(frames[0, 0]))    # warm-up (cuDNN plans, allocator); not counted
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [[det(image(frames[t, b])) for b in range(B)] for t in range(K)]
    torch.cuda.synchronize()
    det_ms = (time.perf_counter() - t0) * 1e3 / (K * B)
    items = []
    for t in range(K):
        o = {k: torch.stack([outs[t][b][k] for b in range(B)]).cpu().numpy()
             for k in outs[t][0]}
        for k, v in o.items():
            if not np.isfinite(v.astype(np.float32)).all():
                fail(f"detector output {k} at frame {t} is not finite")
        bx = o["boxes"]
        if (bx[..., 0] < 0).any() or (bx[..., 1] < 0).any() or \
                (bx[..., 2] > W).any() or (bx[..., 3] > H).any():
            fail(f"detector boxes outside the {H}x{W} image at frame {t}")
        if not o["valid"].any(axis=1).all():
            fail(f"a frame at t={t} has no valid detection")
        items.append({"frame": frames[t], "prop_boxes": o["boxes"],
                      "prop_masks28": o["masks"], "prop_valid": o["valid"]})
    n_valid = [int(it["prop_valid"].sum()) for it in items]
    out = engine.run_stream_chunked(iter(items), tmpl, valid, frames[0], chunk=K)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()

    labels, X = out["labels"], out["assignments"]
    if labels.shape != (K, B, H, W) or labels.dtype != np.uint8:
        fail(f"labels {labels.shape} {labels.dtype}, expected {(K, B, H, W)} uint8")
    if not np.isfinite(X).all() or (X[:, ~valid] != 0).any():
        fail("assignments from detector proposals not finite, or padded rows not 0")
    calls = K * B
    if counts["roi_align"] != 2 * calls:
        fail(f"roi_align launched {counts['roi_align']} times in {calls} "
             f"detector calls, expected {2 * calls} (one per head)")
    for k in ("fused_pool_cost_match", "fused_resolve_upsample"):
        if counts[k] < K:
            fail(f"kernel {k} launched {counts[k]} times in {K} frame steps")
    log(f"detector path: {calls} detector images at {det_ms:.2f} ms each, "
        f"valid detections per frame (of {N} per image x {B}) {n_valid}; "
        f"with the DMM chunk {secs:.3f} s; launches {counts}; labelled pixels "
        f"{float((labels > 0).mean()):.4f}")
    prof = profiled("profiled detector image", "image", 1,
                    lambda: det(image(frames[1, 1])), ranges="detector/")
    return counts, det_ms, prof


def small_detector_reference():
    """A small float32 detector on the card (B4 kernel, cuDNN) and on the
    CPU (plain versions), same weights and image."""
    import torch
    from dmm_net_tpu_torch.models.proposal import MaskRCNN
    small = dict(image_size=(64, 128), backbone_name="resnet18", num_classes=8,
                 pre_nms_top_n=32, post_nms_top_n=16, max_detections=8, seed=5)
    img = np.random.RandomState(6).rand(1, 3, 64, 128).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        det = MaskRCNN(**small, device=dev)
        outs[dev] = {k: v.cpu().numpy()
                     for k, v in det(torch.from_numpy(img).to(dev)).items()}
    a, b = outs["cuda"], outs["cpu"]
    errs = {k: float(np.abs(a[k] - b[k]).max()) for k in ("boxes", "scores", "masks")}
    same = bool((a["valid"] == b["valid"]).all() and (a["classes"] == b["classes"]).all())
    log(f"small detector reference (R-18 64x128, 8 classes, 32/16/8): card vs "
        f"CPU valid/classes equal={same} ({int(b['valid'].sum())} valid), "
        f"max|d| boxes {errs['boxes']:.3e} (limit 1e-3), scores "
        f"{errs['scores']:.3e} (1e-4), masks {errs['masks']:.3e} (1e-4)")
    if not (same and b["valid"].any() and errs["boxes"] <= 1e-3
            and errs["scores"] <= 1e-4 and errs["masks"] <= 1e-4):
        fail("card and CPU disagree on the small detector")


# ---------------------------------------------------------------------------
# phase 6: YouTube-VOS serving, detector -> proposal cache -> stream -> tree
# ---------------------------------------------------------------------------

def write_ytvos_tree(root, seeds, ids, late, T, hw, stem_step=1, meta_every=1,
                     cache=None, num_proposals=8):
    """A YouTube-VOS-layout split ``<root>/valid`` of synthetic videos
    (data/synthetic.py), one per seed, with PNG frames at ``hw``. Video v
    holds the objects ``ids[v]``; its last object appears at frame
    ``late[v]`` (before it, painted out of the frames, the ground truth and
    the proposals), the others at frame 0. Annotations hold each object's
    first frame only (palette PNGs); meta.json lists each object's frames
    from its first, every ``meta_every``-th; stems advance by
    ``stem_step``. With ``cache``, a stem-keyed proposal cache of the
    synthetic proposals (RLE json, scores falling with the index).

    Returns the full ground truth {vid: {stem: (H, W) uint8}}, which the
    tree does not hold, and each object's first stem {vid: {oid: stem}}."""
    Image = require_pil("phase 6")
    from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.ops import rle
    H, W = hw
    split = Path(root) / "valid"
    meta, gts, firsts = {}, {}, {}
    for v, (seed, oids, t_late) in enumerate(zip(seeds, ids, late)):
        vid = f"vid{v}"
        s = synthetic_sequence(seed=seed, T=T, H=H, W=W, num_objects=len(oids),
                               num_proposals=num_proposals)
        stems = [f"{t * stem_step:05d}" for t in range(T)]
        appear = [0] * (len(oids) - 1) + [t_late]
        frames = (np.clip(s["frames"], 0, 1) * 255).astype(np.uint8)
        lab = np.zeros((T, H, W), np.uint8)
        for m, oid in enumerate(oids):          # later objects are drawn on top
            lab[appear[m]:][s["gt_masks"][appear[m]:, m] > 0.5] = oid
        for t in range(t_late):                 # the last object is not there yet
            hide = s["gt_masks"][t, -1] > 0.5
            frames[t][hide] = frames[t][(lab[t] == 0) & ~hide].mean(0)
            lab[t][hide] = 0
        (split / "JPEGImages" / vid).mkdir(parents=True)
        for t, stem in enumerate(stems):
            Image.fromarray(frames[t]).save(split / "JPEGImages" / vid / f"{stem}.png")
        for a in sorted(set(appear)):
            first = [oid for oid, t in zip(oids, appear) if t == a]
            InferenceEngine.write_png(np.where(np.isin(lab[a], first), lab[a], 0),
                                      str(split / "Annotations" / vid / f"{stems[a]}.png"))
        meta[vid] = {"objects": {str(oid): {"frames": [
            stems[t] for t in range(a, T, meta_every)]} for oid, a in zip(oids, appear)}}
        gts[vid] = dict(zip(stems, lab))
        firsts[vid] = {oid: stems[a] for oid, a in zip(oids, appear)}
        if cache is None:
            continue
        (Path(cache) / vid).mkdir(parents=True)
        for t, stem in enumerate(stems):
            props = []
            for n in np.flatnonzero(s["prop_valid"][t]):
                if t < t_late and n == s["gt_assignment"][t, -1]:
                    continue                    # the hidden object's proposal
                enc = rle.encode(s["prop_masks"][t, n] > 0.5)
                props.append({"score": float(1 - n / num_proposals),
                              "rle": {"size": [int(x) for x in enc["size"]],
                                      "counts": enc["counts"].decode("latin1")}})
            (Path(cache) / vid / f"{stem}.json").write_text(json.dumps(props))
    (split / "meta.json").write_text(json.dumps({"videos": meta}))
    return gts, firsts


def ytvos_g(sub_dir, gts, firsts) -> float:
    """Overall G (eval/ytvos_local) of a submission tree against the full
    ground truth, over the stems both hold."""
    Image = require_pil("phase 6")
    from dmm_net_tpu_torch.eval.ytvos_local import evaluate_video, summarize
    per_video = {}
    for vid, gt in gts.items():
        pred = {}
        for p in sorted((Path(sub_dir) / "Annotations" / vid).glob("*.png")):
            with Image.open(p) as im:
                pred[p.stem] = np.asarray(im)
        per_video[vid] = evaluate_video(gt, pred, firsts[vid])
    return summarize(per_video)["overall"]["G"]


def ckpt_sets(run):
    """CKPT_RUNS[run] as infer_torch.py --set arguments."""
    return [f"{k}={str(v).lower() if isinstance(v, bool) else v}"
            for k, v in CKPT_RUNS[run].items()]


def load_tool(name, folder="tools"):
    """A script under tools/ (or ``folder``) as a module (its main takes argv)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flagship_drill(dmm, mrcnn, tmp, device="cuda"):
    """docs/DAYONE_torch.md §1's commands on the drill's tree (the native
    854x480 tree of seed 7001, T=4): the cache tool with the detector file
    ``mrcnn``, then infer_torch.py with the DMM file ``dmm`` on that cache,
    scored at native resolution. Its results.json, and the shape of the
    first PNG written. tests/test_torch_port_dayone.py gates it."""
    import infer_torch
    from dmm_net_tpu_torch.data.synthetic import write_native_davis_tree
    from PIL import Image
    root = write_native_davis_tree(str(tmp / "DAVIS"), T=4)
    cache, out = str(tmp / "proposals"), str(tmp / "results")
    load_tool("extract_proposals_torch").main([
        "--dataset", "davis", "--root", root, "--out", cache,
        "--params", str(mrcnn), "--image-size", "256", "448",
        "--backbone", "resnet18", "--num-classes", "4", "--max-detections",
        "8", "--score-thresh", "0.05", "--device", device])
    summary = infer_torch.main(["--ckpt", str(dmm), "--davis-root", root,
                                "--proposal-dir", cache, "--out", out,
                                "--chunk", "4", "--device", device])
    with Image.open(Path(out) / "seq0" / "00000.png") as im:
        png_shape = np.asarray(im).shape
    return summary, png_shape


def extract_path(tmp):
    """Phase 6a: tools/extract_proposals_torch.py --dataset ytvos at full
    width on P4_VIDEOS; every frame gets a JSON that YTVOSDataset reads
    back, and B4 launches twice per frame."""
    import torch
    from dmm_net_tpu_torch.data.ytvos import YTVOSDataset
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts

    root, cache = tmp / "ytvos_p4", tmp / "props_p4"
    gts, firsts = write_ytvos_tree(root, **P4_VIDEOS)
    n = len(P4_VIDEOS["seeds"]) * P4_VIDEOS["T"]
    H0, W0 = P4_VIDEOS["hw"]
    log(f"extract path: tools/extract_proposals_torch.py --dataset ytvos, Mask R-CNN "
        f"R-50-FPN 81 classes 256x448 (defaults: max 64 detections), score "
        f"threshold 0, seeded random weights; {n} PNG frames at {H0}x{W0}")
    extract = load_tool("extract_proposals_torch")
    reset_launch_counts()
    t0 = time.perf_counter()
    extract.main(["--dataset", "ytvos", "--root", str(root), "--out", str(cache),
                  "--score-thresh", "0"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    if counts["roi_align"] != 2 * n:
        fail(f"extract path: roi_align launched {counts['roi_align']} times for "
             f"{n} frames, expected {2 * n} (one per head)")
    ds = YTVOSDataset(str(root), proposal_dir=str(cache), max_objects=32,
                      max_proposals=256)
    per_frame = []
    for vid in ds.videos:
        for fp in ds.frame_paths(vid):
            stem = Path(fp).stem
            pf = cache / vid / f"{stem}.json"
            if not pf.is_file():
                fail(f"extract path: no proposals written for {vid}/{stem}")
            props = json.loads(pf.read_text())
            _, valid = ds.load_proposals(vid, stem)
            if not props or int(valid.sum()) != min(len(props), 256):
                fail(f"extract path: {vid}/{stem}: {len(props)} proposals "
                     f"written, {int(valid.sum())} read back")
            per_frame.append(len(props))
    log(f"extract path: {n} frames in {secs:.2f} s ({secs / n * 1e3:.1f} ms per "
        f"frame: decode, detector, paste, RLE, json); proposals per frame "
        f"{min(per_frame)}-{max(per_frame)}; launches {counts}")
    return root, cache, counts, secs / n * 1e3


def ytvos_p4_path(tmp, root, cache):
    """Phase 6b: infer_torch.py --preset p4_ytvos_stream --dataset ytvos on
    phase 6a's cache (random weights): a complete submission tree at native
    size, B1 and B2 once per frame step; B1 and B2 against their plain
    versions at the stream's shapes; one chunk profiled, then its parts
    timed one after another."""
    import itertools
    import torch
    import infer_torch
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.data.pipeline import RingStager
    from dmm_net_tpu_torch.data.ytvos import YTVOSDataset
    from dmm_net_tpu_torch.infer.batching import batch_sequence_streams
    from dmm_net_tpu_torch.infer.engine import InferenceEngine, bucket_objects
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmm_net_tpu_torch.models.dmm import mask_hw
    Image = require_pil("phase 6")

    cfg = preset("p4_ytvos_stream")
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals
    steps = len(P4_VIDEOS["seeds"]) * P4_VIDEOS["T"]
    out = tmp / "sub_p4"
    log(f"ytvos p4 path: infer_torch.py --preset {cfg.name} --dataset ytvos "
        f"({cfg.model.backbone} {H}x{W} M={M} N={N} decoder={cfg.model.decoder_dtype} "
        f"masks={cfg.model.mask_dtype} mask_res={cfg.model.mask_res} "
        f"logits_res={cfg.model.logits_res}), random weights, {steps} frame steps")
    reset_launch_counts()
    t0 = time.perf_counter()
    summary = infer_torch.main(["--preset", cfg.name, "--dataset", "ytvos",
                                "--ytvos-root", str(root), "--proposal-dir", str(cache),
                                "--out", str(out), "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = expect_launches("ytvos p4 path", launch_counts(),
                               {"fused_pool_cost_match": steps,
                                "fused_resolve_upsample": steps})
    meta = json.loads((root / "valid" / "meta.json").read_text())["videos"]
    H0, W0 = P4_VIDEOS["hw"]
    n_png, labelled = 0, []
    for vid, ids in zip(sorted(meta), P4_VIDEOS["ids"]):
        stems = sorted({s for od in meta[vid]["objects"].values() for s in od["frames"]})
        got = sorted(p.stem for p in (out / "Annotations" / vid).glob("*.png"))
        if got != stems:
            fail(f"ytvos p4 path: {vid} submission stems {got}, meta.json lists {stems}")
        for stem in stems:
            with Image.open(out / "Annotations" / vid / f"{stem}.png") as im:
                lab = np.asarray(im)
            if lab.shape != (H0, W0) or not set(np.unique(lab).tolist()) <= {0, *ids}:
                fail(f"ytvos p4 path: {vid}/{stem}.png is {lab.shape} with values "
                     f"{np.unique(lab).tolist()}, expected {(H0, W0)} in {{0, {ids}}}")
            labelled.append(float((lab > 0).mean()))
            n_png += 1
    log(f"ytvos p4 path: {summary['frames']} frames at {summary['fps']:.2f} frames/s "
        f"inside the engine (staging included); {secs:.2f} s for the command; "
        f"{n_png} submission PNGs at {H0}x{W0}; labelled pixels {np.mean(labelled):.4f}; "
        f"launches {launches}")
    # B1 and B2 at this stream's shapes: B=1, M bucketed to the 2 objects
    m_b = bucket_objects(2, M)
    check_matcher("p4 stream", (1, m_b, N, (H // 16) * (W // 16),
                                cfg.model.feature_dim, int(np.prod(cfg.cost.mask_size))),
                  timed=False, iters=cfg.matching.sinkhorn_iters,
                  epsilon=cfg.matching.epsilon)
    check_resolve("p4 stream", 1, m_b, *mask_hw(cfg), H, W)
    # one chunk of video 0, decoded and staged from the tree, under the profiler
    ds = YTVOSDataset(str(root), image_size=(H, W), proposal_dir=str(cache),
                      max_objects=M, max_proposals=N)
    engine = InferenceEngine(cfg, seed=0)
    K = 8

    def chunk():
        sd = batch_sequence_streams([ds.sequence_stream(ds.videos[0])])
        items = itertools.islice(sd["frames"], K)
        return lambda: engine.run_stream_chunked(
            iter(RingStager(items, depth=2)), sd["tmpl_masks"], sd["tmpl_valid"],
            sd["first_frame"], chunk=K, live_from=sd["live_from"],
            tmpl_frames=sd["tmpl_frames"])

    chunk()()                   # warm-up (cuDNN plans, allocator, pinned blocks)
    prof = profiled(f"profiled p4 chunk ({K} frame steps, decoded and staged from "
                    "the tree)", "step", K, chunk())
    copies = prof["categories_ms"].get("host/device copies", 0.0)
    compute_busy = (prof["busy_ms"] - copies) / prof["wall_ms"]
    log(f"ytvos p4 path: device busy {compute_busy:.3f} without the copies, which "
        f"run on the stager's own stream ({copies / K:.3f} ms per step; "
        f"pinned {prof['pinned_copy_ms'] / K:.3f}, pageable "
        f"{prof['pageable_copy_ms'] / K:.3f})")
    # the same chunk's parts one after another: the reader alone (decode,
    # cached masks decoded and resized), the stager on the read items, the
    # engine on the staged items
    sd = batch_sequence_streams([ds.sequence_stream(ds.videos[0])])
    t0 = time.perf_counter()
    items = list(itertools.islice(sd["frames"], K))
    t1 = time.perf_counter()
    staged = list(RingStager(iter(items), depth=2))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    engine.run_stream_chunked(iter(staged), sd["tmpl_masks"], sd["tmpl_valid"],
                              sd["first_frame"], chunk=K, live_from=sd["live_from"],
                              tmpl_frames=sd["tmpl_frames"])
    torch.cuda.synchronize()
    n = len(items)
    parts = {"reader_ms": (t1 - t0) / n * 1e3, "stager_ms": (t2 - t1) / n * 1e3,
             "engine_ms": (time.perf_counter() - t2) / n * 1e3}
    log("ytvos p4 path, per frame step with the parts run one after another: "
        + ", ".join(f"{k[:-3]} {v:.2f} ms" for k, v in parts.items())
        + f" ({int(sum(it['prop_valid'].sum() for it in items)) / n:.1f} cached "
        f"masks and {nbytes(torch.from_numpy(items[0]['prop_masks'])) / 1e6:.1f} MB "
        "of full-grid masks per item)")
    return launches, {"fps": summary["fps"], "frames": summary["frames"],
                      "command_s": secs, "busy_without_copies": compute_busy,
                      **parts,
                      **{k: prof[k] for k in ("wall_ms", "busy_ms", "idle",
                                              "pinned_copy_ms", "pageable_copy_ms")}}


def ytvos_ckpt_path(tmp):
    """Phase 6c: the checkpoint through infer_torch.py --dataset ytvos on
    YTVOS_VIDEOS, as saved and on the kernels: overall G within 0.01 of the
    JAX package's, B1 and B2 once per frame step on the kernels (none as
    saved); one video on the card against the CPU."""
    import infer_torch
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    Image = require_pil("phase 6")

    root, cache = tmp / "ytvos_ckpt", tmp / "props_ckpt"
    gts, firsts = write_ytvos_tree(root, cache=cache, **YTVOS_VIDEOS)
    steps = len(YTVOS_VIDEOS["seeds"]) * YTVOS_VIDEOS["T"]
    H0, W0 = YTVOS_VIDEOS["hw"]
    log(f"ytvos checkpoint path: {CKPT} on {len(gts)} synthetic videos x "
        f"{YTVOS_VIDEOS['T']} frames at {H0}x{W0}, one object each appearing "
        f"mid-video, a cache from the ground truth; chunks of {YTVOS_CHUNK}")

    def run(name, device, extra=()):
        return infer_torch.main(["--ckpt", str(ROOT / CKPT), "--dataset", "ytvos",
                                 "--ytvos-root", str(root), "--proposal-dir", str(cache),
                                 "--out", str(tmp / name), "--device", device,
                                 "--chunk", str(YTVOS_CHUNK), *extra,
                                 "--set", *ckpt_sets(name.split("-")[0])])

    g, launches = {}, {}
    for r in CKPT_RUNS:
        reset_launch_counts()
        with pil_decode():
            run(r, "cuda")
        n = 0 if r == "as_saved" else steps
        launches[r] = expect_launches(f"ytvos checkpoint {r}", launch_counts(),
                                      {"fused_pool_cost_match": n,
                                       "fused_resolve_upsample": n})
        g[r] = ytvos_g(tmp / r, gts, firsts)
    log("ytvos checkpoint G: " + ", ".join(
        f"{r} {g[r]:.4f} (JAX package {JAX_YTVOS_G[r]:.4f})" for r in g))
    for r in g:
        if not abs(g[r] - JAX_YTVOS_G[r]) <= 0.01:
            fail(f"ytvos checkpoint {r}: G {g[r]:.4f}, needs to be within 0.01 "
                 f"of {JAX_YTVOS_G[r]:.4f}")
    vid = sorted(gts)[0]
    for r in CKPT_RUNS:
        with pil_decode():
            run(f"{r}-cpu", "cpu", ("--sequences", vid))
        mism = []
        for p in sorted((tmp / r / "Annotations" / vid).glob("*.png")):
            with Image.open(p) as a, Image.open(tmp / f"{r}-cpu" / "Annotations"
                                                / vid / p.name) as b:
                mism.append(float((np.asarray(a) != np.asarray(b)).mean()))
        log(f"ytvos checkpoint {r}, card vs CPU on {vid}: label mismatch "
            f"{np.mean(mism):.3e} (limit 1e-3) over {len(mism)} PNGs")
        if len(mism) != YTVOS_VIDEOS["T"] or np.mean(mism) >= 1e-3:
            fail(f"card and CPU disagree on the YouTube-VOS checkpoint run {r}")
    return g, launches


# ---------------------------------------------------------------------------
# phase 7: training (B1 forward + B1' backward, the train step, train_torch.py)
# ---------------------------------------------------------------------------

def write_davis_tree(root, train_seeds, val_seeds, T, hw):
    """A DAVIS-layout tree of synthetic videos (2 objects each, PNG frames
    and palette annotations at ``hw``) with ImageSets/2017/{train,val}.txt."""
    Image = require_pil("phase 7")
    from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
    root = Path(root)
    splits = {"train": [], "val": []}
    for split, seeds in (("train", train_seeds), ("val", val_seeds)):
        for seed in seeds:
            name = f"{split}{seed}"
            splits[split].append(name)
            s = synthetic_sequence(seed=seed, T=T, H=hw[0], W=hw[1],
                                   num_objects=2, num_proposals=4)
            for sub in ("JPEGImages", "Annotations"):
                (root / sub / "480p" / name).mkdir(parents=True)
            for t in range(T):
                Image.fromarray((s["frames"][t] * 255).astype(np.uint8)).save(
                    root / "JPEGImages" / "480p" / name / f"{t:05d}.png")
                lab = np.zeros(hw, np.uint8)
                for m in range(2):
                    lab[s["gt_masks"][t, m] > 0.5] = m + 1
                Image.fromarray(lab).save(
                    root / "Annotations" / "480p" / name / f"{t:05d}.png")
    (root / "ImageSets" / "2017").mkdir(parents=True)
    for split, names in splits.items():
        (root / "ImageSets" / "2017" / f"{split}.txt").write_text("\n".join(names))
    return root


def span_device_ms(prep, step, n, what):
    """Device ms per call of the kernels that start inside ``step(prep())``
    (torch.profiler; ``prep`` runs outside the measured range, each call
    ends in a synchronize), in total and by kernel name; fatal when a range
    recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(prep())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            a = prep()
            torch.cuda.synchronize()
            with torch.profiler.record_function("measured_span"):
                step(a)
                torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events()
             if e.name == "measured_span" and e.device_type != DeviceType.CUDA]
    if len(spans) != n:
        fail(f"{what} timing: {len(spans)} ranges recorded, not {n}")
    per = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name == "measured_span" or \
                getattr(e, "is_user_annotation", False):
            continue
        if any(sp.start <= e.time_range.start <= sp.end for sp in spans):
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    if sum(per.values()) <= 0:
        fail(f"{what} timing: no device time recorded")
    return sum(per.values()), per


B1_BWD_CASES = (("p5", (4, 8, 64, 448, 256, 4096), 0.03),
                ("p3", (4, 16, 128, 448, 256, 4096), 0.05),
                ("p4", (4, 32, 256, 448, 256, 4096), 0.05))


def b1_backward_check():
    """Phase 7a: B1' (_PoolCostMatch.backward: B1''s two kernels, the sweep
    and the tail, counted as one fused_pool_cost_match_backward launch,
    then the four products as torch.bmm / baddbmm) at
    p5_train's shapes (B=4, M=8, N=64, P=16x28, D=256, Pc=64x64) at epsilon
    0.03 (the smallest the training configurations use), and at p3's and
    p4's M, N at 0.05: X and all five gradients against autograd through
    the plain version (X within 2e-4, each gradient within 1e-3 of its
    largest entry) and against the explicit plain backward; two backwards
    bit-equal; one launch and one backward call per backward. Device ms per
    backward (the kernel and the products), its bound, the old route's
    (autograd through the plain version: its forward again and its VJP, as
    B1' ran before it had a kernel) and the explicit plain backward's."""
    import torch
    from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                           reset_launch_counts)
    from dmm_net_tpu_torch.kernels.matcher import (fused_pool_cost_match,
                                                   pool_cost_match_backward_plain,
                                                   pool_cost_match_plain)
    names = ("emb", "prop_masks_pool", "tmpl_masks_cost", "prop_masks_cost",
             "tmpl_feats")
    iters, out, t0 = 30, {}, time.perf_counter()
    for case, shape, eps in B1_BWD_CASES:
        gen = torch.Generator(device="cuda").manual_seed(21)
        args = matcher_inputs(gen, *shape)
        gX = torch.randn(shape[0], shape[1], shape[2], device="cuda", generator=gen)
        kw = dict(epsilon=eps, iters=iters)

        def leaves():
            return [a.clone().requires_grad_(True) for a in args[:5]]

        def run(fn):
            xs = leaves()
            X = fn(*xs, *args[5:], **kw)
            return X.detach(), torch.autograd.grad(X, xs, gX)

        reset_launch_counts()
        Xk, gk = run(fused_pool_cost_match)
        launches = launch_counts()["fused_pool_cost_match_backward"]
        calls = backward_calls()["fused_pool_cost_match"]
        _, gk2 = run(fused_pool_cost_match)
        Xp, gp = run(pool_cost_match_plain)
        ge = pool_cost_match_backward_plain(*args, gX, **kw)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(gk, gk2))
        x_err = (Xk - Xp).abs().max().item()
        g_abs = {n: (a - b).abs().max().item() for n, a, b in zip(names, gk, gp)}
        g_err = {n: g_abs[n] / max(b.abs().max().item(), 1e-30)
                 for n, b in zip(names, gp)}
        e_err = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                 for n, a, b in zip(names, gk, ge)}
        log(f"B1' {case} B,M,N,P,D,Pc={shape} epsilon={eps}: max|dX| {x_err:.3e} "
            f"(limit 2e-4); max|dgrad| / max|grad| against autograd through "
            f"the plain version "
            + ", ".join(f"{n} {e:.3e}" for n, e in g_err.items())
            + ", against the explicit plain backward "
            + ", ".join(f"{n} {e:.3e}" for n, e in e_err.items())
            + f" (limit 1e-3); two backwards bit-equal {bit_equal}; "
            f"{launches} launch, {calls} backward call")
        if x_err > 2e-4 or max(g_err.values()) > 1e-3 or max(e_err.values()) > 1e-3 \
                or not bit_equal or launches != 1 or calls != 1 \
                or not all(torch.isfinite(g).all() for g in gk):
            fail(f"B1' at {case}: gradients disagree with the plain versions, "
                 f"differ between two runs, or launches {launches} / calls {calls}")

        def fused_forward():
            xs = leaves()
            return fused_pool_cost_match(*xs, *args[5:], **kw), xs

        ms, per = span_device_ms(fused_forward,
                                 lambda a: torch.autograd.grad(a[0], a[1], gX),
                                 20, f"B1' {case}")
        plain, _ = span_device_ms(
            leaves, lambda xs: torch.autograd.grad(
                pool_cost_match_plain(*xs, *args[5:], **kw), xs, gX), 5,
            f"B1' old route {case}")
        explicit, _ = span_device_ms(
            lambda: None, lambda _: pool_cost_match_backward_plain(*args, gX, **kw),
            5, f"B1' explicit plain {case}")
        sweep = sum(v for k, v in per.items() if "matcher_sweep_kernel" in k)
        tail = sum(v for k, v in per.items() if "matcher_tail_kernel" in k)
        kern = sweep + tail
        if sweep <= 0 or tail <= 0:
            fail(f"B1' {case}: torch.profiler recorded no device time for the "
                 f"sweep ({sweep}) or the tail ({tail})")
        # bound: the saved inputs and gX read once, the five gradients
        # written; operations: twice B1's (the reverse sweep and the four
        # products; the forward is not rerun)
        _, ops = matcher_bound(args, iters)
        byts = nbytes(*args, gX) + nbytes(*args[:5])
        b_ms, b_by = bound_ms(byts, 2 * ops)
        log(f"B1' {case} time: backward {ms:.4f} ms on the device (kernels "
            f"{kern:.4f}: sweep {sweep:.4f}, tail {tail:.4f}; the four products "
            f"{ms - kern:.4f}: "
            + ", ".join(f"{k[:40]} {v:.4f}" for k, v in per.items())
            + f"); old route (the plain forward again and its VJP) {plain:.4f} "
            f"ms; explicit plain backward {explicit:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by}: {byts / 1e6:.2f} MB, {2 * ops / 1e9:.3f} GFLOP)")
        out[case] = {"max_abs_err": max(g_abs.values()), "x_err": x_err,
                     "grad_rel_err": g_err, "explicit_rel_err": e_err,
                     "bit_equal": bit_equal, "ms": ms, "kernel_ms": kern,
                     "sweep_ms": sweep, "tail_ms": tail,
                     "products_ms": ms - kern, "plain_ms": plain,
                     "explicit_plain_ms": explicit, "bound_ms": b_ms,
                     "bound_by": b_by}
    log(f"phase 7a: {time.perf_counter() - t0:.1f} s")
    return out


P5_TREE = dict(train_seeds=(7401, 7402, 7403), val_seeds=(7404,), T=8,
               hw=(256, 448))
P5_STEPS, P5_REMAT_STEPS = 6, 2


def p5_train_path(tmp):
    """Phase 7b: train_torch.py at full p5_train width (R-50 256x448, bf16
    backbone, M=8, N=64, B=4 clips of T=4) with matching.use_pallas=true on
    a DAVIS-layout tree, counters set to 0 just before and read just after:
    B1 launches and B1' backward calls exactly steps x T; loss and
    grad_norm finite at every step; ms per step; one profiled step; peak
    memory; 2 steps with remat (lower peak, same step-1 loss within 1e-3);
    the checkpoint served by infer_torch.py --ckpt on the tree's val
    split."""
    import importlib
    import torch
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.data.davis import DavisDataset
    from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                           reset_launch_counts)
    from dmm_net_tpu_torch.train.loop import batch_to, make_train_step

    root = write_davis_tree(tmp / "DAVIS", **P5_TREE)
    sets = ["matching.use_pallas=true", "data.dataset=davis", f"data.root={root}"]
    train_torch = importlib.import_module("train_torch")
    cfg = preset("p5_train")
    T = cfg.data.clip_length

    def train(logdir, steps, extra=()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        r = train_torch.main(["--preset", "p5_train", "--steps", str(steps),
                              "--logdir", str(tmp / logdir),
                              "--set", *sets, *extra])
        torch.cuda.synchronize()
        return (r, launch_counts(), backward_calls()["fused_pool_cost_match"],
                torch.cuda.max_memory_allocated())

    run, counts, bwd_calls, peak = train("p5", P5_STEPS)
    hist = run["history"]
    times = np.diff([h["time"] for h in hist])          # steps 2.. (warm)
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    log(f"p5_train: {P5_STEPS} steps, loss {['%.4f' % x for x in losses]}, "
        f"grad_norm {['%.4f' % x for x in gnorms]}, ms per step "
        f"{['%.1f' % (1e3 * x) for x in times]} after the first (median "
        f"{1e3 * np.median(times):.1f}; {run['seconds']:.1f} s for all "
        f"{P5_STEPS} with the warm-up), peak memory {peak / 2**30:.2f} GiB, "
        f"launches {counts}, B1' backward calls {bwd_calls}")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        fail("p5_train: a loss or grad_norm is not finite")
    expect_launches("p5_train", counts, {"fused_pool_cost_match": P5_STEPS * T,
                                         "fused_pool_cost_match_backward": P5_STEPS * T})
    if bwd_calls != P5_STEPS * T:
        fail(f"p5_train: {bwd_calls} B1' backward calls, expected {P5_STEPS * T}")

    # one more step under the profiler, on a batch staged on the card
    state = run["state"]
    ds = DavisDataset(str(root), split="train", image_size=cfg.model.image_size,
                      max_objects=cfg.matching.max_templates,
                      max_proposals=cfg.matching.max_proposals)
    batch = batch_to(next(ds.clip_batches(cfg.data.batch_size, T, seed=99)),
                     "cuda")
    step = make_train_step(state.model.config)
    prof = profiled("p5_train profiled step", "step", 1,
                    lambda: step(state, batch))

    remat, rcounts, _, rpeak = train("p5_remat", P5_REMAT_STEPS,
                                     ["train.remat=true"])
    r_loss = remat["history"][0]["loss"]
    rel = abs(r_loss - losses[0]) / abs(losses[0])
    log(f"p5_train with remat: {P5_REMAT_STEPS} steps, peak memory "
        f"{rpeak / 2**30:.2f} GiB (without {peak / 2**30:.2f}), step-1 loss "
        f"{r_loss:.6f} vs {losses[0]:.6f} (rel {rel:.2e}, limit 1e-3), "
        f"launches {rcounts} (the recompute launches B1 again)")
    if not (rpeak < peak and rel <= 1e-3):
        fail("p5_train with remat: peak memory not lower or step-1 loss differs")

    # serve the checkpoint
    infer_torch = importlib.import_module("infer_torch")
    out = tmp / "p5_serve"
    summary = infer_torch.main(["--ckpt", str(Path(run["checkpoint"]).parent),
                                "--davis-root", str(root), "--out", str(out),
                                "--device", "cuda"])
    pngs = sorted(out.glob("*/*.png"))
    n_val = len(P5_TREE["val_seeds"]) * P5_TREE["T"]
    log(f"p5_train checkpoint served by infer_torch.py --ckpt: {len(pngs)} "
        f"PNGs, J&F {summary['J&F']:.4f} (6 steps from random weights; "
        f"no quality bar)")
    if len(pngs) != n_val or not np.isfinite(summary["J&F"]):
        fail(f"serving the p5_train checkpoint wrote {len(pngs)} of {n_val} PNGs")
    return counts, bwd_calls, {"losses": losses, "grad_norms": gnorms,
                    "ms_per_step": [1e3 * x for x in times],
                    "ms_per_step_median": 1e3 * float(np.median(times)),
                    "peak_gib": peak / 2**30, "remat_peak_gib": rpeak / 2**30,
                    "remat_step1_rel": rel, "busy": 1 - prof["idle"],
                    "profile": prof, "serve_jf": summary["J&F"]}


# Phase 7c: 3 train steps from the git-tracked checkpoint (warmup_steps=0) on
# synthetic_clip_batch seeds 0-2 at B=2, T=3, as saved (unfused matcher) and
# with matching.use_pallas=true. JAX_TRAIN_STEPS holds the JAX package's
# per-step loss and grad_norm (its train step on the CPU);
# tests/test_torch_port_train_ckpt.py recomputes them.
TRAIN_CKPT = dict(seeds=(0, 1, 2), batch=2, T=3)
TRAIN_CKPT_RUNS = {"as_saved": {"train.warmup_steps": 0},
                   "kernels": {"train.warmup_steps": 0,
                               "matching.use_pallas": True}}
JAX_TRAIN_STEPS = {
    "as_saved": {"loss": [0.035863135010004044, 0.017290614545345306,
                          0.06140005216002464],
                 "grad_norm": [0.2979079484939575, 1.2772631645202637,
                               2.1229004859924316]},
    "kernels": {"loss": [0.035863135010004044, 0.017290418967604637,
                         0.06140032783150673],
                "grad_norm": [0.29790785908699036, 1.2772482633590698,
                              2.122906446456909]}}


def ckpt_train_steps(cfg, variables, device):
    """The port's 3 train steps from the checkpoint on ``device``: per-step
    loss and grad_norm."""
    from dmm_net_tpu_torch.data.synthetic import synthetic_clip_batch
    from dmm_net_tpu_torch.train.loop import (batch_to, create_train_state,
                                              make_train_step)
    H, W = cfg.model.image_size
    state = create_train_state(cfg, variables=variables, device=device)
    step = make_train_step(cfg)
    out = {"loss": [], "grad_norm": []}
    for seed in TRAIN_CKPT["seeds"]:
        batch = synthetic_clip_batch(
            seed=seed, batch=TRAIN_CKPT["batch"], T=TRAIN_CKPT["T"], H=H, W=W,
            num_objects=2, num_proposals=cfg.matching.max_proposals,
            pad_objects=cfg.matching.max_templates)
        m = step(state, batch_to(batch, device))
        for k in out:
            out[k].append(float(m[k]))
    return out


def ckpt_train_path():
    """Phase 7c: the checkpoint's 3 train steps on the card, as saved and on
    the kernels, against JAX_TRAIN_STEPS and against the same steps on the
    CPU, each to 1e-4 relative."""
    from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                           reset_launch_counts)
    from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt
    cfg0, variables = load_msgpack_ckpt(str(ROOT / CKPT))
    res, launches, bwd_calls = {}, {}, {}
    for run, sets in TRAIN_CKPT_RUNS.items():
        cfg = cfg0.override(**sets)
        reset_launch_counts()
        card = ckpt_train_steps(cfg, variables, "cuda")
        launches[run] = launch_counts()
        bwd_calls[run] = backward_calls()["fused_pool_cost_match"]
        cpu = ckpt_train_steps(cfg, variables, "cpu")
        res[run] = card
        for k in ("loss", "grad_norm"):
            want = JAX_TRAIN_STEPS[run][k]
            d_jax = max(abs(a - b) / abs(b) for a, b in zip(card[k], want))
            d_cpu = max(abs(a - b) / abs(b) for a, b in zip(card[k], cpu[k]))
            log(f"checkpoint train steps {run}: {k} card "
                f"{['%.6f' % x for x in card[k]]}, JAX {['%.6f' % x for x in want]}"
                f" (max rel {d_jax:.2e}), card vs CPU max rel {d_cpu:.2e} "
                f"(limits 1e-4)")
            if d_jax > 1e-4 or d_cpu > 1e-4:
                fail(f"checkpoint train steps {run}: {k} off by {d_jax:.2e} "
                     f"from JAX, {d_cpu:.2e} from the CPU")
    n = len(TRAIN_CKPT["seeds"]) * TRAIN_CKPT["T"]
    expect_launches("checkpoint train steps on the kernels", launches["kernels"],
                    {"fused_pool_cost_match": n, "fused_pool_cost_match_backward": n})
    if bwd_calls["kernels"] != n:
        fail(f"checkpoint train steps on the kernels: {bwd_calls['kernels']} "
             f"B1' backward calls, expected {n}")
    return res, launches, bwd_calls["kernels"]


# Phase 7d: the example at its defaults, scored on 16 held-out videos (its
# --eval-seqs; the default 1 makes the J&F one video's). Its docstring
# expects J&F > 0.7, which the JAX package's example does not reach at these
# arguments either; from one initial state the two packages score alike.
# The gates come from both packages' CPU runs over seeds 0-4 (PERF.md,
# section 6, the seed sweep): J&F above the example's own --min-jf default,
# and the last step's loss (the same batch for every seed) under
# EXAMPLE_MAX_LOSS.
EXAMPLE_ARGS = ["--eval-seqs", "16"]
EXAMPLE_RUNS = {"default": [], "kernels": ["--set", "matching.use_pallas=true"]}
EXAMPLE_MIN_JF = 0.5
EXAMPLE_MAX_LOSS = 0.41


def example_path():
    """Phase 7d: examples/train_and_eval_synthetic_torch.py at its defaults
    (R-18 64x64, 300 steps from scratch, then the engine and J&F on 16
    held-out videos), with the unfused matcher and with the kernel; J&F >
    EXAMPLE_MIN_JF and the last step's loss < EXAMPLE_MAX_LOSS each."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_and_eval_synthetic_torch",
        ROOT / "examples" / "train_and_eval_synthetic_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = {}
    for run, argv in EXAMPLE_RUNS.items():
        try:
            r = example.main(["--device", "cuda", *EXAMPLE_ARGS, *argv])
        except SystemExit as e:
            fail(f"examples/train_and_eval_synthetic_torch.py {run} exited {e.code}")
        out[run] = {"jf": r["jf"]["J&F"], "final_loss": r["final_loss"],
                    "steps_per_sec": r["steps_per_sec"]}
        log(f"example {run}: J&F {r['jf']['J&F']:.4f} (bar > {EXAMPLE_MIN_JF}), "
            f"last step's loss {r['final_loss']:.4f} (bar < "
            f"{EXAMPLE_MAX_LOSS}), {r['steps_per_sec']:.2f} train steps/s")
    if not all(v["jf"] > EXAMPLE_MIN_JF and v["final_loss"] < EXAMPLE_MAX_LOSS
               for v in out.values()):
        fail(f"example J&F not above {EXAMPLE_MIN_JF} or loss not below "
             f"{EXAMPLE_MAX_LOSS}: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 9: the detector's training (B4 forward + B4' backward), its scoring,
# the full system and DCNv2
# ---------------------------------------------------------------------------

# Phase 9c: 3 train steps of the small detector (R-18, 64x128, 8 classes,
# train_proposal.py's top-n) from the port's seeded weights, batch 2, on
# synthetic_detection_frame seeds 0-5. JAX_PROPOSAL_STEPS holds the JAX
# package's per-step loss and grad norm from the same weights (its train
# step on the CPU); tests/test_torch_port_detector_train.py recomputes them.
PROPOSAL_STEPS = dict(detector=dict(image_size=(64, 128), backbone_name="resnet18",
                                    num_classes=8, pre_nms_top_n=64,
                                    post_nms_top_n=32, max_detections=16),
                      seed=3, seeds=(0, 1, 2, 3, 4, 5), batch=2, lr=1e-4)
JAX_PROPOSAL_STEPS = {"loss": [5.095619201660156, 5.673397541046143,
                               2.392725944519043],
                      "grad_norm": [31.777803421020508, 35.27691650390625,
                                    33.89875411987305]}


def proposal_batches(frames):
    """synthetic_detection_frame dicts -> detection batches of
    PROPOSAL_STEPS["batch"] (the JAX package's batch layout, numpy)."""
    from dmm_net_tpu_torch.train.proposal_loop import stack_detection_frames
    B = PROPOSAL_STEPS["batch"]
    return [stack_detection_frames(frames[i:i + B]) for i in range(0, len(frames), B)]


def proposal_train_steps(device):
    """The port's 3 train steps of phase 9c on ``device``: per-step loss
    and grad norm."""
    from dmm_net_tpu_torch.data.synthetic import synthetic_detection_frame
    from dmm_net_tpu_torch.models.proposal import MaskRCNN
    from dmm_net_tpu_torch.train.proposal_loop import (make_proposal_optimizer,
                                                       make_proposal_train_step,
                                                       proposal_batch_to)
    det = PROPOSAL_STEPS["detector"]
    H, W = det["image_size"]
    frames = [synthetic_detection_frame(seed=s, H=H, W=W, max_objects=4,
                                        num_classes=det["num_classes"])
              for s in PROPOSAL_STEPS["seeds"]]
    model = MaskRCNN(**det, device=device, seed=PROPOSAL_STEPS["seed"]).trainable_()
    step = make_proposal_train_step(
        model, make_proposal_optimizer(model, PROPOSAL_STEPS["lr"]))
    out = {"loss": [], "grad_norm": []}
    for batch in proposal_batches(frames):
        m = step(proposal_batch_to(batch, device))
        for k in out:
            out[k].append(float(m[k]))
    return out


def b4_backward_check():
    """Phase 9a: B4' (multilevel_roi_align's autograd.Function: B4's kernel
    forward, its two backward kernels, the prep and the gather, counted as
    one roi_align_backward launch) at the full-width
    detector's shapes: a 256x448 R-50-FPN pyramid (C=256), K=32 proposals
    (train_proposal.py's post-NMS top-n) and K=128, both heads. The forward
    against the plain version (1e-4 + 1e-4 |want|), the four level
    gradients of a seeded upstream gradient against autograd through the
    plain version and against the explicit plain backward (1e-4 relative
    per level), two backwards bit-equal, one launch and one backward call
    per backward; device ms per backward (torch.profiler), its bound, the
    old route's (autograd through the plain version: all four levels again
    and their VJP) and the explicit plain backward's."""
    import torch
    from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                           reset_launch_counts)
    from dmm_net_tpu_torch.kernels.roi_align import (
        multilevel_roi_align, multilevel_roi_align_backward_plain,
        multilevel_roi_align_plain)
    out, t0 = {}, time.perf_counter()
    for K in (32, 128):
        for head, size in (("box", (7, 7)), ("mask", (14, 14))):
            gen = torch.Generator(device="cuda").manual_seed(40 + K + size[0])
            levels, boxes = pyramid(gen), detector_boxes(gen, K, 256, 448)
            g = torch.randn(K, 256, *size, device="cuda", generator=gen)

            def leaves():
                return [t.clone().requires_grad_(True) for t in levels]

            def run(fn):
                xs = leaves()
                y = fn(xs, boxes, size, 2)
                return y, torch.autograd.grad(y, xs, g)

            reset_launch_counts()
            yk, gk = run(multilevel_roi_align)
            launches = launch_counts()["roi_align_backward"]
            calls = backward_calls()["roi_align"]
            _, gk2 = run(multilevel_roi_align)
            yp, gp = run(multilevel_roi_align_plain)
            ge = multilevel_roi_align_backward_plain(levels, boxes, g, size, 2)
            bit_equal = all(torch.equal(a, b) for a, b in zip(gk, gk2))
            name = f"{head} head K={K} -> {size[0]}x{size[1]}"
            err = roi_compare(f"B4' forward, {name}", yk, yp)
            g_abs = [(a - b).abs().max().item() for a, b in zip(gk, gp)]
            g_err = [e / max(b.abs().max().item(), 1e-30) for e, b in zip(g_abs, gp)]
            e_err = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                     for a, b in zip(gk, ge)]
            log(f"B4' backward, {name}: max|dgrad| / max|grad| per level p2..p5 "
                f"against autograd through the plain version "
                + ", ".join(f"{e:.3e}" for e in g_err) + ", against the explicit "
                "plain backward " + ", ".join(f"{e:.3e}" for e in e_err)
                + f" (limit 1e-4), max|dgrad| {max(g_abs):.3e}; two backwards "
                f"bit-equal {bit_equal}; {launches} launch, {calls} backward call")
            if max(g_err) > 1e-4 or max(e_err) > 1e-4 or not bit_equal \
                    or launches != 1 or calls != 1 \
                    or not all(torch.isfinite(t).all() for t in gk):
                fail(f"B4' at {name}: gradients disagree with the plain versions, "
                     f"differ between two runs, or launches {launches} / calls "
                     f"{calls}")

            def kernel_forward():
                xs = leaves()
                return multilevel_roi_align(xs, boxes, size, 2), xs

            ms, per = span_device_ms(kernel_forward,
                                     lambda a: torch.autograd.grad(a[0], a[1], g),
                                     20, f"B4' {name}")
            prep = sum(v for k, v in per.items() if "roi_align_backward_prep_kernel" in k)
            gather = sum(v for k, v in per.items() if "roi_align_backward_kernel<" in k)
            if prep <= 0 or gather <= 0:
                fail(f"B4' {name}: torch.profiler recorded no device time for the "
                     f"prep ({prep}) or the gather ({gather})")
            plain, _ = span_device_ms(
                leaves, lambda xs: torch.autograd.grad(
                    multilevel_roi_align_plain(xs, boxes, size, 2), xs, g),
                10, f"B4' old route {name}")
            explicit, _ = span_device_ms(
                lambda: None, lambda _: multilevel_roi_align_backward_plain(
                    levels, boxes, g, size, 2), 10, f"B4' explicit plain {name}")
            # bytes: the upstream gradient and the boxes read, the four level
            # gradients written once (ROI-Align is linear in the levels, so
            # its gradient never reads them); operations: each output cell's
            # gradient added into its 4 taps of s x s samples on the box's own
            # level (as B4's forward is counted)
            byts = nbytes(g, boxes, *levels)
            ops = 10 * K * 256 * size[0] * size[1] * 2 * 2
            b_ms, b_by = bound_ms(byts, ops)
            log(f"B4' time, {name}: backward {ms:.4f} ms on the device (prep "
                f"{prep:.4f}, gather {gather:.4f}); old route (the plain version on "
                f"all 4 levels again and its VJP) {plain:.4f} ms; explicit plain backward "
                f"{explicit:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
                f"{byts / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
            out[(K, head)] = {"forward_max_abs_err": err, "max_abs_err": max(g_abs),
                              "grad_rel_err": max(g_err),
                              "explicit_rel_err": max(e_err), "bit_equal": bit_equal,
                              "ms": ms, "prep_ms": prep, "gather_ms": gather,
                              "plain_ms": plain, "explicit_plain_ms": explicit,
                              "bound_ms": b_ms, "bound_by": b_by}
    per_image = {k: out[(32, "box")][k] + out[(32, "mask")][k]
                 for k in ("ms", "plain_ms", "explicit_plain_ms", "bound_ms")}
    log(f"B4' per train image (K=32, box + mask head: 2 backward calls of 2 kernels): "
        f"{per_image['ms']:.4f} ms, old route {per_image['plain_ms']:.4f} ms, "
        f"explicit plain {per_image['explicit_plain_ms']:.4f} ms, bound "
        f"{per_image['bound_ms']:.4f} ms")
    log(f"phase 9a: {time.perf_counter() - t0:.1f} s")
    return out, per_image


# Phase 9b: train_proposal_torch.py at the full width of the repo's
# R-50-FPN Mask R-CNN; depth cut to 8 steps (set-up cut to 16 frames).
R50_TRAIN = ["--backbone", "resnet50", "--image-size", "256", "448",
             "--num-classes", "81", "--batch", "2", "--steps", "8",
             "--distinct-frames", "16", "--device", "cuda"]


def proposal_train_path(tmp):
    """Phase 9b: R50_TRAIN with --save, counters set to 0 just before and
    read just after (B4 2 x batch launches per step, B4' 2 x batch backward
    calls), every loss part finite, ms per step (median of steps 2-8),
    peak memory, one profiled step; then tools/extract_proposals_torch.py
    --params on the saved file over a one-video DAVIS tree (B4 twice per
    frame)."""
    import importlib
    import torch
    from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                           reset_launch_counts)
    from dmm_net_tpu_torch.train.proposal_loop import (make_proposal_optimizer,
                                                       make_proposal_train_step,
                                                       proposal_batch_to,
                                                       stack_detection_frames)
    train = importlib.import_module("train_proposal_torch")
    save = tmp / "r50_mrcnn.msgpack"
    steps, B = 8, 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    r = train.main([*R50_TRAIN, "--save", str(save), "--logdir", str(tmp / "r50")])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts, bwd = launch_counts(), backward_calls()["roi_align"]
    hist = r["history"]
    parts = ("rpn_cls", "rpn_reg", "box_cls", "box_reg", "mask", "total", "grad_norm")
    if not all(np.isfinite(h[k]) for h in hist for k in parts):
        fail(f"R-50 detector training: a loss part is not finite: {hist}")
    times = 1e3 * np.diff(r["step_times"])
    log(f"R-50-FPN detector training (81 classes, 256x448, batch {B}, {steps} "
        f"steps): total loss {['%.4f' % h['total'] for h in hist]}, ms per step "
        f"{['%.1f' % t for t in times]} (median {np.median(times):.1f}), peak "
        f"memory {peak / 2**30:.2f} GiB, launches {counts}, B4' backward calls {bwd}")
    expect_launches("R-50 detector training", counts,
                    {"roi_align": 2 * B * steps, "roi_align_backward": 2 * B * steps,
                     "fused_pool_cost_match": 0})
    if bwd != 2 * B * steps:
        fail(f"R-50 detector training: {bwd} B4' backward calls, expected "
             f"{2 * B * steps}")
    model = r["model"]
    sample = train.make_sampler("detection", 256, 448, 4, 81)
    batch = proposal_batch_to(stack_detection_frames(
        [sample(900 + j) for j in range(B)]), "cuda")
    step = make_proposal_train_step(model, make_proposal_optimizer(model, 1e-4))
    step(batch)
    prof = profiled("R-50 detector profiled train step", "step", 1,
                    lambda: step(batch), ranges="detector/")

    root = write_davis_tree(tmp / "DAVIS_det", train_seeds=(), val_seeds=(7501,),
                            T=4, hw=(256, 448))
    extract = load_tool("extract_proposals_torch")
    reset_launch_counts()
    extract.main(["--root", str(root), "--out", str(tmp / "props_det"),
                  "--params", str(save), "--score-thresh", "0"])
    ex_counts = launch_counts()
    files = sorted((tmp / "props_det").glob("*/*.json"))
    n_props = [len(json.loads(f.read_text())) for f in files]
    log(f"extract_proposals_torch.py --params (the trained R-50 file): "
        f"{len(files)} frames, proposals per frame {n_props}, launches {ex_counts}")
    if len(files) != 4 or not all(n_props) or ex_counts["roi_align"] != 8:
        fail("the trained detector's file did not serve extract_proposals_torch.py")
    return counts, bwd, ex_counts, {
        "losses": [h["total"] for h in hist], "ms_per_step": list(times),
        "ms_per_step_median": float(np.median(times)), "peak_gib": peak / 2**30,
        "busy": 1 - prof["idle"], "profile": prof}


def proposal_steps_path():
    """Phase 9c: the small detector's 3 train steps on the card and on the
    card's CPU against JAX_PROPOSAL_STEPS, each to 1e-4 relative."""
    from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                           reset_launch_counts)
    reset_launch_counts()
    card = proposal_train_steps("cuda")
    counts, bwd = launch_counts(), backward_calls()["roi_align"]
    cpu = proposal_train_steps("cpu")
    for k in ("loss", "grad_norm"):
        want = JAX_PROPOSAL_STEPS[k]
        d_jax = max(abs(a - b) / abs(b) for a, b in zip(card[k], want))
        d_cpu = max(abs(a - b) / abs(b) for a, b in zip(card[k], cpu[k]))
        log(f"detector train steps: {k} card {['%.6f' % x for x in card[k]]}, JAX "
            f"{['%.6f' % x for x in want]} (max rel {d_jax:.2e}), card vs CPU max "
            f"rel {d_cpu:.2e} (limits 1e-4)")
        if d_jax > 1e-4 or d_cpu > 1e-4:
            fail(f"detector train steps: {k} off by {d_jax:.2e} from JAX, "
                 f"{d_cpu:.2e} from the CPU")
    n = 2 * PROPOSAL_STEPS["batch"] * 3
    expect_launches("detector train steps", counts,
                    {"roi_align": n, "roi_align_backward": n})
    if bwd != n:
        fail(f"detector train steps: {bwd} B4' backward calls, expected {n}")
    return card, counts, bwd


# Phase 9d: the learning proof, train_proposal_torch.py at R-18 128x224 on
# the detection frames from the port's seeded init (seed 0). The floors come
# from the JAX package's train_proposal.py on the CPU with the same flags
# from the same initial weights (the port's --steps 0 --save, passed to its
# --init), seeds 0 and 1: box AP50 0.3179 / 0.2736, mask AP50 0.3096 /
# 0.2736 (PERF.md, section 6, the floors); the untrained detector (--steps 0)
# scores at most 0.0005. Each floor lies halfway between the untrained
# score and the lower run, rounded down: training from scratch is chaotic,
# one init's float32 trajectories part within steps.
LEARN_ARGS = ["--backbone", "resnet18", "--image-size", "128", "224",
              "--data", "detection", "--num-classes", "3", "--eval-images", "32",
              "--steps", "800", "--seed", "0", "--device", "cuda"]
LEARN_FLOORS = {"box_AP50": 0.13, "mask_AP50": 0.13}


def learning_path(tmp):
    """Phase 9d: LEARN_ARGS with --save; box and mask AP50 over the floors;
    B4 and B4' counted (2 launches and 2 backward calls per train image, 2
    launches per eval image)."""
    import importlib
    import torch
    from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                           reset_launch_counts)
    train = importlib.import_module("train_proposal_torch")
    save = tmp / "r18_mrcnn.msgpack"
    reset_launch_counts()
    t0 = time.perf_counter()
    r = train.main([*LEARN_ARGS, "--save", str(save), "--logdir", str(tmp / "r18")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, bwd = launch_counts(), backward_calls()["roi_align"]
    steps = int(LEARN_ARGS[LEARN_ARGS.index("--steps") + 1])
    times = 1e3 * np.diff(r["step_times"])
    box, mask = r["box_ap"], r["mask_ap"]
    log(f"learning proof (R-18 128x224, 3 classes, {steps} steps, seed 0): "
        f"box AP50 {box['AP50']:.4f} mAP {box['mAP']:.4f}, mask AP50 "
        f"{mask['AP50']:.4f} mAP {mask['mAP']:.4f} on 32 held-out frames "
        f"(floors {LEARN_FLOORS}); last total loss {r['history'][-1]['total']:.4f}; "
        f"median {np.median(times):.1f} ms per step, {secs:.1f} s in all; "
        f"launches {counts}, B4' backward calls {bwd}")
    expect_launches("learning proof", counts, {"roi_align": 2 * steps + 2 * 32,
                                               "roi_align_backward": 2 * steps})
    if bwd != 2 * steps:
        fail(f"learning proof: {bwd} B4' backward calls, expected {2 * steps}")
    if not (box["AP50"] > LEARN_FLOORS["box_AP50"]
            and mask["AP50"] > LEARN_FLOORS["mask_AP50"]):
        fail(f"learning proof: AP50 box {box['AP50']:.4f} / mask "
             f"{mask['AP50']:.4f} not above the floors {LEARN_FLOORS}")
    return save, counts, bwd, {"box_ap": box, "mask_ap": mask,
                               "ms_per_step_median": float(np.median(times)),
                               "seconds": secs,
                               "final_loss": r["history"][-1]["total"]}


# Phase 9e: examples/full_system_synthetic_torch.py with the git-tracked DMM
# checkpoint and 9d's detector on 4 held-out videos (seeds 5000-5003, 8
# frames), as saved and on the kernels (CKPT_RUNS). JAX_FULL_SYSTEM_PLANTED_JF
# is the JAX package's planted-proposal J&F on the same videos and weights
# (examples/full_system_synthetic.py as saved; its engine with the kernel
# run's overrides), recomputed by tests/test_torch_port_detector_system.py.
# The floors come from the JAX example on the CPU with 9d's two JAX-trained
# detectors: recall@0.5 1.000 / 1.000, detector J&F 0.839 / 0.870; with
# their untrained inits: recall 0.000 / 0.000, J&F 0.352 / 0.029 (PERF.md,
# section 6, the floors). Each floor lies halfway between the better untrained
# score and the lower trained one, rounded down.
FULL_SYSTEM_ARGS = ["--eval-seqs", "4", "--frames", "8", "--device", "cuda"]
JAX_FULL_SYSTEM_PLANTED_JF = {"as_saved": 0.9712825323880612,
                              "kernels": 0.9684382930147375}
FULL_SYSTEM_FLOORS = {"recall": 0.5, "jf_detector": 0.59}


def full_system_path(mrcnn):
    """Phase 9e: the example as saved and on the kernels: planted J&F
    within 0.01 of the JAX package's, detector recall and J&F over the
    floors, B4 twice per detector frame, B1 and B2 once per frame step on
    the kernels."""
    import importlib.util
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    spec = importlib.util.spec_from_file_location(
        "full_system_synthetic_torch", ROOT / "examples" / "full_system_synthetic_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    n_seq, T = 4, 8
    out, launches = {}, {}
    for run in CKPT_RUNS:
        reset_launch_counts()
        try:
            r = example.main(["--dmm", str(ROOT / CKPT), "--mrcnn", str(mrcnn),
                              *FULL_SYSTEM_ARGS, "--set", *ckpt_sets(run)])
        except SystemExit as e:
            fail(f"examples/full_system_synthetic_torch.py {run} exited {e.code}")
        n = 0 if run == "as_saved" else 2 * n_seq * T    # detector + planted
        launches[run] = expect_launches(
            f"full system {run}", launch_counts(),
            {"roi_align": 2 * n_seq * T, "fused_pool_cost_match": n,
             "fused_resolve_upsample": n})
        out[run] = {k: r[k] for k in ("recall", "jf_detector", "jf_planted")}
        d = abs(r["jf_planted"] - JAX_FULL_SYSTEM_PLANTED_JF[run])
        log(f"full system {run}: planted J&F {r['jf_planted']:.6f} (JAX package "
            f"{JAX_FULL_SYSTEM_PLANTED_JF[run]:.6f}, |d| {d:.2e}, limit 0.01), "
            f"detector recall@0.5 {r['recall']:.4f} and J&F {r['jf_detector']:.4f} "
            f"(floors {FULL_SYSTEM_FLOORS})")
        if not (d <= 0.01 and r["recall"] > FULL_SYSTEM_FLOORS["recall"]
                and r["jf_detector"] > FULL_SYSTEM_FLOORS["jf_detector"]):
            fail(f"full system {run}: planted J&F off JAX's, or recall / "
                 f"detector J&F not above the floors: {out[run]}")
    return out, launches


def dcn_path():
    """Phase 9f: DCNv2. (i) The full-width detector (R-50-FPN, 81 classes,
    256x448) with deform_stages c3..c5 and seeded non-zero offset
    predictors: one forward and train steps at batch 2, every loss part
    finite, ms per step and peak memory. (ii) The small DCN detector (R-18,
    64x128, 8 classes) on the same weights and inputs on the card and on
    its CPU: the same detections and the same loss to 1e-4."""
    import torch
    from dmm_net_tpu_torch.data.synthetic import synthetic_detection_frame
    from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                           reset_launch_counts)
    from dmm_net_tpu_torch.models.proposal import MaskRCNN
    from dmm_net_tpu_torch.train.proposal_loop import (make_proposal_batch_loss,
                                                       make_proposal_optimizer,
                                                       make_proposal_train_step,
                                                       proposal_batch_to)
    stages = ("c3", "c4", "c5")

    def build(device, **kw):
        det = MaskRCNN(deform_stages=stages, device=device, seed=8, **kw)
        gen = torch.Generator().manual_seed(9)
        with torch.no_grad():
            for name, p in det.named_parameters():
                if ".offset_conv." in name:
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        return det

    def batch_of(H, W, C, seeds, device):
        frames = [synthetic_detection_frame(seed=s, H=H, W=W, max_objects=4,
                                            num_classes=C) for s in seeds]
        return proposal_batch_to(proposal_batches(frames)[0], device)

    det = build("cuda", pre_nms_top_n=64, post_nms_top_n=32, max_detections=16)
    batch = batch_of(256, 448, 81, (11, 12), "cuda")
    out = det(batch["images"][:1].permute(0, 3, 1, 2))
    if not all(torch.isfinite(v.float()).all() for v in out.values()):
        fail("DCN detector forward: outputs not finite")
    det.trainable_()
    step = make_proposal_train_step(det, make_proposal_optimizer(det, 1e-4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stamps, hist = [], []
    for _ in range(4):
        m = step(batch)
        hist.append({k: float(v) for k, v in m.items()})
        stamps.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated()
    counts, bwd = launch_counts(), backward_calls()["roi_align"]
    times = 1e3 * np.diff(stamps)
    log(f"DCN R-50-FPN detector (c3..c5 deformable, 81 classes, 256x448, batch "
        f"2): losses {['%.4f' % h['loss'] for h in hist]}, ms per step "
        f"{['%.1f' % t for t in times]} (median {np.median(times):.1f}), peak "
        f"memory {peak / 2**30:.2f} GiB, launches {counts}, B4' backward calls {bwd}")
    if not all(np.isfinite(v) for h in hist for v in h.values()):
        fail(f"DCN detector training: a loss part is not finite: {hist}")
    expect_launches("DCN detector training", counts,
                    {"roi_align": 16, "roi_align_backward": 16})
    if bwd != 16:
        fail(f"DCN detector training: {bwd} B4' backward calls, expected 16")

    small = dict(image_size=(64, 128), backbone_name="resnet18", num_classes=8,
                 pre_nms_top_n=64, post_nms_top_n=32, max_detections=16)
    res = {}
    for dev in ("cuda", "cpu"):
        d = build(dev, **small)
        b = batch_of(64, 128, 8, (0, 1), dev)
        with torch.no_grad():
            o = d(b["images"][:1].permute(0, 3, 1, 2))
        d.trainable_()
        loss, _ = make_proposal_batch_loss(d)(b)
        res[dev] = ({k: v.cpu().numpy() for k, v in o.items()}, float(loss))
    (a, la), (c, lc) = res["cuda"], res["cpu"]
    errs = {k: float(np.abs(a[k] - c[k]).max()) for k in ("boxes", "scores", "masks")}
    same = bool((a["valid"] == c["valid"]).all() and (a["classes"] == c["classes"]).all())
    rel = abs(la - lc) / abs(lc)
    log(f"small DCN detector (R-18 64x128, 8 classes): card vs CPU valid/classes "
        f"equal={same} ({int(c['valid'].sum())} valid), max|d| boxes "
        f"{errs['boxes']:.3e} (limit 1e-3), scores {errs['scores']:.3e} (1e-4), "
        f"masks {errs['masks']:.3e} (1e-4); loss {la:.6f} vs {lc:.6f} (rel "
        f"{rel:.2e}, limit 1e-4)")
    if not (same and c["valid"].any() and errs["boxes"] <= 1e-3
            and errs["scores"] <= 1e-4 and errs["masks"] <= 1e-4 and rel <= 1e-4):
        fail("card and CPU disagree on the small DCN detector")
    return counts, bwd, {"losses": [h["loss"] for h in hist],
                         "ms_per_step": list(times),
                         "ms_per_step_median": float(np.median(times)),
                         "peak_gib": peak / 2**30, "small_loss_rel": rel}


# ---------------------------------------------------------------------------
# phase 10: data parallelism (parallel/mesh.py), profiling, debug, the
# examples and the weight importers
# ---------------------------------------------------------------------------

# 10a/10b: p5_train at full width (R-50 256x448, M=8, N=64, B=4 clips of
# T=4) on synthetic clips; clip 0 tracks one object and the others two, so
# the halves of the batch hold 3 and 4 valid objects. 10b runs the backbone
# in float32 (the preset's is bf16), so that the comparison with one
# process is held at the CPU tests' tolerances
# (tests/test_torch_port_parallel_train.py): the loss and the gradient norm
# to 1e-4 relative, every gradient leaf to 1e-4 of its largest entry, the
# BN running statistics to 1e-5. 10b's small configuration is that file's
# train_bn one (R-18 float32 64x64, train-mode BN, fused matcher, remat).
MESH_P5 = dict(seed=7501, batch=4, T=4)
MESH_STEPS = 6
MESH_F32 = {"model.backbone_dtype": "float32"}
MESH_SMALL = {"model.backbone": "resnet18", "model.backbone_dtype": "float32",
              "model.image_size": (64, 64), "model.feature_dim": 32,
              "model.decoder_dim": 16, "model.train_bn": True,
              "matching.max_templates": 4, "matching.max_proposals": 8,
              "matching.sinkhorn_iters": 10, "matching.use_pallas": True,
              "train.remat": True, "train.warmup_steps": 0, "train.lr": 1e-3,
              "train.loss_iou_weight": 0.5}
# 10c: the p3 engine at full width, B=4 sequences, K=8, 2 chunks; the
# first two sequences (rank 0's) hold 3 and 2 objects, the last two 7 and
# 5, so the object bucket (8) must be the whole batch's on both ranks.
MESH_ENGINE = dict(seed=7502, T=16, K=8, n_valid=[3, 2, 7, 5])
# 10c holds each rank's per-step logits (B, M, h, w on the mask grid, every
# element of every valid object) to one process's within LOGIT_REL of their
# largest magnitude: 2^-8, the most that rounding to bf16 changes a value
# by. The p3 decoder runs in bf16, and one process on B=4 and a rank on
# B=2 may take other cuDNN algorithms (measured 1.53e-3 on the H100); a
# rank that ran another sequence's or another step's decoder would be off
# by the logits' own size. X is held within 1e-5, and the labels exactly
# where they are decided: the best candidate (a valid object's logit,
# bilinearly upsampled, or the background's 0) leads the second by more
# than LABEL_TIE. B2 rounds each logit and its column pass to bf16 (steps
# of 2^-7 of the value), so two runs whose logits differ by float
# reassociation can land two steps apart per candidate, ~0.005 at the
# |logit| <= 0.3 of seeded random weights, and a smaller lead may legally
# flip. Those weights give every object nearly the same logit (4.4% of
# p3's pixels lie within 1e-5 of a tie, measured on the CPU), so few
# pixels are decided (1.18% on the H100): the logits carry the decoder's
# comparison, and fewer than DECIDED_FLOOR decided pixels is a failure.
LOGIT_REL = 2.0 ** -8
LABEL_TIE = 1e-2
DECIDED_FLOOR = 5e-3
# 10d: the R-50-FPN detector at 256x448 (81 classes, train_proposal.py's
# top-n 64/32/16), batch 2 noise images with synthetic_detection_frame's
# ground truth; the RPN's delta kernel zeroed and the mask head's
# convolutions biased positive, as tests/test_torch_port_detector_train.py
# does (random deltas near the decode's clip, and pre-activations on
# ReLU's kink, would turn rounding into discrete changes). Held as
# tests/test_torch_port_parallel_detector.py holds the CPU step: the loss
# and its parts to 1e-4 relative, the whole gradient to a relative L2 of
# 1e-5.
MESH_DET = dict(detector=dict(image_size=(256, 448), backbone_name="resnet50",
                              num_classes=81, pre_nms_top_n=64,
                              post_nms_top_n=32, max_detections=16),
                seed=7503, frames=(7503, 7504), G=4)
# examples/infer_demo.py's matcher-aggregated J&F, as it prints it (CPU);
# tests/test_torch_port_tools.py recomputes it beside the port's.
JAX_INFER_DEMO_AGG_JF = 0.781


def mesh_p5_batch(small=False):
    """10a/10b's clip batch (numpy), clip 0 cut to one valid object."""
    from dmm_net_tpu_torch.data.synthetic import synthetic_clip_batch
    if small:
        b = synthetic_clip_batch(seed=0, batch=2, T=3, H=64, W=64, num_objects=2,
                                 num_proposals=8, pad_objects=4)
    else:
        b = synthetic_clip_batch(seed=MESH_P5["seed"], batch=MESH_P5["batch"],
                                 T=MESH_P5["T"], H=256, W=448, num_objects=2,
                                 num_proposals=64, pad_objects=8)
    b = {k: np.asarray(v) for k, v in b.items()}
    b["tmpl_valid"][0, 1:] = False
    return b


def mesh_p5_config(small=False, f32=False):
    from dmm_net_tpu_torch.config import preset
    cfg = preset("p5_train").override(**{"matching.use_pallas": True})
    if small:
        return cfg.override(**MESH_SMALL)
    return cfg.override(**MESH_F32) if f32 else cfg


def mesh_train_run(cfg, batch, steps, mesh=None):
    """``steps`` train steps from seed 0 on ``batch`` (this rank's rows on
    a mesh): losses, grad norms, ms per step (host clock, each step ending
    in a read of its loss), the first step's reduced gradients and BN
    running statistics, and B1 launches and B1' calls over the steps."""
    import torch
    from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                           reset_launch_counts)
    from dmm_net_tpu_torch.parallel import shard_batch
    from dmm_net_tpu_torch.train.loop import (batch_to, create_train_state,
                                              make_train_step)
    state = create_train_state(cfg, seed=0, device="cuda", mesh=mesh)
    step = make_train_step(cfg, mesh)
    b = batch_to(batch if mesh is None else shard_batch(batch, mesh),
                 state.model.device)
    first = {}
    update = state.optimizer.update

    def keep(grads):
        if not first:
            first["grads"] = [g.detach().clone() for g in grads]
        return update(grads)

    state.optimizer.update = keep
    out = {"loss": [], "grad_norm": [], "ms": []}
    torch.cuda.synchronize()
    reset_launch_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        m = step(state, b)
        out["loss"].append(float(m["loss"]))
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            out["bn"] = {k: v.detach().clone() for k, v in
                         state.model.state_dict().items()
                         if k.endswith(("running_mean", "running_var"))}
    torch.cuda.synchronize()
    out["launches"] = launch_counts()["fused_pool_cost_match"]
    out["b1_backward"] = backward_calls()["fused_pool_cost_match"]
    out["grads"] = first["grads"]
    out["names"] = [n for n, _ in state.model.named_parameters()]
    return out


def _one_rank_p5(cfg, batch):
    import torch.distributed as dist
    from dmm_net_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    return dist.get_backend(), mesh_train_run(cfg, batch, MESH_STEPS, mesh)


def _worst_leaf(got, want, names):
    """The largest |got - want| over a leaf's largest |want|, and its leaf."""
    def ratio(g, w):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        return float((g - w).abs().max() / (w.abs().max() + 1e-12))
    return max((ratio(g, w), n) for n, g, w in zip(names, got, want))


def grads_close(what, got, want, names, leaf_tol):
    """Every leaf of ``got`` within ``leaf_tol`` of that leaf's largest
    entry in ``want``; returns the worst such ratio."""
    worst, name = _worst_leaf(got, want, names)
    if not worst <= leaf_tol:
        fail(f"{what}: gradient of {name} off by {worst:.2e} of its largest "
             f"entry (limit {leaf_tol:.0e})")
    return worst


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over every leaf together."""
    num = sum(float((g.detach().double().cpu() - w.detach().double().cpu())
                    .square().sum()) for g, w in zip(got, want))
    den = sum(float(w.detach().double().square().sum()) for w in want)
    return (num / max(den, 1e-300)) ** 0.5


def mesh_one_rank_path():
    """Phase 10a: a one-rank mesh over NCCL at full p5_train width (B1 and
    B1' on the card) against the meshless step. A one-rank all-reduce is a
    copy, so the first step's loss must be equal (the later ones, after
    updates from the gradients below, to 1e-4); the gradients are not
    bitwise reproducible on the card even without the mesh (some backward
    operations add with atomics), so their relative L2 distance to the
    meshless step's must stay within 3x the largest distance between three
    meshless runs (and be 0 if those are equal); ms per step of both."""
    from dmm_net_tpu_torch.parallel import launch
    cfg, batch = mesh_p5_config(), mesh_p5_batch()
    T = MESH_P5["T"]
    plain = mesh_train_run(cfg, batch, MESH_STEPS)
    runs = [mesh_train_run(cfg, batch, 1) for _ in range(2)]
    backend, mesh = launch(_one_rank_p5, 1, "cuda", cfg, batch)[0]
    names = plain["names"]
    pairs = ((runs[0], plain), (runs[1], plain), (runs[0], runs[1]))
    spread = max(_rel_l2(a["grads"], b["grads"]) for a, b in pairs)
    diff = _rel_l2(mesh["grads"], plain["grads"])
    leaf = _worst_leaf(mesh["grads"], plain["grads"], names)
    leaf_spread = max(_worst_leaf(a["grads"], b["grads"], names)
                      for a, b in pairs)
    ms_plain, ms_mesh = (float(np.median(r["ms"][1:])) for r in (plain, mesh))
    log(f"10a one-rank mesh ({backend}) at p5_train width: losses "
        f"{mesh['loss']} vs meshless {plain['loss']}; gradient relative L2 "
        f"against the meshless step {diff:.3e}, between meshless runs up to "
        f"{spread:.3e} (limit 3x); worst leaf {leaf[0]:.2e} ({leaf[1]}), "
        f"between meshless runs up to {leaf_spread[0]:.2e}; ms per step "
        f"{ms_mesh:.1f} with the mesh, {ms_plain:.1f} without (median of "
        f"steps 2-{MESH_STEPS}); B1 launches {mesh['launches']}, B1' calls "
        f"{mesh['b1_backward']}")
    if backend != "nccl":
        fail(f"10a: the one-rank mesh runs on {backend}, expected nccl")
    later = max(abs(a - b) / abs(b) for a, b in zip(mesh["loss"], plain["loss"]))
    if mesh["loss"][0] != plain["loss"][0] or later > 1e-4 or diff > 3 * spread:
        fail("10a: the one-rank mesh step differs from the meshless one by "
             "more than the meshless step differs from itself")
    if mesh["launches"] != MESH_STEPS * T or mesh["b1_backward"] != MESH_STEPS * T:
        fail(f"10a: B1 {mesh['launches']} launches, B1' {mesh['b1_backward']} "
             f"calls, expected {MESH_STEPS * T} each")
    return {"loss": mesh["loss"], "loss_meshless": plain["loss"],
            "grad_rel_l2": diff, "meshless_rel_l2": spread,
            "worst_leaf": leaf[0], "meshless_worst_leaf": leaf_spread[0],
            "ms_per_step": ms_mesh, "ms_per_step_meshless": ms_plain,
            "launches": mesh["launches"], "b1_backward": mesh["b1_backward"]}


def mesh_engine_inputs():
    from dmm_net_tpu_torch.config import preset
    cfg = preset("p3_multi_object")
    H, W = cfg.model.image_size
    return cfg, make_stream(MESH_ENGINE["seed"], MESH_ENGINE["T"], 4,
                            cfg.matching.max_templates,
                            cfg.matching.max_proposals, H, W,
                            n_valid=MESH_ENGINE["n_valid"])


def mesh_det_model(device):
    """10d's detector from its seed, with the RPN delta kernel at 0 and the
    mask head's convolution biases at 3."""
    import torch
    from dmm_net_tpu_torch.models.proposal import MaskRCNN
    det = MaskRCNN(**MESH_DET["detector"], device=device, seed=MESH_DET["seed"])
    with torch.no_grad():
        det.rpn.bbox_pred.weight.zero_()
        for name, m in det.mask_head.named_children():
            if name.startswith("mask_fcn") and name != "mask_fcn_logits" or \
                    name == "conv5_mask":
                m.bias.fill_(3.0)
    return det.trainable_()


def mesh_det_batch():
    from dmm_net_tpu_torch.data.synthetic import synthetic_detection_frame
    from dmm_net_tpu_torch.train.proposal_loop import stack_detection_frames
    H, W = MESH_DET["detector"]["image_size"]
    frames = [synthetic_detection_frame(seed=s, H=H, W=W, max_objects=MESH_DET["G"],
                                        num_classes=3) for s in MESH_DET["frames"]]
    batch = stack_detection_frames(frames)
    batch["images"] = np.random.RandomState(MESH_DET["seed"]).rand(
        *batch["images"].shape).astype(np.float32)
    return batch


class KeepGrads:
    """An optimizer stand-in that keeps the gradients the step hands it."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = None

    def step(self):
        self.grads = [p.grad.detach().clone() for p in self.params]

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None


def mesh_det_step(mesh=None):
    """One detector train step (10d) on the batch, or this rank's rows of
    it: its metrics, gradients and B4 / B4' counts."""
    import torch
    from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                           reset_launch_counts)
    from dmm_net_tpu_torch.parallel import replicate_, shard_batch
    from dmm_net_tpu_torch.train.proposal_loop import (make_proposal_train_step,
                                                       proposal_batch_to)
    det = mesh_det_model("cuda" if mesh is None else mesh.device)
    if mesh is not None:
        replicate_(det, mesh)
    opt = KeepGrads(det.parameters())
    step = make_proposal_train_step(det, opt, mesh=mesh)
    batch = mesh_det_batch()
    b = proposal_batch_to(batch if mesh is None else shard_batch(batch, mesh),
                          det.device)
    torch.cuda.synchronize()
    reset_launch_counts()
    m = step(b)
    torch.cuda.synchronize()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": [g.cpu() for g in opt.grads],
            "launches": launch_counts()["roi_align"],
            "b4_backward": backward_calls()["roi_align"]}


def _two_ranks():
    """Phase 10b-10d on one of two ranks sharing the card (gloo)."""
    import torch
    import torch.distributed as dist
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmm_net_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    lead = mesh.rank == 0
    out = {"backend": dist.get_backend(), "rank": mesh.rank}
    p5 = mesh_train_run(mesh_p5_config(f32=True), mesh_p5_batch(), 1, mesh)
    small = mesh_train_run(mesh_p5_config(small=True), mesh_p5_batch(small=True),
                           1, mesh)
    for k, r in (("p5", p5), ("small", small)):
        r["grads"] = [g.cpu() for g in r["grads"]] if lead else None
        r["bn"] = {n: v.cpu() for n, v in r["bn"].items()} if lead else None
        out[k] = r
    cfg, (frames, tmpl, valid, items) = mesh_engine_inputs()
    engine = InferenceEngine(cfg, seed=0, mesh=mesh)
    K = MESH_ENGINE["K"]
    engine.run_stream_chunked(iter(items[:K]), tmpl, valid, frames[0], chunk=K)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with kept_logits(engine) as steps:
        res = engine.run_stream_chunked(iter(items), tmpl, valid, frames[0], chunk=K)
    out["engine"] = {"labels": res["labels"], "assignments": res["assignments"],
                     "seconds": time.perf_counter() - t0,
                     "launches": launch_counts(), "logits": stacked_logits(steps)}
    try:
        engine.run_stream_chunked(iter(items), tmpl[:3], valid[:3], frames[0][:3],
                                  chunk=K)
        out["engine"]["refusal"] = None
    except ValueError as e:
        out["engine"]["refusal"] = str(e)
    out["detector"] = mesh_det_step(mesh)
    if not lead:
        out["detector"]["grads"] = None
    return out


@contextlib.contextmanager
def kept_logits(engine):
    """Inside the block, each frame step of ``engine`` appends its
    (logits, tmpl_valid) to the list the block gets."""
    steps = []
    finish = engine._finish_step

    def keep(out, new_state, state, tmpl_valid):
        steps.append((out.logits, tmpl_valid))
        return finish(out, new_state, state, tmpl_valid)
    engine._finish_step = keep
    try:
        yield steps
    finally:
        del engine._finish_step


def stacked_logits(steps):
    """(T, B, M, h, w) float32 numpy of the kept steps' logits."""
    import torch
    return torch.stack([l.float() for l, _ in steps]).cpu().numpy()


def decided_pixels(steps, image_hw):
    """(T, B, H, W) bool from the logits and template validity of each of
    T frame steps: True where the best candidate (each valid object's
    logit upsampled bilinearly to ``image_hw``, and the background's 0)
    leads the second by more than LABEL_TIE."""
    import torch
    import torch.nn.functional as F
    out = []
    for logits, valid in steps:
        up = F.interpolate(logits.float(), image_hw, mode="bilinear",
                           align_corners=False)
        up = torch.where(valid[..., None, None], up, torch.full_like(up, -1e4))
        top2 = torch.cat([up, torch.zeros_like(up[:, :1])], 1).topk(2, dim=1).values
        out.append((top2[:, 0] - top2[:, 1] > LABEL_TIE).cpu().numpy())
    return np.stack(out)


def mesh_two_rank_path(engine):
    """Phases 10b-10d: two ranks sharing the card over gloo (10b p5_train
    width in float32 and the small train_bn configuration, 10c the p3
    engine, 10d the R-50-FPN detector's step), each against one process
    on the whole batch on the same card: ``engine`` is phase 4's."""
    import torch
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmm_net_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    r0, r1 = launch(_two_ranks, 2, "cuda")
    log(f"10b-10d: 2 ranks sharing the card over {r0['backend']} in "
        f"{time.perf_counter() - t0:.1f} s; two ranks on one card make no "
        "speed number: their times below are not data-parallel speed")
    if r0["backend"] != "gloo":
        fail(f"10b: two ranks on one card run on {r0['backend']}, expected gloo")
    T = MESH_P5["T"]
    res = {}
    for k, small in (("p5", False), ("small", True)):
        want = mesh_train_run(mesh_p5_config(small=small, f32=not small),
                              mesh_p5_batch(small=small), 1)
        got, other = r0[k], r1[k]
        rel = [abs(got[m][0] - want[m][0]) / abs(want[m][0])
               for m in ("loss", "grad_norm")]
        worst = grads_close(f"10b {k}", got["grads"], want["grads"],
                            want["names"], 1e-4)
        bn = max((float((got["bn"][n] - v.cpu()).abs().max()) for n, v in
                  want["bn"].items()), default=0.0)
        log(f"10b {k}: loss {got['loss'][0]:.6f} (both ranks "
            f"{other['loss'][0] == got['loss'][0]}) vs one process "
            f"{want['loss'][0]:.6f}, rel {rel[0]:.2e}; grad norm rel "
            f"{rel[1]:.2e}; worst gradient leaf {worst:.2e} (limit 1e-4); BN "
            f"running stats max |d| {bn:.2e}; per rank B1 {got['launches']} "
            f"launches, B1' {got['b1_backward']} calls")
        if max(rel) > 1e-4 or other["loss"] != got["loss"] or bn > 1e-5:
            fail(f"10b {k}: the two-rank step differs from one process")
        if k == "p5" and (got["launches"] != T or got["b1_backward"] != T):
            fail(f"10b: B1 {got['launches']} / B1' {got['b1_backward']} per "
                 f"rank, expected {T}")
        res[k] = {"loss_rel": rel[0], "grad_norm_rel": rel[1], "worst_leaf": worst,
                  "bn_max_abs": bn, "launches_per_rank": got["launches"],
                  "b1_backward_per_rank": got["b1_backward"]}

    cfg, (frames, tmpl, valid, items) = mesh_engine_inputs()
    K = MESH_ENGINE["K"]
    reset_launch_counts()
    with kept_logits(engine) as steps:
        want = engine.run_stream_chunked(iter(items), tmpl, valid, frames[0], chunk=K)
    single_counts = launch_counts()
    e0, e1 = r0["engine"], r1["engine"]
    # rank r holds sequences 2r and 2r+1; invalid slots are -1e4 in both
    want_logits = stacked_logits(steps)
    valid_steps = np.stack([v.cpu().numpy() for _, v in steps])[..., None, None]
    scale = float(np.abs(np.where(valid_steps, want_logits, 0.0)).max())
    ldiff = max(float(np.abs(e["logits"] - want_logits[:, 2 * r:2 * r + 2]).max())
                for r, e in enumerate((e0, e1)))
    decided = decided_pixels(steps, cfg.model.image_size)
    differ = e0["labels"] != want["labels"]
    mism = float(differ.mean())
    mism_decided = float(differ[decided].mean()) if decided.any() else float("nan")
    xdiff = float(np.abs(e0["assignments"] - want["assignments"]).max())
    log(f"10c engine, 2 ranks at full p3 width (B=4, K={K}, "
        f"{MESH_ENGINE['T']} frames): logits {e0['logits'].shape[1:]} per rank, "
        f"max |d| {ldiff:.2e} = {ldiff / scale:.2e} of their max |logit| "
        f"{scale:.4f} (limit {LOGIT_REL:.2e}); label mismatch vs one process "
        f"{mism:.2e} in all, {mism_decided:.2e} where decided "
        f"({decided.mean():.4f} of the pixels lead by > {LABEL_TIE}; floor "
        f"{DECIDED_FLOOR}), max |dX| {xdiff:.2e}, ranks equal "
        f"{np.array_equal(e0['labels'], e1['labels'])}; per rank launches "
        f"{e0['launches']} (one process: {single_counts}); refusal "
        f"{e0['refusal']!r}")
    if not (np.array_equal(e0["labels"], e1["labels"])
            and e0["labels"].shape == want["labels"].shape):
        fail("10c: the ranks' gathered labels differ or have the wrong shape")
    # tests/test_parallel.py's rule between partitionings: labels may flip
    # only on ties, assignments to 1e-5; here the logits themselves are
    # held everywhere and the decided labels must be equal
    if not (ldiff <= LOGIT_REL * scale and xdiff <= 1e-5
            and decided.mean() >= DECIDED_FLOOR and mism_decided == 0):
        fail(f"10c: against one process, logits max |d| {ldiff:.2e} (limit "
             f"{LOGIT_REL:.2e} x {scale:.4f}), max |dX| {xdiff:.2e} (limit 1e-5), "
             f"decided share {decided.mean():.4f} (floor {DECIDED_FLOOR}), "
             f"label mismatch where decided {mism_decided:.2e} (limit 0)")
    if e0["refusal"] != "sequence batch 3 not divisible by mesh data axis 2":
        fail(f"10c: a batch of 3 was not refused: {e0['refusal']!r}")
    expect_launches("10c rank 0", e0["launches"],
                    {"fused_pool_cost_match": MESH_ENGINE["T"],
                     "fused_resolve_upsample": MESH_ENGINE["T"]})
    res["engine"] = {"logits_max_abs": ldiff, "logits_max_rel": ldiff / scale,
                     "label_mismatch": mism, "label_mismatch_decided": mism_decided,
                     "decided_fraction": float(decided.mean()), "max_abs_dX": xdiff,
                     "launches_per_rank": {k: e0["launches"][k] for k in (
                         "fused_pool_cost_match", "fused_resolve_upsample")}}

    d0, want = r0["detector"], mesh_det_step()
    rel = {k: abs(v - want["metrics"][k]) / max(abs(want["metrics"][k]), 1e-12)
           for k, v in d0["metrics"].items() if k != "grad_norm"}
    l2 = _rel_l2(d0["grads"], want["grads"])
    log(f"10d detector, R-50-FPN 256x448 batch 2 on 2 ranks (one image each): "
        f"loss {d0['metrics']['loss']:.6f} vs one process "
        f"{want['metrics']['loss']:.6f}; worst part rel {max(rel.values()):.2e}; "
        f"gradient relative L2 {l2:.2e} (limit 1e-5); per rank B4 "
        f"{d0['launches']} launches, B4' {d0['b4_backward']} calls (one "
        f"process: {want['launches']} / {want['b4_backward']})")
    if max(rel.values()) > 1e-4 or not l2 < 1e-5:
        fail("10d: the two-rank detector step differs from one process")
    if d0["launches"] != 2 or d0["b4_backward"] != 2:
        fail(f"10d: B4 {d0['launches']} / B4' {d0['b4_backward']} per rank, "
             "expected 2 (one image per rank, one launch per head)")
    res["detector"] = {"loss_rel": rel["loss"], "grad_rel_l2": l2,
                       "launches_per_rank": d0["launches"],
                       "b4_backward_per_rank": d0["b4_backward"]}
    return res


def profiling_debug_path(engine):
    """Phase 10e: utils/profiling.trace around one p3 chunk (its Chrome
    trace must name B1's and B2's kernels), StageTimer over the chunk's
    stages, and utils/debug.checked raising on a NaN planted in B1's
    input."""
    import tempfile
    import torch
    from dmm_net_tpu_torch.kernels import fused_pool_cost_match
    from dmm_net_tpu_torch.utils.debug import checked
    from dmm_net_tpu_torch.utils.profiling import StageTimer, trace
    cfg, (frames, tmpl, valid, items) = mesh_engine_inputs()
    K = MESH_ENGINE["K"]
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            engine.run_stream_chunked(iter(items[:K]), tmpl, valid, frames[0],
                                      chunk=K)
        text = (Path(tmp) / "trace.json").read_text()
        size = len(text)
    named = {k: k in text for k in B1_KERNELS + (B2_KERNEL,)}
    timer = StageTimer()
    t_feats = engine._template_features(engine._t(frames[0]), engine._t(tmpl))
    state = engine.model.init_state(engine._t(tmpl))
    for c in range(MESH_ENGINE["T"] // K):
        chunk = items[c * K:(c + 1) * K]
        with timer.stage("stage items") as st:
            staged = [engine._t(np.stack([it[k] for it in chunk])) for k in
                      ("frame", "prop_boxes", "prop_masks28", "prop_valid")]
            st["sync"] = staged
        with timer.stage("chunk step") as st:
            labels, X, state = engine._chunk_step_compact(
                *staged, t_feats, engine._t(valid), state)
            st["sync"] = labels
    report = timer.report()
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = matcher_inputs(gen, 4, 16, 128, 448, 256, 4096)
    args[0][0, 0, 0] = float("nan")
    try:
        checked(fused_pool_cost_match)(*args)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    log(f"10e profiling.trace: a {size}-byte Chrome trace naming {named}; "
        f"StageTimer:\n{report}\n10e debug.checked on B1 with a NaN in emb: "
        f"{raised!r}")
    if not all(named.values()):
        fail(f"10e: the trace does not name every B1/B2 kernel: {named}")
    if set(timer.counts) != {"stage items", "chunk step"}:
        fail(f"10e: StageTimer stages {timer.counts}")
    if raised is None:
        fail("10e: debug.checked did not raise on B1's NaN output")
    return {"trace_bytes": size, "stages_ms": {k: 1e3 * v for k, v in
                                               timer.totals.items()}}


def torchvision_resnet_state_dict(rng, stage_sizes=(3, 4, 6, 3), width=64):
    """A seeded bottleneck ResNet state_dict in torchvision's layout."""
    sd = {}

    def conv(name, cin, cout, k):
        sd[f"{name}.weight"] = (rng.randn(cout, cin, k, k) * 0.05).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (rng.rand(c) + 0.5).astype(np.float32)
        sd[f"{name}.bias"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[f"{name}.running_mean"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[f"{name}.running_var"] = (rng.rand(c) + 0.5).astype(np.float32)

    conv("conv1", 3, width, 7)
    bn("bn1", width)
    cin = width
    for stage, n in enumerate(stage_sizes, start=1):
        planes = width * 2 ** (stage - 1)
        for j in range(n):
            tp = f"layer{stage}.{j}"
            for k, (a, b, ks) in enumerate(((cin, planes, 1), (planes, planes, 3),
                                            (planes, planes * 4, 1)), start=1):
                conv(f"{tp}.conv{k}", a, b, ks)
                bn(f"{tp}.bn{k}", b)
            if j == 0:
                conv(f"{tp}.downsample.0", cin, planes * 4, 1)
                bn(f"{tp}.downsample.1", planes * 4)
            cin = planes * 4
    return sd


def torchvision_maskrcnn_state_dict(seed, num_classes=81):
    """A seeded ``maskrcnn_resnet50_fpn`` state_dict in torchvision's layout
    (numpy values)."""
    rng = np.random.RandomState(seed)
    sd = {f"backbone.body.{k}": v
          for k, v in torchvision_resnet_state_dict(rng).items()}

    def layer(name, shape):
        sd[f"{name}.weight"] = (rng.randn(*shape) * 0.05).astype(np.float32)
        sd[f"{name}.bias"] = (rng.randn(shape[1] if "conv5_mask" in name
                                        else shape[0]) * 0.01).astype(np.float32)

    for i, c in enumerate((256, 512, 1024, 2048)):
        layer(f"backbone.fpn.inner_blocks.{i}", (256, c, 1, 1))
        layer(f"backbone.fpn.layer_blocks.{i}", (256, 256, 3, 3))
    layer("rpn.head.conv", (256, 256, 3, 3))
    layer("rpn.head.cls_logits", (3, 256, 1, 1))
    layer("rpn.head.bbox_pred", (12, 256, 1, 1))
    layer("roi_heads.box_head.fc6", (1024, 7 * 7 * 256))
    layer("roi_heads.box_head.fc7", (1024, 1024))
    layer("roi_heads.box_predictor.cls_score", (num_classes, 1024))
    layer("roi_heads.box_predictor.bbox_pred", (num_classes * 4, 1024))
    for i in range(1, 5):
        layer(f"roi_heads.mask_head.mask_fcn{i}", (256, 256, 3, 3))
    layer("roi_heads.mask_predictor.conv5_mask", (256, 256, 2, 2))   # (in, out)
    layer("roi_heads.mask_predictor.mask_fcn_logits", (num_classes, 256, 1, 1))
    return sd


def examples_importers_path(tmp):
    """Phase 10f: examples/train_synthetic_torch.py (the loss falls),
    infer_demo_torch.py on B1 and B2 (the matcher-aggregated J&F within 0.01
    of the JAX example's), matcher_only_torch.py (the p1 matcher on B1:
    accuracy over 0.9, B1 once per frame), train_and_eval_synthetic_torch.py
    --mrcnn for a few steps on a seeded detector's detections (B4 twice per
    detected frame), and a seeded torchvision-layout Mask R-CNN state dict
    through tools/import_maskrcnn_weights_torch.py into the full-width
    detector (R-50-FPN, 81 classes, 256x448), whose forward runs B4."""
    import importlib
    import importlib.util
    import torch
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmm_net_tpu_torch.models.proposal import MaskRCNN
    from dmm_net_tpu_torch.weights import load_flax_variables

    def example(name):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    res = {}
    reset_launch_counts()
    r = example("train_synthetic_torch").main(["--steps", "20", "--set",
                                                "matching.use_pallas=true"])
    res["train_synthetic"] = {"first_loss": r["losses"][0],
                              "last_loss": r["losses"][-1],
                              "step_ms": r["step_ms"],
                              "launches": launch_counts()["fused_pool_cost_match"]}
    log(f"10f train_synthetic_torch.py: loss {r['losses'][0]:.4f} -> "
        f"{r['losses'][-1]:.4f} in 20 steps, {r['step_ms']:.1f} ms per step, "
        f"B1 {res['train_synthetic']['launches']} launches")
    if not r["losses"][-1] < r["losses"][0]:
        fail("10f: train_synthetic_torch.py's loss did not fall")

    reset_launch_counts()
    r = example("infer_demo_torch").main(["--out", str(tmp / "demo"), "--set",
                                           "matching.use_pallas=true"])
    counts = launch_counts()
    res["infer_demo"] = {"aggregated_jf": r["aggregated"]["J&F"],
                         "oracle_jf": r["oracle"]["J&F"],
                         "jax_aggregated_jf": JAX_INFER_DEMO_AGG_JF,
                         "launches": {k: counts[k] for k in (
                             "fused_pool_cost_match", "fused_resolve_upsample")}}
    log(f"10f infer_demo_torch.py on B1/B2: matcher-aggregated J&F "
        f"{r['aggregated']['J&F']:.4f} (the JAX example's "
        f"{JAX_INFER_DEMO_AGG_JF}), proposal ceiling {r['oracle']['J&F']:.4f}, "
        f"launches {res['infer_demo']['launches']}")
    if abs(r["aggregated"]["J&F"] - JAX_INFER_DEMO_AGG_JF) > 0.01:
        fail("10f: infer_demo_torch.py's aggregated J&F is not the JAX "
             "example's")

    reset_launch_counts()
    r = example("matcher_only_torch").main(["--fixtures",
                                             str(tmp / "fixtures.npz")])
    n = launch_counts()["fused_pool_cost_match"]
    res["matcher_only"] = {"accuracy": r["accuracy"],
                           "ms_per_frame": r["ms_per_frame"], "launches": n}
    log(f"10f matcher_only_torch.py on B1: accuracy {r['accuracy']:.3f}, "
        f"{r['ms_per_frame']:.3f} ms per frame (host clock), B1 {n} launches")
    if n != 8 or not r["accuracy"] > 0.9:
        fail(f"10f: matcher_only_torch.py accuracy {r['accuracy']:.3f} or "
             f"{n} B1 launches (expected 8)")

    det_file = tmp / "det64.msgpack"
    importlib.import_module("train_proposal_torch").main(
        ["--steps", "0", "--image-size", "64", "64", "--num-classes", "4",
         "--save", str(det_file), "--logdir", str(tmp / "det_log")])
    reset_launch_counts()
    r = example("train_and_eval_synthetic_torch").main(
        ["--steps", "5", "--distinct-batches", "2", "--min-jf", "0",
         "--mrcnn", str(det_file)])
    n = launch_counts()["roi_align"]
    res["mrcnn_example"] = {"steps": r["steps"], "final_loss": r["final_loss"],
                            "roi_align_launches": n}
    log(f"10f train_and_eval_synthetic_torch.py --mrcnn: {r['steps']} steps on "
        f"detector proposals, last loss {r['final_loss']:.4f}, B4 {n} launches "
        "(2 batches x 4 clips x 3 frames x 2 heads)")
    if r["steps"] != 5 or n != 48 or not np.isfinite(r["final_loss"]):
        fail("10f: train_and_eval_synthetic_torch.py --mrcnn did not run")

    spec = importlib.util.spec_from_file_location(
        "import_maskrcnn_weights_torch",
        ROOT / "tools" / "import_maskrcnn_weights_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    params, stats = tool.load_torchvision_maskrcnn(
        torchvision_maskrcnn_state_dict(7601))
    det = MaskRCNN(image_size=(256, 448), num_classes=81, device="cuda")
    load_flax_variables(det, {"params": params, "batch_stats": stats})
    x = torch.rand(1, 3, 256, 448, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))
    reset_launch_counts()
    with torch.no_grad():
        out = det(x)
    torch.cuda.synchronize()
    n = launch_counts()["roi_align"]
    finite = all(bool(torch.isfinite(out[k]).all()) for k in ("boxes", "scores"))
    res["importer"] = {"roi_align_launches": n, "detections": int(out["valid"].sum())}
    log(f"10f a seeded torchvision-layout Mask R-CNN through the importer: "
        f"full-width forward, {res['importer']['detections']} detections, "
        f"finite {finite}, B4 {n} launches")
    if n != 2 or not finite:
        fail("10f: the imported detector's forward did not run on B4")
    return res

# ---------------------------------------------------------------------------
# phase 11: the native host path, the day-one drill, the artifact chain at
# full width, the three A/B tools
# ---------------------------------------------------------------------------

# 11c: the training stages of tools/regen_artifacts_torch.sh at full width,
# their depth cut and the DMM's and the system's J&F gates off through the
# script's own knobs (a full-depth run of the script holds them). The
# detector keeps 100 steps: the system's recall gate (0.9, fixed in the
# script as in the JAX one) needs a detector that has learned, and 100 steps
# gave recall 1.000 on an H100.
CHAIN_KNOBS = {"MRCNN_STEPS": "100", "DMM_STEPS": "10", "DMM_MIN_JF": "0",
               "SYS_MIN_JF": "0"}
# what the stages read, copied to a temporary root so that they write that
# root's runs/torch/ and never the checkout's
CHAIN_FILES = ("dmm_net_tpu_torch", "tools", "examples", "train_proposal_torch.py")
AB_DECODER_ARGS = ["--variants", "base", "objc3", "--steps", "20", "--size", "128",
                   "--backbone", "resnet18", "--seqs", "2", "--eval-frames", "4",
                   "--distinct-batches", "8"]


def reader_ms(root, cache, K=8):
    """Host ms per frame step of the p4 YouTube-VOS reader alone on phase
    6b's tree and cache (frame decode, the cached masks' RLE decode and
    resize), over the first K items of its first video; and the items."""
    import itertools
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.data.ytvos import YTVOSDataset
    cfg = preset("p4_ytvos_stream")
    ds = YTVOSDataset(str(root), image_size=cfg.model.image_size,
                      proposal_dir=str(cache), max_objects=cfg.matching.max_templates,
                      max_proposals=cfg.matching.max_proposals)
    sd = ds.sequence_stream(ds.videos[0])
    t0 = time.perf_counter()
    items = list(itertools.islice(sd["frames"], K))
    return (time.perf_counter() - t0) / len(items) * 1e3, items


def native_path(tmp, yt_root, yt_cache):
    """Phase 11a: the C++ host path. Where g++ finds libjpeg's and libpng's
    headers the loader must build and be used: a JPEG tree and phase 6b's
    PNG tree decoded natively and with PIL (frames within +-1, labels equal
    at their own size, batches equal to one-by-one decodes); otherwise the
    readers decode with PIL. The RLE codec (no dependency) must build: the
    cache CLI's masks decoded, re-encoded and intersected equal to the numpy
    codec. The p4 reader's host ms per step with each decoder and codec."""
    from dmm_net_tpu_torch.data import native_loader
    from dmm_net_tpu_torch.data.synthetic import write_native_davis_tree
    from dmm_net_tpu_torch.kernels import _build
    from dmm_net_tpu_torch.ops import rle
    missing = _build.host_headers_missing("imgloader")
    res = {"headers_missing": missing}
    log("11a g++ -E probe of the image loader's headers: "
        + ("jpeglib.h and png.h present" if not missing else f"missing {missing}"))
    if missing:
        if native_loader.available():
            fail("11a: the image loader built although its headers are missing")
        log(f"11a the native image loader cannot build here "
            f"({native_loader.reason().strip().splitlines()[-1]}); the readers "
            "decode with PIL in 11b-11d, as they say: "
            f"{native_loader.announce()}")
    else:
        if not native_loader.available():
            fail(f"11a: headers present but the image loader did not build: "
                 f"{native_loader.reason()}")
        root = Path(write_native_davis_tree(str(tmp / "DAVIS_11a"), T=3, seeds=(7001,)))
        frames = [str(p) for p in sorted((root / "JPEGImages").rglob("*.jpg"))]
        frames += [str(p) for p in sorted((Path(yt_root) / "valid" / "JPEGImages")
                                          .rglob("*.png"))[:6]]
        labels = [str(p) for p in sorted((root / "Annotations").rglob("*.png"))]
        labels += [str(p) for p in sorted((Path(yt_root) / "valid" / "Annotations")
                                          .rglob("*.png"))]
        hw = (256, 448)
        nat = native_loader.load_rgb_batch(frames, hw)
        one = np.stack([native_loader.load_rgb_batch([f], hw, threads=1)[0]
                        for f in frames])
        with pil_decode():
            pil = native_loader.load_rgb_batch(frames, hw)
            pil_labels = [native_loader.load_label_native_size(f) for f in labels]
        diff = int(np.abs(nat.astype(int) - pil).max())
        lab_eq = all(np.array_equal(native_loader.load_label_native_size(f), w)
                     for f, w in zip(labels, pil_labels))
        lab_batch = native_loader.load_label_batch(labels[:3], hw)
        lab_one = np.stack([native_loader.load_label_batch([f], hw, threads=1)[0]
                            for f in labels[:3]])
        log(f"11a native vs PIL on {len(frames)} frames (JPEG 854x480, PNG 640x360) "
            f"at 256x448: max |d| {diff} (limit 1); {len(labels)} labels at their "
            f"own size equal {lab_eq}; batches equal to one-by-one decodes "
            f"{np.array_equal(nat, one) and np.array_equal(lab_batch, lab_one)}")
        if diff > 1 or not lab_eq or not np.array_equal(nat, one) \
                or not np.array_equal(lab_batch, lab_one):
            fail("11a: the native loader disagrees with PIL or with itself")
        res.update(frames_max_abs_diff=diff, decoder=native_loader.announce())
    if not rle.available():
        fail(f"11a: the RLE codec did not build: {rle._REASON}")
    n, ious = 0, []
    for f in sorted(Path(yt_cache).rglob("*.json")):
        props = json.loads(f.read_text())
        for i, p in enumerate(props):
            counts = rle._counts(p["rle"])
            h, w = p["rle"]["size"]
            m = rle.decode_counts_plain(counts, h, w)
            if not (np.array_equal(rle.decode_counts(counts, h, w), m)
                    and np.array_equal(rle.encode_counts(m), counts)
                    and np.array_equal(rle.encode_counts_plain(m), counts)):
                fail(f"11a: the native RLE codec disagrees with numpy on {f.name}[{i}]")
            if i:
                a, b = rle.iou(props[i - 1]["rle"], p["rle"]), \
                    rle.iou_plain(props[i - 1]["rle"], p["rle"])
                if a != b:
                    fail(f"11a: native RLE IoU {a!r} != numpy {b!r}")
                ious.append(a)
            n += 1
    log(f"11a native RLE on the cache CLI's {n} masks: decode and encode equal to "
        f"the numpy codec, {len(ious)} IoUs equal bit for bit")
    res["rle_masks"] = n
    # the p4 reader's host time per step, each decoder and codec that builds
    times = {}
    decoders = ["pil"] + ([] if missing else ["native"])
    for dec in decoders:
        for codec in ("numpy", "native"):
            with (pil_decode() if dec == "pil" else contextlib.nullcontext()), \
                    (plain_path(rle) if codec == "numpy" else contextlib.nullcontext()):
                reader_ms(yt_root, yt_cache, K=2)              # warm-up
                times[f"{dec} decode, {codec} RLE"], _ = reader_ms(yt_root, yt_cache)
    log("11a p4 YouTube-VOS reader, host ms per frame step (8 steps of phase 6b's "
        "tree): " + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
        + ("" if not missing else "; native decode not measured (no headers)"))
    res["reader_ms"] = times
    return res


def fallback_drill_path(tmp):
    """Phase 11b: infer_torch.py with the git-tracked checkpoint on the
    day-one tree (data/synthetic.write_native_davis_tree, seed 7003, T=4,
    JPEG at 854x480, scored at native resolution, --chunk 4), as saved and
    on the kernels (B1 and B2 once per frame step): the dispatch chunked,
    J&F > 0.85 and within 0.01 of the JAX package's (its native decode,
    JAX_DAYONE_FALLBACK_JF)."""
    import infer_torch
    from dmm_net_tpu_torch.data import native_loader
    from dmm_net_tpu_torch.data.synthetic import write_native_davis_tree
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    root = write_native_davis_tree(str(tmp / "DAYONE"), **DAYONE_TREE)
    T = DAYONE_TREE["T"]
    jf, launches = {}, {}
    for run in CKPT_RUNS:
        reset_launch_counts()
        s = infer_torch.main(["--ckpt", str(ROOT / CKPT), "--davis-root", root,
                              "--out", str(tmp / f"dayone_{run}"), "--chunk", "4",
                              "--device", "cuda", "--set", *ckpt_sets(run)])
        n = 0 if run == "as_saved" else T
        launches[run] = expect_launches(f"11b fallback drill {run}", launch_counts(),
                                        {"fused_pool_cost_match": n,
                                         "fused_resolve_upsample": n})
        jf[run] = s["J&F"]
        d = jf[run] - JAX_DAYONE_FALLBACK_JF[run]
        log(f"11b fallback drill {run} ({native_loader.decoder()} decode): "
            f"dispatch {s['dispatch']}, {s['frames']} frames, J&F {jf[run]:.4f} "
            f"(gate > 0.85), JAX package {JAX_DAYONE_FALLBACK_JF[run]:.4f}, "
            f"difference {d:+.2e} (limit 0.01); launches {launches[run]}")
        if s["dispatch"] != "chunked_scan" or s["frames"] != T:
            fail(f"11b: dispatch {s['dispatch']} over {s['frames']} frames")
        if not (jf[run] > 0.85 and abs(d) <= 0.01):
            fail(f"11b fallback drill {run}: J&F {jf[run]:.4f}")
    return {"decoder": native_loader.decoder(), "jf": jf,
            "jax_jf": JAX_DAYONE_FALLBACK_JF, "launches": launches}


def chain_path(tmp):
    """Phase 11c: tools/regen_artifacts_torch.sh up to its drill, at full
    width (the detector R-18 256x448 4 classes, batch 2; the DMM R-50
    256x448 on its detections; the full system) with CHAIN_KNOBS, in a copy
    of the files it reads: every stage exits 0 and writes its file. Then
    the drill's commands (flagship_drill) on those files, without its gate:
    10 DMM steps make no flagship. Each stage's ms per step, peak memory
    and B1/B1'/B4/B4' counts."""
    import os
    import re
    import shutil
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    work = tmp / "chain"
    work.mkdir()
    for name in CHAIN_FILES:
        src = ROOT / name
        if src.is_dir():
            shutil.copytree(src, work / name, ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy2(src, work / name)
    script = work / "tools" / "regen_artifacts_torch.sh"
    text = script.read_text()
    cut = text.find("\nREQUIRE_ARTIFACTS=1")
    if cut < 0:
        fail("11c: no drill stage (REQUIRE_ARTIFACTS=1) in regen_artifacts_torch.sh")
    t0 = time.perf_counter()
    r = subprocess.run(["bash", "-c", text[:cut], str(script)],
                       env={**os.environ, **CHAIN_KNOBS}, capture_output=True,
                       text=True, timeout=900)
    wall = time.perf_counter() - t0
    out = r.stdout + "\n" + r.stderr
    if r.returncode != 0:
        fail(f"11c: tools/regen_artifacts_torch.sh exited {r.returncode}:\n"
             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    reports = [json.loads(ln[len("cuda: "):]) for ln in r.stdout.splitlines()
               if ln.startswith("cuda: ")]
    files = [work / "runs" / "torch" / "proposal_video448" / "mrcnn.msgpack",
             work / "runs" / "torch" / "dmm448" / "dmm.msgpack"]
    if len(reports) != 3 or not all(f.exists() for f in files):
        fail(f"11c: a stage wrote no report or file:\n{r.stdout[-3000:]}")

    def num(pattern):
        m = re.search(pattern, out)
        return float(m.group(1)) if m else None

    steps = int(CHAIN_KNOBS["MRCNN_STEPS"])
    stages = {
        "detector": {"ms_per_step": num(r"ms per step \(after the first\): ([0-9.]+)"),
                     **reports[0]},
        "dmm": {"ms_per_step": num(r"steps/sec: [0-9.]+ \(([0-9.]+) ms per step\)"),
                "jf": num(r"decoder \(trained \d+ steps\) J&F = ([0-9.]+)"),
                **reports[1]},
        "full_system": {"recall": num(r"detector-proposal recall@0.5 : ([0-9.]+)"),
                        "jf": num(r"J&F with DETECTOR proposals\s*: ([0-9.]+)"),
                        **reports[2]}}
    det, dmm, system = (stages[k] for k in ("detector", "dmm", "full_system"))
    want_b4 = 2 * 2 * steps                               # 2 heads x batch 2
    if det["launches"]["roi_align"] != want_b4 \
            or det["backward_calls"]["roi_align"] != want_b4:
        fail(f"11c detector: B4 {det['launches']['roi_align']} launches, B4' "
             f"{det['backward_calls']['roi_align']} calls, expected {want_b4}")
    if dmm["launches"]["roi_align"] != 2 * 64 * 4 * 3:   # 64 batches x 4 clips x 3
        fail(f"11c DMM: B4 {dmm['launches']['roi_align']} launches on the detected "
             "training frames, expected 1536")
    for k, st in (("detector", det), ("dmm", dmm), ("full_system", system)):
        log(f"11c {k}: " + ", ".join(
            f"{n} {v:.4g}" for n, v in st.items() if isinstance(v, float))
            + f"; launches {st['launches']}, backward calls {st['backward_calls']}")
    log(f"11c regen_artifacts_torch.sh up to its drill, {CHAIN_KNOBS}: every stage "
        f"exited 0, {[str(f.relative_to(work)) for f in files]} written; "
        f"{wall:.1f} s wall")
    (tmp / "drill_11c").mkdir()
    reset_launch_counts()
    summary, png_shape = flagship_drill(files[1], files[0], tmp / "drill_11c")
    drill = {"jf": summary["J&F"], "dispatch": summary["dispatch"],
             "frames": summary["frames"], "launches": launch_counts()}
    log(f"11c the drill's commands on these files: dispatch {drill['dispatch']}, "
        f"{drill['frames']} frames, J&F {drill['jf']:.4f} (no gate: "
        f"{CHAIN_KNOBS['DMM_STEPS']} DMM steps), first PNG {png_shape}; "
        f"launches {drill['launches']}")
    if drill["dispatch"] != "chunked_scan" or drill["frames"] != 4 \
            or png_shape != (256, 448) or drill["launches"]["roi_align"] != 2 * 4:
        fail("11c: the drill's commands did not run through (dispatch, frames, "
             "PNG shape, or B4 not twice per frame)")
    stages["drill"] = drill
    return {"wall_s": wall, "knobs": CHAIN_KNOBS, "stages": stages}, work


def ab_tools_path(tmp, work):
    """Phase 11d: the three A/B tools in this process. ab_logits_res_torch on
    the git-tracked checkpoint (6 videos x 6 frames); ab_480p_torch on 11c's
    files, then the same 480x864 tree and cache through infer_torch.py on
    the kernels, with B1, B2 and B4 held against their plain versions at
    these runs' 480x864 shapes; ab_decoder_arch_torch with 2 variants."""
    import contextlib
    import io
    import infer_torch
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmm_net_tpu_torch.models.dmm import mask_hw
    from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt
    res = {}

    def quiet(fn, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = fn(argv)
        return r, buf.getvalue().strip().splitlines()[-1]

    reset_launch_counts()
    r, line = quiet(load_tool("ab_logits_res_torch").main,
                    ["--ckpt", str(ROOT / CKPT), "--device", "cuda"])
    res["ab_logits_res"] = {**r, "launches": launch_counts()}
    log(f"11d ab_logits_res_torch: {line}")
    log(f"11d ab_logits_res_torch: J&F full {r['ab_logits_res']['full']['jf']:.4f}, "
        f"mask {r['ab_logits_res']['mask']['jf']:.4f}, difference (mask - full) "
        f"{np.mean(r['delta_per_seq']):+.4f}; launches {launch_counts()}")
    dmm = work / "runs" / "torch" / "dmm448" / "dmm.msgpack"
    mrcnn = work / "runs" / "torch" / "proposal_video448" / "mrcnn.msgpack"
    reset_launch_counts()
    r, line = quiet(load_tool("ab_480p_torch").main,
                    ["--dmm", str(dmm), "--mrcnn", str(mrcnn), "--workdir",
                     str(tmp / "ab480"), "--device", "cuda"])
    n_b4 = launch_counts()["roi_align"]
    log(f"11d ab_480p_torch on 11c's files: {line}; launches {launch_counts()}")
    frames = 2 * 4                                       # seeds 7001, 7002 x T=4
    if n_b4 != 2 * 2 * frames:                            # 2 heads, 2 geometries
        fail(f"11d ab_480p_torch: B4 {n_b4} launches, expected {4 * frames}")
    # the 480x864 run again on the kernels
    cfg0, _ = load_msgpack_ckpt(str(dmm))
    sets = ["model.image_size=480,864", *ckpt_sets("kernels")]
    reset_launch_counts()
    s = infer_torch.main(["--ckpt", str(dmm), "--davis-root", str(tmp / "ab480" / "DAVIS"),
                          "--proposal-dir", str(tmp / "ab480" / "props_480x864"),
                          "--out", str(tmp / "ab480" / "res_480x864_kernels"),
                          "--chunk", "4", "--device", "cuda", "--set", *sets])
    kl = expect_launches("11d 480x864 on the kernels", launch_counts(),
                         {"fused_pool_cost_match": frames,
                          "fused_resolve_upsample": frames})
    log(f"11d 480x864 on the kernels (--set {' '.join(sets)}): J&F {s['J&F']:.4f} "
        f"(as saved {r['ab_480p']['480x864']['J&F']:.4f}); launches {kl}")
    kcfg = cfg0.override(**{"model.image_size": (480, 864), **CKPT_RUNS["kernels"]})
    M, N = kcfg.matching.max_templates, kcfg.matching.max_proposals
    b1 = check_matcher("480x864", (1, M, N, 30 * 54, kcfg.model.feature_dim,
                                   int(np.prod(kcfg.cost.mask_size))),
                       timed=False, iters=kcfg.matching.sinkhorn_iters,
                       epsilon=kcfg.matching.epsilon)
    check_resolve("480x864", 1, M, *mask_hw(kcfg), 480, 864)
    b4 = {"box": check_multilevel("box (480x864, extract)", (7, 7), K=128,
                                  image=(480, 864), timed=False),
          "mask": check_multilevel("mask (480x864, extract, 8 detections)", (14, 14),
                                   K=8, image=(480, 864), timed=False)}
    res["ab_480p"] = {**r, "b4_launches": n_b4, "kernels_480x864": {
        "jf": s["J&F"], "launches": kl}, "b4_max_abs_err": b4, "b1_checked": b1}
    reset_launch_counts()
    r, line = quiet(load_tool("ab_decoder_arch_torch").main,
                    [*AB_DECODER_ARGS, "--device", "cuda"])
    res["ab_decoder_arch"] = {"result": r, "launches": launch_counts()}
    log(f"11d ab_decoder_arch_torch {' '.join(AB_DECODER_ARGS)}: {line}")
    return res


# Phase 12: the bench tools and graft_entry_torch.py. bench_torch.py at
# p3, B=16, K=16, full width, windows cut to 2 of 2 chunks; each
# bench/*_torch.py tool once at a small setting; graft_entry_torch.entry()
# twice, its state fed back; dryrun_multichip(2) on two ranks sharing the
# card (gloo).
BENCH_ENV = {"BENCH_MODE": "chunked_scan", "BENCH_PRESET": "p3_multi_object",
             "BENCH_BATCH": "16", "BENCH_CHUNK": "16", "BENCH_ITERS": "2",
             "BENCH_WINDOWS": "2", "BENCH_SET": "", "BENCH_DEVICE": ""}
# 12a holds the bench's X on the kernels to X on the plain matcher at the
# 1e-5 that 10c and the graft-entry test hold X to, not at the bench's own
# 5e-3 (bench.py's): that is about the size of one entry of X at N=128
# (1/N = 0.008) and would let a wrong B1 pass.
BENCH_PARITY = 1e-5
# 12b: each prefix of the breakdown does the work of the one before, so
# its device time may fall short of it by no more than timing noise (B2,
# the last stage, takes ~0.01 ms; a delta of -0.011 ms was seen at B=8).
BREAKDOWN_NOISE_MS = 0.05
BENCH_TOOLS = {   # name -> (argv, environment)
    "bench_matcher_torch": ([], {}),
    "bench_e2e_torch": (["--pallas", "--batches", "2", "--iters", "3"], {}),
    "bench_breakdown_torch": ([], {"BENCH_BATCH": "2", "BENCH_ITERS": "3"}),
    "bench_opprofile_torch": (["--calls", "1", "--top", "10"],
                              {"BENCH_BATCH": "2", "BENCH_CHUNK": "4"}),
    "bench_stream_torch": (["--frames", "8", "--chunk", "4"], {}),
    "bench_loader_torch": (["--files", "16", "--reps", "1"], {}),
    "bench_convmarginal_torch": ([], {"BENCH_REPS": "5", "BENCH_DEPTH": "3"}),
    "bench_objpack_torch": ([], {"BENCH_REPS": "5"}),
    "bench_roi_align_torch": (["--backward", "--calls", "20"], {}),
}
# 12b tools run in a process of their own: their timer, torch.profiler,
# has recorded no device time at all in this script's long process (after
# its many earlier profiles), and the tool raises where it records none.
BENCH_TOOLS_OWN_PROCESS = ("bench_roi_align_torch",)


@contextlib.contextmanager
def environ(env):
    """os.environ with ``env`` set (an empty value unsets) inside the block."""
    import os
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v:
            os.environ[k] = v
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bench_path(smi):
    """Phase 12a: bench_torch.main() at BENCH_ENV: one JSON line naming this
    card and its power limit, parity < BENCH_PARITY, frames/s > 0, the bf16 and
    memory-rate shares in (0, 100], B1 and B2 exactly as often as its
    parity check, warm-up, windows and FLOP count call them."""
    import io
    import bench_torch
    import torch
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with environ(BENCH_ENV), contextlib.redirect_stdout(buf):
        r = bench_torch.main()
    secs = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()
    if len(line) != 1 or json.loads(line[0]) != r:
        fail(f"12a bench_torch.py printed {len(line)} lines, expected its JSON line")
    K, windows, iters = (int(BENCH_ENV[k]) for k in
                         ("BENCH_CHUNK", "BENCH_WINDOWS", "BENCH_ITERS"))
    steps = K * (1 + windows * iters) + 1            # warm chunk, windows, count
    counts = expect_launches("12a bench_torch.py", launch_counts(),
                             {"fused_pool_cost_match": steps + 1,  # + parity
                              "fused_resolve_upsample": steps})
    log(f"12a bench_torch.py ({secs:.1f} s): {line[0]}")
    watts = float(smi.rsplit(",", 1)[1].split()[0])
    checks = {
        "device": r["device"] == torch.cuda.get_device_name(0),
        "power_limit_w": r["power_limit_w"] == watts,
        "parity": r["pallas_parity_max_abs"] < BENCH_PARITY,
        "fps": r["value"] > 0 and len(r["fps_windows"]) == windows,
        "mfu": 0 < r["mfu_pct_bf16_peak"] <= 100,
        "hbm_hand": 0 < r["hbm_roofline_pct_hand"] <= 100}
    if not all(checks.values()):
        fail(f"12a bench_torch.py: {[k for k, ok in checks.items() if not ok]} "
             f"off in {r}")
    return {**r, "seconds": secs, "launches": counts}


def bench_tools_path():
    """Phase 12b: each bench/*_torch.py main(argv) once at BENCH_TOOLS'
    setting on the card (those of BENCH_TOOLS_OWN_PROCESS in a child
    process), its output to the log, its launches counted; the breakdown's
    prefixes nest in device time (BREAKDOWN_NOISE_MS)."""
    import io
    out = {}
    for name, (argv, env) in BENCH_TOOLS.items():
        from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        if name in BENCH_TOOLS_OWN_PROCESS:
            r, counts, text = tool_in_own_process(name, argv, env)
        else:
            with environ(env), contextlib.redirect_stdout(buf):
                r = load_tool(name, "bench").main(argv)
            counts, text = launch_counts(), buf.getvalue().strip()
        secs = time.perf_counter() - t0
        log(f"12b {name} {' '.join(argv)} {env} ({secs:.1f} s; launches {counts}):\n"
            + "\n".join(f"    {x}" for x in text.splitlines()[:24]))
        if name == "bench_breakdown_torch" and not all(
                row["device_ms"] is not None and row["delta_ms"] > -BREAKDOWN_NOISE_MS
                for row in r):
            fail(f"12b {name}: the prefixes' device times do not nest: {r}")
        if name == "bench_loader_torch":
            from dmm_net_tpu_torch.data import native_loader
            if (r["native"] is None) != (not native_loader.available()):
                fail(f"12b {name}: a native number without the native loader")
        out[name] = {"result": r, "seconds": secs, "launches": counts}
    return out


def tool_in_own_process(name, argv, env):
    """bench/<name>.py's main(argv) in a child process on the card: its
    result, its launch counts and its printout; fatal if it fails."""
    import os
    code = ("import json, chip_smoke\n"
            "from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts\n"
            "reset_launch_counts()\n"
            f"r = chip_smoke.load_tool({name!r}, 'bench').main({list(argv)!r})\n"
            "print(json.dumps({'result': r, 'launches': launch_counts()}))\n")
    with environ(env):
        p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True, timeout=600, env=dict(os.environ))
    if p.returncode:
        fail(f"12b {name} in its own process: exit {p.returncode}\n{p.stderr[-3000:]}")
    *lines, last = p.stdout.strip().splitlines()
    got = json.loads(last)
    return got["result"], got["launches"], "\n".join(lines)


def graft_entry_path():
    """Phase 12c: graft_entry_torch.entry() at full p3 width, the step run
    twice with its state fed back (B1 and B2 once per step; uint8 labels,
    X finite with valid rows summing to 1), then dryrun_multichip(2) on two
    ranks sharing the card over gloo (finite loss, the same on both,
    labels gathered for both sequences)."""
    import graft_entry_torch
    import torch
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    fn, args = graft_entry_torch.entry()
    reset_launch_counts()
    labels, X, state = fn(*args)
    labels, X, _ = fn(*args[:5], state)
    torch.cuda.synchronize()
    counts = expect_launches("12c entry", launch_counts(),
                             {"fused_pool_cost_match": 2,
                              "fused_resolve_upsample": 2})
    check_assignments("12c entry", X[None].cpu().numpy(), args[4].cpu().numpy(),
                      args[2][None].cpu().numpy(), 1e-4)
    if labels.dtype != torch.uint8 or tuple(labels.shape) != (1, 256, 448):
        fail(f"12c entry: labels {labels.dtype} {tuple(labels.shape)}")
    t0 = time.perf_counter()
    ranks = graft_entry_torch.dryrun_multichip(2)
    secs = time.perf_counter() - t0
    losses = [r["loss"] for r in ranks]
    if not (np.isfinite(losses).all() and losses[0] == losses[1]
            and all(r["labels_shape"][1] == 2 for r in ranks)):
        fail(f"12c dryrun_multichip(2): {ranks}")
    log(f"12c entry: 2 steps, labels {tuple(labels.shape)}, launches {counts}; "
        f"dryrun_multichip(2) on {ranks[0]['backend']} ({secs:.1f} s): loss "
        f"{losses[0]:.6f}, labels {ranks[0]['labels_shape']}, launches per rank "
        f"{[r['launches'] for r in ranks]}")
    return {"entry_launches": counts,
            "dryrun": {"seconds": secs, "backend": ranks[0]["backend"],
                       "loss": losses[0],
                       "launches_per_rank": [r["launches"] for r in ranks]}}


# Phase 13: the JAX package's orbax checkpoints (train.py's TrainState), read
# by the port's own reader (utils/ocdbt.py, with zstd through the system's
# libzstd; utils/checkpoint.py's zarr arrays and orbax tree) on a machine
# with no JAX, orbax or tensorstore. artifacts/orbax_jax_fixture/ was
# written on the CPU by the JAX package's Checkpointer
# (tests/torch_port_orbax_fixture.py): per run a directory of two step
# directories and a left-over unfinished save, the params those of
# orbax_fixture_module. digests.json holds each array leaf's sha256, and
# the JAX-computed next update of each run (make_optimizer's update with
# gradient orbax_fixture_tree(seed, scale)), held to ORBAX_UPDATE_REL
# (phase 7c's tolerance) in summed absolute values per parameter.
ORBAX_FIXTURE = ROOT / "artifacts" / "orbax_jax_fixture"
ORBAX_UPDATE_REL = 1e-4
ORBAX_PARAM_SHAPES = {"BatchNorm_0": {"bias": (32,), "scale": (32,)},
                      "Conv_0": {"bias": (32,), "kernel": (3, 3, 16, 32)},
                      "head": {"bias": (8,), "kernel": (32, 8)}}


def orbax_fixture_module(device):
    """The module whose parameters the orbax fixture's params are: a 3x3
    conv (flax Conv_0, HWIO), its BatchNorm (BatchNorm_0) and a dense head
    (head, (in, out))."""
    import torch
    from dmm_net_tpu_torch.models.layers import BatchNorm, Conv
    net = torch.nn.Module()
    net.conv0 = Conv(16, 32, 3)
    net.bn0 = BatchNorm(32)
    net.head = torch.nn.Linear(32, 8)
    return net.to(device)


def orbax_fixture_tree(seed: int, scale: float) -> dict:
    """A params-shaped tree in flax's layout (numpy float32, normal draws
    times ``scale``): the fixture's initial params and every gradient."""
    rng = np.random.RandomState(seed)
    return {m: {k: (rng.randn(*shape) * scale).astype(np.float32)
                for k, shape in sorted(leaves.items())}
            for m, leaves in sorted(ORBAX_PARAM_SHAPES.items())}


def _raw_bytes(t) -> bytes:
    """A tensor's bytes in C order, whatever its dtype."""
    import torch
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8) \
        .numpy().tobytes()


def orbax_leaf_digests(tree) -> dict:
    """{path: [shape, dtype, sha256 of the C-order bytes]} for every tensor
    leaf of a tree read by utils/checkpoint.read_orbax_state (dict keys and
    tuple indices joined by "/")."""
    import hashlib
    import torch
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif isinstance(node, torch.Tensor):
            out["/".join(path)] = [list(node.shape),
                                   str(node.dtype).replace("torch.", ""),
                                   hashlib.sha256(_raw_bytes(node)).hexdigest()]
        elif node is not None:
            raise TypeError(f"{'/'.join(path)}: a {type(node).__name__} leaf")

    walk(tree, ())
    return out


def orbax_fixture_update(tree, run: dict, device) -> dict:
    """A run's next update on ``device``: the fixture module's parameters
    and BN statistics from ``tree`` (a TrainState read from the fixture),
    make_optimizer's optax state into the port's Optimizer, one update
    with the run's recorded gradient. Per parameter: the summed absolute
    update and moments after it, and the count of updates applied."""
    import torch
    from dmm_net_tpu_torch.config import Config, TrainConfig
    from dmm_net_tpu_torch.train.loop import Optimizer
    from dmm_net_tpu_torch.weights import convert_flax_variables, load_flax_variables
    net = orbax_fixture_module(device)
    load_flax_variables(net, {"params": tree["params"], "batch_stats": {
        "BatchNorm_0": tree["batch_stats"]["BatchNorm_0"]}})
    opt = Optimizer(net.parameters(), Config(train=TrainConfig(**run["train"])))
    opt.load_optax_state(tree["opt_state"], net)
    names = [n for n, _ in net.named_parameters()]
    before = [p.detach().clone() for p in opt.params]
    grads = convert_flax_variables(
        {"params": orbax_fixture_tree(*run["next"]["gradient"])}, net)
    opt.update([grads[n].to(device) for n in names])

    def l1(x):
        return float(x.double().abs().sum())
    state = [opt.adamw.state[p] for p in opt.params]
    return {"count": opt.count,
            "update_l1": {n: l1(p.detach() - b)
                          for n, p, b in zip(names, opt.params, before)},
            "mu_l1": {n: l1(st["exp_avg"]) for n, st in zip(names, state)},
            "nu_l1": {n: l1(st["exp_avg_sq"]) for n, st in zip(names, state)}}


def orbax_update_error(got: dict, want: dict) -> float:
    """The largest relative error over every parameter's summed absolute
    update and moments (fatal if the counts differ)."""
    if got["count"] != want["count"]:
        fail(f"orbax fixture update: count {got['count']}, JAX {want['count']}")
    return max(abs(got[k][n] - w) / abs(w) for k in ("update_l1", "mu_l1", "nu_l1")
               for n, w in want[k].items())


def orbax_path(smi: str) -> dict:
    """Phase 13: every step of the orbax fixture read with the port's reader
    (host ms and MB/s), each leaf bit-equal to digests.json, the trees on
    the card and back unchanged, load_checkpoint's params (the serving
    route) those of the latest step, and each run's next update on the card
    against JAX's and the CPU's."""
    import torch
    from dmm_net_tpu_torch.utils.checkpoint import (checkpoint_kind, latest_orbax_step,
                                                    load_checkpoint, orbax_steps,
                                                    read_orbax_step)
    t_phase = time.perf_counter()
    want = json.loads((ORBAX_FIXTURE / "digests.json").read_text())
    steps = {}
    for run, spec in want["runs"].items():
        steps[run] = orbax_steps(str(ORBAX_FIXTURE / run))
        if steps[run] != sorted(int(s) for s in spec["steps"]):
            fail(f"orbax fixture {run}: steps {steps[run]}, expected "
                 f"{sorted(spec['steps'])} (the unfinished save is not one)")
    on_disk = sum(f.stat().st_size for run in steps for step in steps[run]
                  for f in (ORBAX_FIXTURE / run / str(step)).rglob("*")
                  if f.is_file())

    def read_all():
        """Every step read anew; (the trees, host seconds)."""
        t0, trees = time.perf_counter(), {}
        for run in steps:
            for step in steps[run]:
                try:
                    trees[run, step] = read_orbax_step(str(ORBAX_FIXTURE / run), step)
                except (RuntimeError, ValueError, KeyError) as e:
                    fail(f"orbax fixture {run} step {step}: {e}")
        return trees, time.perf_counter() - t0

    trees, first = read_all()            # loads libzstd, files cold or warm
    trees, secs = read_all()
    decoded = 0
    for (run, step), r in trees.items():
        spec = want["runs"][run]["steps"][str(step)]
        got = orbax_leaf_digests(r["state"])
        bad = sorted(set(got) ^ set(spec["leaves"])) or [
            p for p in sorted(got) if got[p] != spec["leaves"][p]]
        if bad:
            fail(f"orbax fixture {run} step {step}: leaf {bad[0]} differs from "
                 f"digests.json ({got.get(bad[0])} vs {spec['leaves'].get(bad[0])})")
        if r["extra"] != spec["extra"]:
            fail(f"orbax fixture {run} step {step}: extra {r['extra']}, expected "
                 f"{spec['extra']}")
        leaves = []

        def collect(node):
            if isinstance(node, dict):
                for v in node.values():
                    collect(v)
            elif isinstance(node, (tuple, list)):
                for v in node:
                    collect(v)
            elif isinstance(node, torch.Tensor):
                leaves.append(node)
        collect(r["state"])
        decoded += sum(t.numel() * t.element_size() for t in leaves)
        on_card = [t.cuda() for t in leaves]
        for t, c in zip(leaves, on_card):
            if c.dtype != t.dtype or _raw_bytes(c) != _raw_bytes(t):
                fail(f"orbax fixture {run} step {step}: a {t.dtype} leaf changed "
                     "on its way to the card and back")
    # the CLIs' route: infer_torch.py --ckpt serves load_checkpoint's params of
    # the latest step; train_torch.py --resume asks checkpoint_kind and
    # latest_orbax_step
    for run in steps:
        d = str(ORBAX_FIXTURE / run)
        try:
            kind, latest = checkpoint_kind(d), latest_orbax_step(d)
            cfg, served = load_checkpoint(d)
        except (RuntimeError, ValueError, KeyError) as e:
            fail(f"orbax fixture {run}: load_checkpoint: {e}")
        leaves = want["runs"][run]["steps"][str(steps[run][-1])]["leaves"]
        params = {p: v for p, v in leaves.items() if p.startswith("params/")}
        if (kind, latest, cfg, sorted(served)) != ("orbax", steps[run][-1], None,
                                                   ["params"]) \
                or orbax_leaf_digests({"params": served["params"]}) != params:
            fail(f"orbax fixture {run}: load_checkpoint gave {kind}, step {latest}, "
                 f"config {cfg}, {sorted(served)}, not the latest step's params")
    n_leaves = sum(len(want["runs"][r]["steps"][str(s)]["leaves"]) for r, s in trees)
    log(f"orbax reader: {len(trees)} steps, {n_leaves} leaves, {decoded / 1e6:.3f} "
        f"MB decoded from {on_disk / 1e6:.3f} MB on disk in {secs * 1e3:.1f} ms "
        f"host ({decoded / 1e6 / secs:.1f} MB/s decoded, {on_disk / 1e6 / secs:.1f} "
        f"MB/s read; the first read, loading libzstd, {first * 1e3:.1f} ms) on "
        f"{smi}; every leaf bit-equal to digests.json and unchanged through "
        "the card")
    updates = {}
    for run, spec in want["runs"].items():
        tree = trees[run, max(int(s) for s in spec["steps"])]["state"]
        card = orbax_fixture_update(tree, spec, "cuda")
        cpu = orbax_fixture_update(tree, spec, "cpu")
        d_jax = orbax_update_error(card, spec["next"])
        d_cpu = orbax_update_error(card, cpu)
        log(f"orbax fixture {run}: next update on the card at count "
            f"{card['count']}, max rel error {d_jax:.2e} against JAX, "
            f"{d_cpu:.2e} against the CPU (limit {ORBAX_UPDATE_REL})")
        if d_jax > ORBAX_UPDATE_REL or d_cpu > ORBAX_UPDATE_REL:
            fail(f"orbax fixture {run}: next update off by {d_jax:.2e} from "
                 f"JAX, {d_cpu:.2e} from the CPU")
        updates[run] = {"count": card["count"], "rel_err_jax": d_jax,
                        "rel_err_cpu": d_cpu}
    seconds = time.perf_counter() - t_phase
    log(f"phase 13: {seconds:.1f} s")
    return {"steps": len(trees), "leaves": n_leaves, "decoded_mb": decoded / 1e6,
            "on_disk_mb": on_disk / 1e6, "read_ms": secs * 1e3,
            "first_read_ms": first * 1e3,
            "decoded_mb_per_s": decoded / 1e6 / secs,
            "read_mb_per_s": on_disk / 1e6 / secs, "updates": updates,
            "seconds": seconds, "gpu": smi}


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
    t_start = time.perf_counter()

    def mark(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")
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
    b1_b4 = check_matcher("p3 B=4", (4, 16, 128, 448, 256, 4096))
    check_matcher("p4 B=4", (4, 32, 256, 448, 256, 4096))
    check_matcher("p3 B=4 annealed", (4, 16, 128, 448, 256, 4096), timed=False,
                  eps_init=0.5)
    check_matcher("p3 B=4 N=100", (4, 16, 100, 448, 256, 4096), timed=False)
    # B2 at p3 B=16 and the main path's B=4, p4's M=32, p3_480p, more valid
    # slots than one chunk, an unaligned non-integer scale, a dead element
    b2 = check_resolve("p3 B=16", 16, 16, 64, 112, 256, 448, timed=True)
    b2_b4 = check_resolve("p3 B=4", 4, 16, 64, 112, 256, 448, timed=True)
    b2_all = [b2, b2_b4] + [
        check_resolve("p4", 1, 32, 64, 112, 256, 448),
        check_resolve("p3_480p", 4, 16, 120, 216, 480, 864),
        check_resolve("M=40", 2, 40, 64, 112, 256, 448),
        check_resolve("unaligned", 2, 5, 17, 29, 67, 115),
        check_resolve("all-invalid element", 2, 16, 64, 112, 256, 448, dead=True)]
    for k in ("max_abs_err", "mismatch_frac"):     # the largest at any shape
        b2[k] = max(r[k] for r in b2_all)
    b3 = check_cost_match("B=16 P=4096", (16, 16, 128, 4096, 256))
    check_cost_match("unaligned", (1, 5, 37, 100, 48), timed=False)
    check_cost_match("p4", (1, 32, 256, 256, 64), timed=False)
    b4_single = max(check_roi_align(level, out_size) for level in (2, 3, 4, 5)
                    for out_size in ((7, 7), (14, 14)))
    b4 = {"box": check_multilevel("box", (7, 7)),
          "mask": check_multilevel("mask", (14, 14))}
    b4_img = {k: sum(r[k] for r in b4.values())
              for k in ("ms", "call_ms", "plain_ms", "bound_ms")}
    log(f"B4 per detector image (box head + mask head, 2 launches): kernel "
        f"{b4_img['ms']:.4f} ms, plain {b4_img['plain_ms']:.4f} ms, bound "
        f"{b4_img['bound_ms']:.4f} ms")

    mark("phases 2-3")
    counts, fps, engine = main_path()
    det_counts, det_ms, det_prof = detector_path(engine)
    legacy_launches, legacy = legacy_path()
    hp = {"hungarian": hungarian_path(), "pgd": pgd_path()}
    ckpt_jf, ckpt_launches = ckpt_path()
    cli_jf = cli_on_card()
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        yt_root, yt_cache, ex_counts, ex_ms = extract_path(tmp)
        p4_launches, p4 = ytvos_p4_path(tmp, yt_root, yt_cache)
        yt_g, yt_launches = ytvos_ckpt_path(tmp)
        native11 = native_path(tmp, yt_root, yt_cache)          # 11a on 6b's tree
        mark("phases 4-6, 11a")
        b1_bwd = b1_backward_check()
        p5_counts, p5_bwd_calls, p5 = p5_train_path(tmp)
    ckpt_train, ckpt_train_launches, ckpt_train_bwd_calls = ckpt_train_path()
    example = example_path()
    mark("phase 7")
    b4_extract = check_multilevel("mask (extract_proposals, 64 detections)",
                                  (14, 14), K=64, timed=False)
    small_reference()
    small_detector_reference()
    mark("phase 8")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        b4_bwd, b4_bwd_image = b4_backward_check()
        r50_counts, r50_bwd, r50_extract_counts, r50 = proposal_train_path(tmp)
        steps9c, steps9c_counts, steps9c_bwd = proposal_steps_path()
        learn_file, learn_counts, learn_bwd, learn = learning_path(tmp)
        system, system_launches = full_system_path(learn_file)
    dcn_counts, dcn_bwd, dcn = dcn_path()
    mark("phase 9")
    mesh = {"one_rank_10a": mesh_one_rank_path(), **mesh_two_rank_path(engine)}
    prof10 = profiling_debug_path(engine)
    with tempfile.TemporaryDirectory() as tmp:
        ex10 = examples_importers_path(Path(tmp))
    mark("phase 10")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        drill11 = fallback_drill_path(tmp)
        mark("phase 11b")
        chain11, work = chain_path(tmp)
        mark("phase 11c")
        ab11 = ab_tools_path(tmp, work)
    mark("phase 11d")
    bench12 = bench_path(smi)
    tools12 = bench_tools_path()
    entry12 = graft_entry_path()
    mark("phase 12")
    orbax13 = orbax_path(smi)
    mark("phase 13")
    ab_l, ab_480 = ab11["ab_logits_res"]["launches"], ab11["ab_480p"]
    chain = chain11["stages"]

    def by_path(k):
        return {"p3_stream": counts[k], "legacy_p3": legacy_launches[k],
                "hungarian_p3": hp["hungarian"]["launches"][k],
                "pgd_p3": hp["pgd"]["launches"][k],
                "ckpt_kernels": ckpt_launches["kernels"][k],
                "ytvos_p4": p4_launches[k],
                "ytvos_ckpt_kernels": yt_launches["kernels"][k],
                "p5_train": p5_counts[k],
                "ckpt_train_kernels": ckpt_train_launches["kernels"][k],
                "full_system_kernels_9e": system_launches["kernels"][k],
                "dayone_fallback_kernels_11b": drill11["launches"]["kernels"][k],
                "chain_11c": sum(st["launches"][k] for st in chain.values()
                                 if "launches" in st),
                "ab_logits_res_11d": ab_l[k],
                "ab_480p_kernels_480x864_11d": ab_480["kernels_480x864"]["launches"][k],
                "ab_decoder_arch_11d": ab11["ab_decoder_arch"]["launches"][k],
                "bench_torch_12a": bench12["launches"][k],
                **{f"{name}_12b": t["launches"][k] for name, t in tools12.items()
                   if t["launches"][k]},
                "graft_entry_12c": entry12["entry_launches"][k],
                "dryrun_multichip_12c_per_rank":
                    entry12["dryrun"]["launches_per_rank"][0][k]}

    def mesh_by_path(k):
        """Phase 10's launches; a rank of 10b-10d counts its own."""
        b1 = {"mesh_p5_train_1rank_10a": mesh["one_rank_10a"]["launches"],
              "mesh_p5_train_2rank_10b_per_rank": mesh["p5"]["launches_per_rank"],
              "mesh_engine_10c_per_rank":
                  mesh["engine"]["launches_per_rank"]["fused_pool_cost_match"],
              "train_synthetic_10f": ex10["train_synthetic"]["launches"],
              "infer_demo_10f":
                  ex10["infer_demo"]["launches"]["fused_pool_cost_match"],
              "matcher_only_10f": ex10["matcher_only"]["launches"]}
        b2 = {"mesh_engine_10c_per_rank":
                  mesh["engine"]["launches_per_rank"]["fused_resolve_upsample"],
              "infer_demo_10f":
                  ex10["infer_demo"]["launches"]["fused_resolve_upsample"]}
        b4 = {"mesh_detector_10d_per_rank": mesh["detector"]["launches_per_rank"],
              "mrcnn_example_10f": ex10["mrcnn_example"]["roi_align_launches"],
              "importer_10f": ex10["importer"]["roi_align_launches"]}
        return {"fused_pool_cost_match": b1, "fused_resolve_upsample": b2,
                "roi_align": b4}[k]

    kernels = [
        dict(name="fused_pool_cost_match", route="cuda",
             source="dmm_net_tpu_torch/csrc/matcher.cu",
             replaces="dmm_net_tpu/kernels/matcher.py:262",
             launches=counts["fused_pool_cost_match"], shape="p3 B=16",
             launches_by_path={**by_path("fused_pool_cost_match"),
                               **mesh_by_path("fused_pool_cost_match")},
             library_ms=None, batch4={k: b1_b4[k] for k in (
                 "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                 "launch_ms", "sinkhorn_iter_ms")},
             **b1),
        dict(name="fused_resolve_upsample", route="cuda",
             source="dmm_net_tpu_torch/csrc/resolve.cu",
             replaces="dmm_net_tpu/kernels/resolve.py:117",
             launches=counts["fused_resolve_upsample"], shape="p3 B=16",
             launches_by_path={**{k: v for k, v in by_path(
                 "fused_resolve_upsample").items() if "train" not in k},
                 **mesh_by_path("fused_resolve_upsample")},
             library_ms=None, batch4={k: b2_b4[k] for k in (
                 "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                 "valid_slots")}, **b2),
        dict(name="fused_cost_match", route="cuda",
             source="dmm_net_tpu_torch/csrc/matcher.cu",
             replaces="dmm_net_tpu/kernels/matcher.py:170",
             launches=counts["fused_cost_match"], shape="B=16 M=16 N=128 P=4096 D=256",
             note="no caller on any path of either package", library_ms=None, **b3),
        dict(name="roi_align", route="cuda",
             source="dmm_net_tpu_torch/csrc/roi_align.cu",
             replaces="dmm_net_tpu/kernels/roi_align.py:65",
             launches=det_counts["roi_align"],
             shape="per detector image: box head K=128 -> 7x7 + mask head "
                   "K=128 -> 14x14, C=256, 256x448 pyramid",
             path="detector (phases 4b, 6a and 9); 2 launches per detector image",
             launches_by_path={"detector_4b": det_counts["roi_align"],
                               "extract_proposals": ex_counts["roi_align"],
                               "r50_train_9b": r50_counts["roi_align"],
                               "r50_extract_9b": r50_extract_counts["roi_align"],
                               "train_steps_9c": steps9c_counts["roi_align"],
                               "learning_9d": learn_counts["roi_align"],
                               **{f"full_system_{k}_9e": v["roi_align"]
                                  for k, v in system_launches.items()},
                               "dcn_9f": dcn_counts["roi_align"],
                               **mesh_by_path("roi_align"),
                               **{f"chain_{k}_11c": chain[k]["launches"]["roi_align"]
                                  for k in ("detector", "dmm", "full_system", "drill")},
                               "ab_480p_11d": ab_480["b4_launches"]},
             max_abs_err=max(b4["box"]["max_abs_err"], b4["mask"]["max_abs_err"],
                             b4_extract),
             single_level_max_abs_err=b4_single,
             image_ms=b4_img["ms"], image_bound_ms=b4_img["bound_ms"],
             heads=b4, library_ms=None,
             bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in b4.values())
                       else "operations"),
             **{k: b4_img[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms")}),
        dict(name="fused_pool_cost_match_backward", route="cuda",
             source="dmm_net_tpu_torch/csrc/matcher.cu",
             replaces="dmm_net_tpu/kernels/matcher.py:302",
             launches=p5_counts["fused_pool_cost_match_backward"],
             shape="p5_train B=4 M=8 N=64 P=448 D=256 Pc=4096, epsilon 0.03",
             path="p5_train (phase 7b): one launch per frame of a train step",
             launches_by_path={
                 "p5_train": p5_counts["fused_pool_cost_match_backward"],
                 "ckpt_train_kernels":
                     ckpt_train_launches["kernels"]["fused_pool_cost_match_backward"]},
             backward_calls_by_path={
                 "p5_train": p5_bwd_calls, "ckpt_train_kernels": ckpt_train_bwd_calls,
                 "mesh_p5_train_1rank_10a": mesh["one_rank_10a"]["b1_backward"],
                 "mesh_p5_train_2rank_10b_per_rank": mesh["p5"]["b1_backward_per_rank"],
                 "chain_dmm_11c":
                     chain["dmm"]["backward_calls"]["fused_pool_cost_match"]},
             note="ms: the backward on the device, matcher_sweep_kernel "
                  "(sweep_ms) and matcher_tail_kernel (tail_ms), kernel_ms "
                  "their sum, and the four products as torch.bmm / baddbmm "
                  "(products_ms); launches count backward calls (two kernels "
                  "each); plain_ms: the old route, autograd through "
                  "the plain version (its forward again and its VJP)",
             library_ms=None, cases={k: b1_bwd[k] for k in ("p3", "p4")},
             **b1_bwd["p5"]),
        dict(name="roi_align_backward", route="cuda",
             source="dmm_net_tpu_torch/csrc/roi_align.cu",
             replaces="dmm_net_tpu/models/proposal/maskrcnn.py:96",
             launches=r50_counts["roi_align_backward"],
             shape="per train image: box head K=32 -> 7x7 + mask head K=32 "
                   "-> 14x14, C=256, 256x448 pyramid",
             path="detector training (phase 9b): 2 launches per train image",
             launches_by_path={"r50_train_9b": r50_counts["roi_align_backward"],
                               "train_steps_9c": steps9c_counts["roi_align_backward"],
                               "learning_9d": learn_counts["roi_align_backward"],
                               "dcn_9f": dcn_counts["roi_align_backward"]},
             backward_calls_by_path={
                 "r50_train_9b": r50_bwd, "train_steps_9c": steps9c_bwd,
                 "learning_9d": learn_bwd, "dcn_9f": dcn_bwd,
                 "mesh_detector_10d_per_rank": mesh["detector"]["b4_backward_per_rank"],
                 "chain_detector_11c": chain["detector"]["backward_calls"]["roi_align"]},
             note="ms: roi_align_backward_prep_kernel and "
                  "roi_align_backward_kernel on the device per train image; "
                  "launches count backward calls (two kernels each); plain_ms: "
                  "the old route, autograd through the plain version (all four "
                  "levels again and their VJP)",
             library_ms=None,
             max_abs_err=max(r["max_abs_err"] for r in b4_bwd.values()),
             grad_rel_err=max(r["grad_rel_err"] for r in b4_bwd.values()),
             bit_equal=all(r["bit_equal"] for r in b4_bwd.values()),
             heads={f"K={k} {h}": r for (k, h), r in b4_bwd.items()},
             bound_by=("bytes" if all(r["bound_by"] == "bytes"
                                      for r in b4_bwd.values()) else "operations"),
             **b4_bwd_image),
    ]
    print(json.dumps({"kernels": kernels, "frames_per_s": fps,
                      "detector_ms_per_image": det_ms,
                      "detector_profile": det_prof, "legacy_p3": legacy,
                      "hungarian_p3": hp["hungarian"], "pgd_p3": hp["pgd"],
                      "ckpt_jf": ckpt_jf, "jax_ckpt_jf": JAX_CKPT_JF,
                      "cli_jf": cli_jf, "extract_ms_per_frame": ex_ms,
                      "ytvos_p4": p4, "ytvos_g": yt_g,
                      "jax_ytvos_g": JAX_YTVOS_G, "p5_train": {
                          k: v for k, v in p5.items() if k != "profile"},
                      "ckpt_train": ckpt_train, "jax_train_steps": JAX_TRAIN_STEPS,
                      "example": example,
                      "detector_train_r50": {k: v for k, v in r50.items()
                                             if k != "profile"},
                      "detector_train_steps": steps9c,
                      "jax_proposal_steps": JAX_PROPOSAL_STEPS,
                      "detector_learning": learn, "learn_floors": LEARN_FLOORS,
                      "full_system": system,
                      "jax_full_system_planted_jf": JAX_FULL_SYSTEM_PLANTED_JF,
                      "full_system_floors": FULL_SYSTEM_FLOORS,
                      "dcn": dcn, "mesh_10a_10d": mesh,
                      "profiling_10e": prof10, "examples_10f": ex10,
                      "native_11a": native11, "dayone_11b": drill11,
                      "chain_11c": chain11, "ab_tools_11d": {
                          "ab_logits_res": ab11["ab_logits_res"],
                          "ab_480p": {k: v for k, v in ab_480.items()},
                          "ab_decoder_arch": ab11["ab_decoder_arch"]},
                      "bench_torch_12a": bench12,
                      "bench_tools_12b": {k: {kk: vv for kk, vv in v.items()
                                              if kk != "result"}
                                          for k, v in tools12.items()},
                      "graft_entry_12c": entry12, "orbax_13": orbax13}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
