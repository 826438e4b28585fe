"""A ``video_offline`` cell: offline requests through
``InferenceEngine.run_stream_chunked``, closed loop, one request after
another.

Set-up: the engine and the weights (made on the device from the seed), the
request bank on the device, and one request of the mix's longest length
(every shape and the largest allocation the window will meet). The
window: requests in the seed's order until ``--seconds`` have passed; the
request that is running then stops taking frames (the engine finishes what
it was given), and the window closes at a synchronize. ``frames_per_s`` is
every video frame whose labels came back over the window's wall time.

``correct``: a sample of the window's requests, drawn from the seed, run
again by the plain reference on the same inputs and weights, once the
window has closed and the program's state is freed. Compared are the share
of label pixels that differ among the decisive ones (those whose reference
label is more than ``decisive_margin`` of its logit from changing; random
weights leave many pixels near a tie between objects, where a rounding
upstream decides), and the mean gap of the assignment X that B1 produced
over the valid (template, proposal) pairs of every frame. X's largest gap
is printed, not compared: the frames carry a rounding forward (X is rounded
to bf16 for the aggregation, the templates follow the logits), so a sound
request can read it above the control's.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import common, formulas, spec, traffic, tracing
from benchmark.harness.weights import make_state_dict
from benchmark.reference.infer import run_request
from benchmark.reference.model import FrameStep, bucket

# the compared numbers, each the worst over the requests checked
NUMBERS = ("label_mismatch_pct", "assignment_mean_gap")


def _serve(engine, bank, req, B, K, stop=None):
    """One request; returns (the engine's output, frames taken). With
    ``stop``, the request takes no further frame once it returns True (it
    always takes the first)."""
    items, tm, tv, f0 = traffic.request_inputs(bank, req, B, req.T)
    taken = [0]

    def stream():
        for t, item in enumerate(items):
            if t and stop is not None and stop():
                return
            taken[0] += 1
            yield item
    out = engine.run_stream_chunked(stream(), tm, tv, f0, chunk=K)
    return out, taken[0]


def _b1_b2_work(bank, req, B, T, sz, cfg):
    """The operations and least seconds of the request's B1 and B2 calls
    (one of each per frame step), from the request's own validity masks."""
    sl = slice(req.start, req.start + B)
    tv = bank.tmpl_valid[sl]
    M_b = bucket(int(tv.sum(1).max()), tv.shape[1])
    counts = torch.as_tensor(tv[:, :M_b].sum(1), device=bank.valid.device)
    H, W = sz["image_hw"]
    h, w = sz["mask_hw"]
    N, P, D = sz["N"], (H // 16) * (W // 16), cfg["cost"]["feature_dim"]
    Pc = int(np.prod(cfg["cost"]["mask_size"]))
    iters = cfg["matching"]["sinkhorn_iters"]
    nv = bank.valid[sl, :T].sum(-1)                                  # (B, T)
    pairs = (counts[:, None] * nv).sum(0).tolist()
    b1_ops = [formulas.pool_cost_match_ops(B, M_b, N, P, D, Pc, iters, int(p)) for p in pairs]
    b1_by = formulas.b1_bytes(B, M_b, N, P, D, Pc)
    mv = int(counts.sum())
    b2_ops = formulas.resolve_upsample_ops(mv, h, H, W)
    b2_by = formulas.b2_bytes(B, M_b, mv, h, w, H, W)
    return {"b1_ops": sum(b1_ops), "b2_ops": T * b2_ops,
            "b1_bound_s": sum(formulas.bound_s(b1_by, o)[0] for o in b1_ops),
            "b1_bound_kind": formulas.bound_s(b1_by, b1_ops[0])[1],
            "b2_bound_s": T * formulas.bound_s(b2_by, b2_ops)[0],
            "b2_bound_kind": formulas.bound_s(b2_by, b2_ops)[1]}


def _count_flops(engine, bank, req, B, K, work):
    """FLOPs of one request: FlopCounterMode over what it dispatches, plus
    the B1 and B2 launches, which the counter cannot see (on the CPU the
    plain versions run as ordinary ops and it sees them)."""
    from torch.utils.flop_counter import FlopCounterMode

    from dmm_net_tpu_torch.kernels import launch_counts
    before = launch_counts()
    with FlopCounterMode(display=False) as counter:
        _serve(engine, bank, req, B, K)
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    flops = float(counter.get_total_flops())
    if launched["fused_pool_cost_match"]:
        flops += work["b1_ops"]
    if launched["fused_resolve_upsample"]:
        flops += work["b2_ops"]
    return flops


def run(cell: spec.Cell, args, t_start: float) -> None:
    from dmm_net_tpu_torch.config import config_from_dict
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.models.dmm import DMMNet

    dev = torch.device("cpu" if cell.rehearse else "cuda")
    cd = spec.config_dict(cell)
    cfg = config_from_dict(cd)
    p = spec.traffic_params(cell)
    sz = spec.sizes(cd, p, cell.chips)
    B, K = p["batch_videos"], p["chunk"]

    with torch.device("meta"):
        sd_layout = FrameStep(cd)
    sd = make_state_dict(sd_layout, args.seed, dev)
    model = DMMNet(cfg, device=dev)
    model.load_state_dict(sd)
    engine = InferenceEngine(cfg, model=model, device=dev)
    bank = traffic.video_bank(p, sz, args.seed, dev)
    plan = traffic.request_plan(p, args.seed, 4096)

    _serve(engine, bank, traffic.Request(-1, max(p["lengths"]), 0), B, K)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    served, reading = [], None
    if args.trace:
        req = traffic.Request(0, p["trace_frames"], plan[0].start)
        work = _b1_b2_work(bank, req, B, req.T, sz, cd)
        flops = _count_flops(engine, bank, req, B, K, work)
        setup_s = time.perf_counter() - t_start
        _, dtr = tracing.profile_window(lambda: _serve(engine, bank, req, B, K), host=False)
        spans = tracing.ModuleSpans({"backbone": model.backbone, "feat_proj": model.feat_proj,
                                     "decoder": model.decoder, "frame_step": model})

        def window():
            with torch.profiler.record_function("bench/request"):
                served.append((req,) + _serve(engine, bank, req, B, K))
        _, tr = tracing.profile_window(window)
        spans.remove()
        reading = SimpleNamespace(kind="infer", trace=tr, dtrace=dtr, window_s=dtr.window_s,
                                  busy_s=dtr.busy_s(), frames=B * req.T, flops=flops, **work)
        window_s = dtr.window_s
    else:
        setup_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        stop = lambda: time.perf_counter() - t0 >= args.seconds
        for req in plan:
            if stop():
                break
            served.append((req,) + _serve(engine, bank, req, B, K, stop))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    frames = sum(B * n for _, _, n in served)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    found = common.loaded_forbidden()
    if found:
        raise SystemExit(f"benchmark: JAX modules loaded in this process: {found}")

    del engine, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, seen = check_requests(cell, cd, sd, bank, served, args.seed, dev)

    if args.trace:
        values = {name: read(reading) for name, read in cell.readers.items()}
    else:
        values = {"frames_per_s": frames / window_s, "setup_s": setup_s,
                  "peak_mem_gib": peak / 2 ** 30}
    result = {"correct": all(c["ok"] for c in checks), "attempted": len(served),
              "failed": 0,
              "metrics": common.metric_block(values, cell.per_layer if args.trace
                                             else cell.end_to_end, cell.rehearse),
              "device": common.device_block(cell.rehearse, cell.chips, peak),
              "frames": frames, "window_s": window_s, "requests_checked": seen}
    if args.trace:
        result["device"].update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = {"device_ops": reading.dtrace.device_ops(),
                               "idle_gaps": reading.trace.idle_gaps()}
        result["bounds"] = {"b1": reading.b1_bound_kind, "b2": reading.b2_bound_kind}
    if not cell.rehearse:
        result["power_limit_w"] = common.power_limit_w()
    common.emit(result, checks)


def compare_request(step, bank, req, T, out, B, taus):
    """One request's output against the reference's: {"differ_pct": label
    pixels that differ, "decisive": {tau: (share of pixels decisive at
    margin tau, share of those that differ), in %}, "x_gap": largest
    |X - X_ref|, "x_mean_gap": its mean over the valid pairs of every frame,
    "x_gap_by_frame": the largest per frame}."""
    frames, boxes, m28, valid = traffic.stacked_inputs(bank, req, B, T)
    sl = slice(req.start, req.start + B)
    dev = frames.device
    tv = torch.from_numpy(bank.tmpl_valid[sl]).to(dev)
    got_l = torch.from_numpy(out["labels"]).to(dev)
    got_x = torch.from_numpy(out["assignments"]).to(dev)
    inf = float("inf")
    if tuple(got_l.shape) != (T, B) + tuple(frames.shape[2:4]):
        return {"differ_pct": 100.0, "decisive": {t: (100.0, 100.0) for t in taus},
                "x_gap": inf, "x_mean_gap": inf, "x_gap_by_frame": []}
    _, X, c = run_request(step, frames, boxes, m28, valid,
                          torch.from_numpy(bank.tmpl_masks[sl]).to(dev), tv, got_l, taus)
    if got_x.shape == X.shape:
        dx = (got_x - X).abs()
        pairs = tv[None, :, :, None] & valid[:, :, None, :].bool()        # (T, B, M, N)
        by_frame = dx.flatten(1).amax(1)
        gap, mean = float(by_frame.max()), float(dx[pairs].sum() / pairs.sum().clamp_min(1))
        by_frame = by_frame.tolist()
    else:
        gap, mean, by_frame = inf, inf, []
    n = max(c["pixels"], 1)
    return {"differ_pct": 100.0 * c["differ"] / n,
            "decisive": {t: (100.0 * d / n, 100.0 * m / max(d, 1))
                         for t, (d, m) in c["decisive"].items()},
            "x_gap": gap if np.isfinite(gap) else inf,
            "x_mean_gap": mean if np.isfinite(mean) else inf, "x_gap_by_frame": by_frame}


def check_requests(cell, cd, sd, bank, served, seed, dev):
    """The reference over a seed-drawn sample of the served requests: the
    checks of ``NUMBERS``, each the worst over the sample, and what each
    request read (X's largest gap besides)."""
    lim = cell.limits
    tau = lim["decisive_margin"]
    rng = np.random.default_rng([int(seed) % 2 ** 64, 11])
    k = min(lim["requests_checked"], len(served))
    pick = sorted(rng.choice(len(served), size=k, replace=False).tolist())
    step = FrameStep(cd).to(dev)
    step.load_state_dict(sd)
    step.eval()
    worst = {name: 0.0 for name in NUMBERS}
    seen = []
    B = spec.traffic_params(cell)["batch_videos"]
    for i in pick:
        req, out, n = served[i]
        r = compare_request(step, bank, req, n, out, B, (tau,))
        got = {"label_mismatch_pct": r["decisive"][tau][1], "assignment_mean_gap": r["x_mean_gap"]}
        worst = {name: max(worst[name], got[name]) for name in NUMBERS}
        seen.append({"request": i, "frames": n, "differ_pct": r["differ_pct"],
                     "decisive_pct": r["decisive"][tau][0], **got,
                     "assignment_max_gap": r["x_gap"]})
    return [common.check(name, worst[name], lim[name]) for name in NUMBERS], seen

