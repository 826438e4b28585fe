"""A ``train_clips`` cell: ``train.loop.make_train_step`` over batches of
synthetic clips made on the device, on one card.

Set-up builds one training state (the program's model, with the
benchmark's weights, and its optimizer), draws the pool of batches, and
drives the state through its first three steps with the window's own call
on three distinct batches: they warm up every shape and are what the
reference follows. The same state then steps through the window, the pool
cycling, until ``--seconds`` have passed, and the window closes at a
synchronize. ``clips_per_s`` is the clips of every step completed (the
global batch) over the window's wall time.

``correct``, once the window has closed and the state is freed: the plain
reference takes the same three steps from the same weights on the same
batches; compared are each step's loss, every parameter's gradient norm at
the first step as the optimizer got it (from Adam's first moment), and
every parameter's change over the three steps, each by its worst leaf, and
the gradient of the leaves that the limits file names as the matcher's
(their gradient comes only through B1's backward, B1'), each against its
own norm.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import common, formulas, spec, traffic, tracing
from benchmark.harness.weights import make_state_dict
from benchmark.reference.model import FrameStep
from benchmark.reference.train import first_steps

CHECK_STEPS = 3
ADAM_B1 = 0.9             # Optimizer.b1: Adam's first moment is (1 - b1) g after one update
# a leaf whose reference gradient is under this share of the median leaf's moves by round-off
# alone under Adam, and is left out of the change (at p5 only decoder.toobj_c2.*, at exactly 0)
STILL_BELOW = 1e-6


def _b1_backward_bound(batches, cfg, sz):
    """B1''s least seconds over the given batches: one backward call per
    frame, with that frame's valid pairs."""
    total = 0.0
    H, W = sz["image_hw"]
    N, M, D = sz["N"], sz["M"], cfg["cost"]["feature_dim"]
    P = (H // 16) * (W // 16)
    Pc = int(np.prod(cfg["cost"]["mask_size"]))
    iters = cfg["matching"]["sinkhorn_iters"]
    for b in batches:
        B = b["frames"].shape[0]
        by = formulas.b1_backward_bytes(B, M, N, P, D, Pc)
        counts = b["tmpl_valid"].sum(1)
        pairs = (counts[:, None] * b["prop_valid"].sum(-1)).sum(0).tolist()
        for pr in pairs:
            ops = 2 * formulas.pool_cost_match_ops(B, M, N, P, D, Pc, iters, int(pr))
            total += formulas.bound_s(by, ops)[0]
    return total


def worst_gap(prog: dict, ref: dict, names) -> float:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref)."""
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def program_readings(state, names, losses, g1, p0) -> dict:
    change = {n: float((p.detach() - p0[n]).norm())
              for n, p in zip(names, state.optimizer.params)}
    return {"loss": [float(x) for x in losses], "grad_norm": g1, "change": change}


def numbers(prog: dict, ref: dict, lim: dict) -> dict:
    """The compared numbers of the first steps."""
    names = list(ref["grad_norm"])
    g = ref["grad_norm"]
    med = float(np.median([g[n] for n in names]))
    moving = [n for n in names if g[n] >= STILL_BELOW * med]
    matcher = [n for n in names if n.startswith(tuple(lim["matcher_leaves"]))]
    return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(prog["loss"], ref["loss"])),
            "grad_norm_gap": worst_gap(prog["grad_norm"], g, names),
            "change_gap": worst_gap(prog["change"], ref["change"], moving),
            "matcher_grad_gap": max(abs(prog["grad_norm"][n] - g[n]) / max(g[n], 1e-30)
                                    for n in matcher)}


def compare(prog: dict, ref: dict, lim: dict):
    """The compared numbers of the first steps, with their limits."""
    return [common.check(name, value, lim[name])
            for name, value in numbers(prog, ref, lim).items()]


def setup(cell, args, dev):
    """The training state with the benchmark's weights, the step, the pool
    and the weights."""
    from dmm_net_tpu_torch.config import config_from_dict
    from dmm_net_tpu_torch.train.loop import create_train_state, make_train_step
    cd = spec.config_dict(cell)
    p = spec.traffic_params(cell)
    sz = spec.sizes(cd, p, cell.chips)
    cd["data"]["batch_size"] = sz["global_clips"]
    cfg = config_from_dict(cd)
    with torch.device("meta"):
        layout = FrameStep(cd)
    sd = make_state_dict(layout, args.seed, dev)
    state = create_train_state(cfg, device=dev)
    state.model.load_state_dict(sd)
    pool = traffic.clip_pool(p, sz, args.seed, dev)
    return cd, p, sz, sd, state, make_train_step(cfg), pool


def first_three(state, step_fn, pool):
    """The first steps, through the window's call and feed: losses, the
    first gradient's norms as the optimizer got them, and the start."""
    names = [n for n, _ in state.model.named_parameters()]
    p0 = {n: p.detach().clone() for n, p in zip(names, state.optimizer.params)}
    losses, g1 = [], None
    scale = float(np.float32(1 - ADAM_B1))
    for k in range(CHECK_STEPS):
        losses.append(step_fn(state, pool[k % len(pool)])["loss"])
        if k == 0:
            st = state.optimizer.adamw.state       # empty if no update was made
            g1 = {n: float(st[p]["exp_avg"].norm()) / scale if "exp_avg" in st.get(p, {})
                  else 0.0 for n, p in zip(names, state.optimizer.params)}
    return program_readings(state, names, losses, g1, p0)


def window(state, step_fn, pool, seconds, dev):
    """Steps until ``seconds`` have passed; (steps, seconds, losses)."""
    t0 = time.perf_counter()
    losses, k = [], 0
    while time.perf_counter() - t0 < seconds:
        losses.append(step_fn(state, pool[(CHECK_STEPS + k) % len(pool)])["loss"])
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return k, time.perf_counter() - t0, losses


def reference(cd, sd, pool, dev, rows):
    step = FrameStep(cd).to(dev).float()
    step.load_state_dict(sd)
    step.train()
    return first_steps(step, pool[:CHECK_STEPS], cd, rows)


def traced(state, step_fn, pool, cd, sz, trace_steps):
    """One step under FlopCounterMode, then ``trace_steps`` steps under
    the profiler: the per-layer readers' reading."""
    from torch.utils.flop_counter import FlopCounterMode

    from dmm_net_tpu_torch.kernels import backward_calls, launch_counts
    batch = pool[CHECK_STEPS % len(pool)]
    B = batch["frames"].shape[0]
    H, W = sz["image_hw"]
    P, D = (H // 16) * (W // 16), cd["cost"]["feature_dim"]
    Pc = int(np.prod(cd["cost"]["mask_size"]))
    iters = cd["matching"]["sinkhorn_iters"]
    counts = batch["tmpl_valid"].sum(1)
    pairs = (counts[:, None] * batch["prop_valid"].sum(-1)).sum(0).tolist()
    b1 = sum(formulas.pool_cost_match_ops(B, sz["M"], sz["N"], P, D, Pc, iters, int(x))
             for x in pairs)
    fwd0, bwd0 = launch_counts()["fused_pool_cost_match"], backward_calls()["fused_pool_cost_match"]
    with FlopCounterMode(display=False) as counter:
        step_fn(state, batch)
    flops = float(counter.get_total_flops())
    if launch_counts()["fused_pool_cost_match"] > fwd0:
        flops += b1
    if backward_calls()["fused_pool_cost_match"] > bwd0:
        flops += 2 * b1
    first = CHECK_STEPS + 1

    def run(batches):
        for b in batches:
            with torch.profiler.record_function("bench/step"):
                step_fn(state, b)
    batches = [pool[(first + k) % len(pool)] for k in range(trace_steps)]
    _, dtr = tracing.profile_window(lambda: run(batches), host=False)
    tracing.wrap_method(state.optimizer, "update", "bench/optimizer")
    used = [pool[(first + trace_steps + k) % len(pool)] for k in range(trace_steps)]
    _, tr = tracing.profile_window(lambda: run(used))
    return SimpleNamespace(kind="train", trace=tr, dtrace=dtr, window_s=dtr.window_s,
                           busy_s=dtr.busy_s(), steps=trace_steps, flops=flops * trace_steps,
                           b1_bwd_bound_s=_b1_backward_bound(used, cd, sz))


def run(cell: spec.Cell, args, t_start: float) -> None:
    dev = torch.device("cpu" if cell.rehearse else "cuda")
    cd, p, sz, sd, state, step_fn, pool = setup(cell, args, dev)
    prog = first_three(state, step_fn, pool)
    reading = None
    if args.trace:
        reading = traced(state, step_fn, pool, cd, sz, p["trace_steps"])
        steps, window_s, losses, setup_s = p["trace_steps"], reading.window_s, [], None
    else:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        steps, window_s, losses = window(state, step_fn, pool, args.seconds, dev)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    found = common.loaded_forbidden()
    if found:
        raise SystemExit(f"benchmark: JAX modules loaded in this process: {found}")
    failed = sum(1 for x in losses if not math.isfinite(float(x)))
    del state, step_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cd, sd, pool, dev, p.get("reference_rows", 0))
    checks = compare(prog, ref, cell.limits)
    if args.trace:
        values = {name: read(reading) for name, read in cell.readers.items()}
    else:
        values = {"clips_per_s": steps * sz["global_clips"] / window_s, "setup_s": setup_s,
                  "peak_mem_gib": peak / 2 ** 30}
    result = {"correct": all(c["ok"] for c in checks) and failed == 0,
              "attempted": steps, "failed": failed,
              "metrics": common.metric_block(values, cell.per_layer if args.trace
                                             else cell.end_to_end, cell.rehearse),
              "device": common.device_block(cell.rehearse, cell.chips, peak),
              "steps": steps, "window_s": window_s, "losses": prog["loss"]}
    if args.trace:
        result["device"].update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = {"device_ops": reading.dtrace.device_ops(),
                               "idle_gaps": reading.trace.idle_gaps()}
    if not cell.rehearse:
        result["power_limit_w"] = common.power_limit_w()
    common.emit(result, checks)
