#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card
at the cell's own sizes, many seeds in one process (one set-up):

    python3 benchmark/calibrate.py --workload <cell> --seeds 101-112 \
        --control-seeds 101-103 [--faults 101-103] [--out FILE]
    python3 benchmark/calibrate.py --workload <cell> --seeds 101 \
        --requests 5,9 --witness [--out FILE]

For each sound seed: the program on that seed's weights and traffic (an
inference cell serves the mix's first requests in full, as many as a run
compares; a training cell takes its first three steps), then the plain
reference, and the numbers that decide ``correct`` (the lower reading).
For each control seed: the reference computed one precision step below the
configuration's (float8 operands for bfloat16 layers, TF32 for float32
products) in the program's place (the upper reading). With ``--faults``, a
training cell's faults planted in the program: half of each batch left
out, the mean taken over the rest; B1's backward (B1') returning zeros;
B1' returning twice its gradients. With ``--requests`` an inference cell
serves those requests of each seed's plan instead of the first, and
reports each one; ``--witness`` also serves them a second time, and once
through the program's plain matcher (``matching.use_pallas`` off), and
compares the three X's with each other and with the reference's, frame by
frame; and it hands the program's B1 the reference's own matcher inputs at
every frame (``b1_on_reference_inputs``), which tells a kernel that
computes another function from rounding that the frames carry forward. One JSON line per reading, also appended to ``--out``. The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def seed_list(text):
    out = []
    for part in (text or "").split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


class _Lowp:
    """TF32 on for float32 products while the control computes."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        import torch
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


TAUS = (1 / 64, 1 / 32, 1 / 16, 1 / 8)


def plant_b1_backward(scale: float):
    """B1' made to return ``scale`` times its gradients (0: none); returns
    the undo."""
    from dmm_net_tpu_torch.kernels import matcher
    orig = matcher._PoolCostMatch.backward

    def backward(ctx, gX):
        return tuple(None if g is None else g * scale for g in orig(ctx, gX))
    matcher._PoolCostMatch.backward = staticmethod(backward)
    return lambda: setattr(matcher._PoolCostMatch, "backward", staticmethod(orig))


def _worst(kind, seed, rs, reqs):
    """The worst of the requests' readings: X's gap, the share of all label
    pixels that differ, and for each margin the share of decisive pixels
    and the share of those that differ."""
    rec = {"kind": kind, "seed": seed, "assignment_max_gap": max(r["x_gap"] for r in rs),
           "assignment_mean_gap": max(r["x_mean_gap"] for r in rs),
           "request": [r.index for r in reqs],
           "differ_pct": max(r["differ_pct"] for r in rs), "T": [r.T for r in reqs]}
    for t in TAUS:
        rec[f"decisive_pct@{t:.4g}"] = min(r["decisive"][t][0] for r in rs)
        rec[f"label_mismatch_pct@{t:.4g}"] = max(r["decisive"][t][1] for r in rs)
    return rec


def infer_readings(cell, args, emit):
    import copy

    import torch

    from benchmark.harness import infer_cell, spec, traffic
    from benchmark.harness.weights import make_state_dict
    from benchmark.reference.infer import run_request
    from benchmark.reference.model import FrameStep
    from dmm_net_tpu_torch.config import config_from_dict
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.models.dmm import DMMNet

    dev = torch.device(args.device or ("cpu" if cell.rehearse else "cuda"))
    cd = spec.config_dict(cell)
    cfg = config_from_dict(cd)
    p = spec.traffic_params(cell)
    sz = spec.sizes(cd, p, cell.chips)
    B, K = p["batch_videos"], p["chunk"]
    n_req = cell.limits["requests_checked"]
    model = DMMNet(cfg, device=dev)
    engine = InferenceEngine(cfg, model=model, device=dev)
    witness = None
    if args.witness:
        wd = copy.deepcopy(cd)
        wd["matching"]["use_pallas"] = False
        wcfg = config_from_dict(wd)
        wmodel = DMMNet(wcfg, device=dev)
        witness = InferenceEngine(wcfg, model=wmodel, device=dev)
    ref, low = FrameStep(cd).to(dev).eval(), FrameStep(cd, lowp=True).to(dev).eval()
    for seed in sorted(set(args.seeds) | set(args.control)):
        sd = make_state_dict(ref, seed, dev)
        for m in (model, ref, low) + ((wmodel,) if witness else ()):
            m.load_state_dict(sd)
        bank = traffic.video_bank(p, sz, seed, dev)
        plan = traffic.request_plan(p, seed, 4096)          # as a run draws it
        reqs = [plan[i] for i in args.requests] if args.requests else plan[:n_req]
        if seed in args.seeds:
            rs = []
            for req in reqs:
                out, n = infer_cell._serve(engine, bank, req, B, K)
                rs.append(infer_cell.compare_request(ref, bank, req, n, out, B, TAUS))
                if args.requests:
                    emit({**_worst("sound", seed, rs[-1:], [req]),
                          "x_gap_by_frame": rs[-1]["x_gap_by_frame"]})
                if witness:
                    again, _ = infer_cell._serve(engine, bank, req, B, K)
                    plain, _ = infer_cell._serve(witness, bank, req, B, K)
                    with _B1OnReferenceInputs() as b1:
                        r = infer_cell.compare_request(ref, bank, req, n, plain, B, TAUS)
                    emit({**_worst("witness:plain_matcher", seed, [r], [req]),
                          "x_gap_by_frame": r["x_gap_by_frame"],
                          "program_vs_repeat": _x_gaps(out, again),
                          "program_vs_plain_matcher": _x_gaps(out, plain),
                          "b1_on_reference_inputs": b1.gaps})
            if not args.requests:
                emit(_worst("sound", seed, rs, reqs))
        if seed in args.control:
            rs = []
            for req in reqs:
                frames, boxes, m28, valid = traffic.stacked_inputs(bank, req, B, req.T)
                sl = slice(req.start, req.start + B)
                with _Lowp():
                    lab, X, _ = run_request(low, frames, boxes, m28, valid,
                                         torch.from_numpy(bank.tmpl_masks[sl]).to(dev),
                                         torch.from_numpy(bank.tmpl_valid[sl]).to(dev))
                out = {"labels": lab.cpu().numpy(), "assignments": X.cpu().numpy()}
                rs.append(infer_cell.compare_request(ref, bank, req, req.T, out, B, TAUS))
            emit(_worst("control", seed, rs, reqs))
        del bank
        if dev.type == "cuda":
            torch.cuda.empty_cache()


class _B1OnReferenceInputs:
    """While active, every call of the reference's matcher also runs the
    program's B1 on the same inputs and records the largest |X_B1 - X_ref|."""

    def __enter__(self):
        from benchmark.reference import model
        from dmm_net_tpu_torch.kernels.matcher import fused_pool_cost_match
        self.gaps, self.model, self.orig = [], model, model.pool_cost_sinkhorn

        def both(emb, pmp, tm, pm, tf, rm, cm, epsilon, iters, lam):
            X = self.orig(emb, pmp, tm, pm, tf, rm, cm, epsilon, iters, lam)
            Xb = fused_pool_cost_match(*(t.float().contiguous() for t in (emb, pmp, tm, pm, tf)),
                                       rm, cm, epsilon=epsilon, iters=iters, iou_weight=lam)
            self.gaps.append(float((Xb - X).abs().max()))
            return X
        model.pool_cost_sinkhorn = both
        return self

    def __exit__(self, *exc):
        self.model.pool_cost_sinkhorn = self.orig


def _x_gaps(a, b):
    """Two outputs' X: the largest gap per frame, and the labels that
    differ (%)."""
    import numpy as np
    dx = np.abs(a["assignments"] - b["assignments"])
    return {"x_gap_by_frame": dx.reshape(dx.shape[0], -1).max(1).tolist(),
            "differ_pct": float(100.0 * (a["labels"] != b["labels"]).mean())}


FAULTS = {"fault:half_batch": None, "fault:b1_backward_zeroed": 0.0,
          "fault:b1_backward_doubled": 2.0}


def train_readings(cell, args, emit):
    import numpy as np
    import torch

    from benchmark.harness import spec, train_cell
    from benchmark.reference.model import FrameStep
    from benchmark.reference.train import first_steps
    from dmm_net_tpu_torch.config import config_from_dict
    from dmm_net_tpu_torch.train.loop import create_train_state

    dev = torch.device(args.device or ("cpu" if cell.rehearse else "cuda"))
    rows = spec.traffic_params(cell).get("reference_rows", 0)

    def halved(step_fn):
        def step(state, batch):
            half = batch["frames"].shape[0] // 2
            return step_fn(state, {k: v[:half] for k, v in batch.items()})
        return step

    for seed in sorted(set(args.seeds) | set(args.control) | set(args.faults)):
        a = argparse.Namespace(seed=seed)
        cd, p, sz, sd, state, step_fn, pool = train_cell.setup(cell, a, dev)
        runs = [("sound", None)] if seed in args.seeds else []
        if seed in args.faults:
            runs += list(FAULTS.items())
        progs = {}
        for i, (kind, scale) in enumerate(runs):
            if i:
                state = create_train_state(config_from_dict(cd), device=dev)
                state.model.load_state_dict(sd)
            undo = plant_b1_backward(scale) if scale is not None else None
            try:
                fn = halved(step_fn) if kind == "fault:half_batch" else step_fn
                progs[kind] = train_cell.first_three(state, fn, pool)
            finally:
                if undo:
                    undo()
        del state, step_fn
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = train_cell.reference(cd, sd, pool, dev, rows)
        for kind, prog in progs.items():
            emit({"kind": kind, "seed": seed, **train_cell.numbers(prog, ref, cell.limits),
                  "loss": prog["loss"], "ref_loss": ref["loss"]})
        if seed in args.control:
            low = FrameStep(cd, lowp=True).to(dev).float()
            low.load_state_dict(sd)
            low.train()
            with _Lowp():
                ctl = first_steps(low, pool[:train_cell.CHECK_STEPS], cd, rows)
            emit({"kind": "control", "seed": seed, **train_cell.numbers(ctl, ref, cell.limits),
                  "loss": ctl["loss"], "ref_loss": ref["loss"]})
            del low
        if "sound" in progs:
            g, prog = ref["grad_norm"], progs["sound"]
            med = float(np.median(list(g.values())))
            emit({"kind": "leaves", "seed": seed, "median_grad_norm": med,
                  "under_1e-2_median": {   # share of the median; gaps against own norms
                      n: [v / med, abs(prog["grad_norm"][n] - v) / max(v, 1e-30),
                          abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], 1e-30)]
                      for n, v in g.items() if v < 1e-2 * med}})
        del pool
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seed_list, default=[])
    ap.add_argument("--control-seeds", dest="control", type=seed_list, default=[])
    ap.add_argument("--faults", type=seed_list, default=[])
    ap.add_argument("--requests", type=seed_list, default=[],
                    help="plan indices to serve (inference cells)")
    ap.add_argument("--witness", action="store_true",
                    help="also serve them again and through the plain matcher")
    ap.add_argument("--out", default="")
    ap.add_argument("--rehearse", action="store_true", help="the rehearsal sizes (on the CPU)")
    ap.add_argument("--device", default="", help="run there instead (cuda at the rehearsal sizes)")
    args = ap.parse_args()
    from benchmark.harness import spec
    cell = spec.load_cell(args.workload, rehearse=args.rehearse)
    t0 = time.perf_counter()

    def emit(rec):
        rec = {"workload": cell.name, "s": round(time.perf_counter() - t0, 1), **rec}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    (infer_readings if cell.kind == "video_offline" else train_readings)(cell, args, emit)


if __name__ == "__main__":
    main()
