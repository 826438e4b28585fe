#!/usr/bin/env python3
"""The day-one drill over several held-out videos, with the detector's
proposals and with planted ones.

The drill (tests/test_torch_port_dayone.py) gates on one video (seed 7001).
This tool runs its commands on one native 854x480 tree per seed
(data/synthetic.write_native_davis_tree, T frames): the cache tool with the
detector, then infer_torch.py with the DMM, scored at native resolution;
the same at model resolution (--score-at-model-res), with planted
proposals (no cache: proposals synthesised from the ground truth), and on
the kernels (matching.use_pallas, stride-4 masks, logits_res=mask). It
tells a hard video from a weak detector or DMM.

Usage: python tools/dayone_seeds_torch.py [--seeds 7001 ... 7008]
           [--frames 4] [--dmm runs/torch/dmm448/dmm.msgpack]
           [--mrcnn runs/torch/proposal_video448/mrcnn.msgpack] [--device cpu]
Prints one JSON line per seed, then one JSON line of each arm's mean and
minimum J&F.
"""
import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

KERNELS = ["matching.use_pallas=true", "model.mask_res=stride4",
           "model.logits_res=mask"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=list(range(7001, 7009)))
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--dmm", default="runs/torch/dmm448/dmm.msgpack")
    ap.add_argument("--mrcnn", default="runs/torch/proposal_video448/mrcnn.msgpack")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import importlib.util

    import infer_torch
    from dmm_net_tpu_torch.data.synthetic import write_native_davis_tree

    spec = importlib.util.spec_from_file_location(
        "extract_proposals_torch",
        os.path.join(_ROOT, "tools", "extract_proposals_torch.py"))
    extract = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(extract)

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for seed in args.seeds:
            root = write_native_davis_tree(str(tmp / f"D{seed}"), T=args.frames,
                                           seeds=(seed,))
            cache = str(tmp / f"P{seed}")
            extract.main(["--dataset", "davis", "--root", root, "--out", cache,
                          "--params", args.mrcnn, "--image-size", "256", "448",
                          "--backbone", "resnet18", "--num-classes", "4",
                          "--max-detections", "8", "--score-thresh", "0.05",
                          "--device", args.device])
            row = {"seed": seed}
            arms = {"detector": ["--proposal-dir", cache],
                    "detector_model_res": ["--proposal-dir", cache,
                                           "--score-at-model-res"],
                    "planted": [],
                    "detector_kernels": ["--proposal-dir", cache, "--set", *KERNELS]}
            for arm, extra in arms.items():
                s = infer_torch.main(["--ckpt", args.dmm, "--davis-root", root,
                                      "--out", str(tmp / f"R{seed}_{arm}"),
                                      "--chunk", "4", "--device", args.device,
                                      *extra])
                row[arm] = {k: s[k] for k in ("J", "F", "J&F")}
            row["detections_per_frame"] = [
                len(json.loads(p.read_text())) for p in sorted(Path(cache).rglob("*.json"))]
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {arm: {"mean": sum(r[arm]["J&F"] for r in rows) / len(rows),
                     "min": min(r[arm]["J&F"] for r in rows)}
               for arm in ("detector", "detector_model_res", "planted",
                           "detector_kernels")}
    print(json.dumps({"dayone_seeds": summary}), flush=True)
    return rows, summary


if __name__ == "__main__":
    main()
