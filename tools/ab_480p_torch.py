#!/usr/bin/env python3
"""Quality A/B of the port at DAVIS's native geometry: the counterpart of
tools/ab_480p.py.

Writes the day-one synthetic DAVIS tree at the native 854x480 (held-out
seeds; data/synthetic.write_native_davis_tree), extracts detector
proposals once per model geometry, and runs the chunked dispatch with the
flagship weights at 256x448 (the trained geometry) and at 480x864
(p3_480p, 854 padded to 864), scoring both at the annotation's native
resolution. The DMM is fully convolutional, so the 480p run reuses the
256x448-trained weights with a --set model.image_size override. The cache
tool and infer_torch.py run in this process through their main(argv).

Usage: python tools/ab_480p_torch.py [--seeds 7001 7002] [--frames 4]
           [--dmm runs/torch/dmm448/dmm.msgpack]
           [--mrcnn runs/torch/proposal_video448/mrcnn.msgpack] [--device cpu]
Prints one JSON line last: {"ab_480p": {"256x448": {J, F, J&F, fps},
"480x864": {...}}, "note": ...}.
"""
import argparse
import json
import os
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

GEOMETRIES = (("256x448", (256, 448)), ("480x864", (480, 864)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=[7001, 7002])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--dmm", default="runs/torch/dmm448/dmm.msgpack")
    ap.add_argument("--mrcnn", default="runs/torch/proposal_video448/mrcnn.msgpack")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import importlib.util
    import pathlib

    import infer_torch
    from dmm_net_tpu_torch.data.synthetic import write_native_davis_tree

    spec = importlib.util.spec_from_file_location(
        "extract_proposals_torch",
        os.path.join(_ROOT, "tools", "extract_proposals_torch.py"))
    extract = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(extract)

    work = pathlib.Path(args.workdir or tempfile.mkdtemp(prefix="ab480_"))
    work.mkdir(exist_ok=True)
    root = write_native_davis_tree(str(work / "DAVIS"), T=args.frames,
                                   seeds=tuple(args.seeds))
    rows = {}
    for tag, (h, w) in GEOMETRIES:
        cache = str(work / f"props_{tag}")
        out = str(work / f"res_{tag}")
        extract.main(["--dataset", "davis", "--root", root, "--out", cache,
                      "--params", args.mrcnn, "--image-size", str(h), str(w),
                      "--backbone", "resnet18", "--num-classes", "4",
                      "--max-detections", "8", "--score-thresh", "0.05",
                      "--device", args.device])
        s = infer_torch.main(["--ckpt", args.dmm, "--davis-root", root,
                              "--proposal-dir", cache, "--out", out,
                              "--chunk", "4", "--device", args.device,
                              "--set", f"model.image_size={h},{w}"])
        rows[tag] = {k: round(s[k], 4) for k in ("J", "F", "J&F")}
        rows[tag]["fps"] = round(s["fps"], 1)
        print(tag, rows[tag], flush=True)
    result = {"ab_480p": rows,
              "note": "native-resolution scoring; flagship weights trained "
                      "at 256x448, run convolutionally at both geometries"}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
