#!/usr/bin/env python3
"""ROI-Align microbenchmark of the port: B4 (csrc/roi_align.cu) as the
detector calls it, and with --backward B4', at chip_smoke.py phase 9a's
shapes: a 256x448 R-50-FPN pyramid (C=256), K boxes of every size from the
same seeded generator, the box head (7x7) and the mask head (14x14).

Usage: python bench/bench_roi_align_torch.py [--K 32 --K 128] [--backward]
           [--calls 50] [--root DIR] [--device cuda]
Prints, per K and head, the device ms per call by kernel (torch.profiler
over --calls calls; B4' alone, its kernels launched as the autograd
Function launches them), and per train image (K's box head + mask head),
and returns them. On the CPU it times the plain versions (the forward, or
the explicit plain backward) with the host clock. --root imports the
package from another checkout, so that two commits are timed by the same
script on the same card.
"""

import argparse
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# this checkout's timers and inputs, also where --root imports another
# checkout's package
from bench_torch import device_ms_by_kernel, ms_per_call  # noqa: E402
from chip_smoke import detector_boxes, pyramid  # noqa: E402

HEADS = (("box", (7, 7)), ("mask", (14, 14)))


def detector_inputs(K: int, size, device, C: int = 256, image=(256, 448)):
    """chip_smoke.py 9a's inputs for (K, head), from its own helpers: the
    pyramid p2..p5, K boxes (``detector_boxes``) and an upstream gradient,
    from one generator seeded with 40 + K + oh."""
    import torch
    gen = torch.Generator(device=device).manual_seed(40 + K + size[0])
    levels = pyramid(gen, C, image, device=device)
    boxes = detector_boxes(gen, K, *image, device=device)
    return levels, boxes, torch.randn(K, C, *size, device=device, generator=gen)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--K", type=int, action="append", default=[])
    ap.add_argument("--backward", action="store_true")
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from dmm_net_tpu_torch import resolve_device
    ra = importlib.import_module("dmm_net_tpu_torch.kernels.roi_align")

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if cuda else 'cpu'}), "
          f"package {os.path.dirname(ra.__file__)}"
          + (", backward" if args.backward else ""))
    out = {}
    for K in args.K or [32, 128]:
        for head, size in HEADS:
            levels, boxes, g = detector_inputs(K, size, dev)
            if args.backward:
                if cuda:
                    lvl = ra.fpn_levels(boxes).to(torch.int32)
                    shapes = [tuple(f.shape) for f in levels]
                    fn = lambda: ra._launch_backward(shapes, boxes, lvl, g, *size, 2)  # noqa: E731
                else:
                    fn = lambda: ra.multilevel_roi_align_backward_plain(  # noqa: E731
                        levels, boxes, g, size, 2)
            else:
                fn = lambda: ra.multilevel_roi_align(levels, boxes, size, 2)  # noqa: E731
            key = f"K={K} {head}"
            if cuda:
                per = device_ms_by_kernel(fn, args.calls)
                out[key] = {"ms": sum(per.values()), "by_kernel": per}
                print(f"{key:12s} {sum(per.values()):.4f} ms on the device: "
                      + ", ".join(f"{_short(k)} {v:.4f}" for k, v in per.items()))
            else:
                ms = ms_per_call(fn, args.calls, dev)
                out[key] = {"ms": ms}
                print(f"{key:12s} {ms:.4f} ms per call (plain version, host clock)")
        out[f"K={K} image"] = out[f"K={K} box"]["ms"] + out[f"K={K} mask"]["ms"]
        print(f"K={K} per train image (box + mask head): {out[f'K={K} image']:.4f} ms")
    return out


def _short(name: str) -> str:
    return name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


if __name__ == "__main__":
    main()
