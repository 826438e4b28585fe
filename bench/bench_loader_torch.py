#!/usr/bin/env python3
"""Host image-loading throughput of the port: the C++ loader's thread pool
(data/native_loader.py over csrc/host/imgloader.cpp) against PIL, the
counterpart of bench/bench_loader.py. DAVIS-480p-like JPEGs, decoded and
resized to the flagship 256x448.

The C++ loader builds with g++ at first use and needs libjpeg's and
libpng's headers. Where it does not build, the tool says so ("native: not
built") and times PIL alone: it prints no native number it did not
measure.

Usage: python bench/bench_loader_torch.py [--files 64] [--threads 8]
           [--reps 3]
Returns {"native": files/s or None, "pil_serial": ..., "pil_threads": ...}.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=64)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from dmm_net_tpu_torch.data import native_loader as nl

    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(args.files):
            # smooth 854x480 content, DAVIS-ish JPEG size
            base = (rng.rand(60, 107, 3) * 255).astype(np.uint8)
            img = Image.fromarray(base).resize((854, 480), Image.BILINEAR)
            p = os.path.join(d, f"{i:05d}.jpg")
            img.save(p, quality=90)
            paths.append(p)

        def timed(fn):
            fn()                                     # warm (page cache)
            best = float("inf")
            for _ in range(args.reps):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            return args.files / best

        def one(p):
            with Image.open(p) as im:
                return np.asarray(im.convert("RGB").resize((448, 256),
                                                           Image.BILINEAR))

        def pil_serial():
            out = np.empty((len(paths), 256, 448, 3), np.uint8)
            for i, p in enumerate(paths):
                out[i] = one(p)
            return out

        def pil_threads():
            with ThreadPoolExecutor(args.threads) as ex:
                return list(ex.map(one, paths))

        native = (timed(lambda: nl.load_rgb_batch(paths, (256, 448),
                                                  threads=args.threads))
                  if nl.available() else None)
        res = {"native": native, "pil_serial": timed(pil_serial),
               "pil_threads": timed(pil_threads)}

    print(f"files={args.files} 854x480 JPEG -> 256x448 uint8, "
          f"threads={args.threads}, host cores={os.cpu_count()}")
    if native is None:
        print(f"native: not built ({nl.reason()})")
    else:
        print(f"native C++ pool     {native:8.1f} files/s")
    print(f"PIL serial          {res['pil_serial']:8.1f} files/s")
    print(f"PIL thread pool     {res['pil_threads']:8.1f} files/s")
    if native is not None:
        print(f"speedup vs PIL-threaded: {native / res['pil_threads']:.2f}x")
    return res


if __name__ == "__main__":
    main()
