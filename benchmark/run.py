#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, correctness limits and per-layer readers are
files under ``benchmark/`` found by name. The run makes its weights and
inputs on the card from ``--seed``, warms up (set-up), measures for
``--seconds``, checks the window's outputs against the plain reference in
``benchmark/reference/``, and prints one JSON line last on standard
output. ``--trace 1`` measures the per-layer metrics instead, from
torch.profiler over a short window of the same traffic.

Without CUDA, or with fewer cards than the cell asks for, it exits
non-zero and prints no result. ``--rehearse`` runs the cell on the CPU at
the tiny sizes its files give, to exercise the code; its numbers are
named ``cpu.<metric>`` and are no device measurement.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at the rehearsal sizes (no device metric)")
    return ap.parse_args(argv)


def main(argv=None, t_start=None) -> None:
    args = parse(argv)
    from benchmark.harness import common, spec
    cell = spec.load_cell(args.workload, rehearse=args.rehearse)
    if cell.chips != 1:
        raise SystemExit(f"{cell.name} asks for {cell.chips} cards; only one-card cells have "
                         "a runner")
    if not args.rehearse:
        common.require_cards(cell.chips)
    runners = {"video_offline": "infer_cell", "train_clips": "train_cell"}
    if cell.kind not in runners:
        raise SystemExit(f"traffic kind {cell.kind!r} has no runner")
    import importlib
    runner = importlib.import_module(f"benchmark.harness.{runners[cell.kind]}")
    runner.run(cell, args, T_START if t_start is None else t_start)


if __name__ == "__main__":
    main()
