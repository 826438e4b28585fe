"""The traced steps' operations (FlopCounterMode over one step, forward and
backward, plus B1 and B1' by their frozen formulas; no recompute) per
second, as a share of the card's dense bf16 peak."""

from benchmark.harness.formulas import BF16_PEAK_FLOPS


def read(r):
    if r.kind != "train" or not r.flops > 0 or not r.window_s > 0:
        return None
    return 100.0 * r.flops / r.window_s / BF16_PEAK_FLOPS
