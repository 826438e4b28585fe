"""The traced window's operations (FlopCounterMode over the same request,
plus the B1 and B2 launches by their frozen formulas) per second, as a share
of the card's dense bf16 peak."""

from benchmark.harness.formulas import BF16_PEAK_FLOPS


def read(r):
    if r.kind != "infer" or not r.flops > 0 or not r.window_s > 0:
        return None
    return 100.0 * r.flops / r.window_s / BF16_PEAK_FLOPS
