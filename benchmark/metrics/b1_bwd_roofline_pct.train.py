"""Kernel B1' (the matcher's backward: the sweep and tail kernels and its
four products, everything launched inside autograd's
``_PoolCostMatchBackward``): its least time by the frozen formula (saved
inputs and gX read once, five gradients written; twice B1's operations)
over its measured time in the traced steps."""


def read(r):
    if r.kind != "train":
        return None
    ops = r.trace.device_in(r.trace.spans("PoolCostMatchBackward", exact=False))
    if not any("matcher_sweep_kernel" in e["name"] for e in ops):
        return None
    t = r.trace.seconds(ops)
    return 100.0 * r.b1_bwd_bound_s / t if t > 0 else None
