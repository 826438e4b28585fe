"""Kernel B1 (pooling, cost, Sinkhorn: ``matcher_pool_kernel``,
``matcher_cost_kernel``, ``matcher_sinkhorn_kernel``): its least time by the
frozen formulas over its measured time in the traced request."""

NAMES = ("matcher_pool_kernel", "matcher_cost_kernel", "matcher_sinkhorn_kernel")


def read(r):
    if r.kind != "infer":
        return None
    ops = [e for e in r.dtrace.kernels() if any(n in e["name"] for n in NAMES)]
    t = r.dtrace.seconds(ops)
    return 100.0 * r.b1_bound_s / t if t > 0 else None
