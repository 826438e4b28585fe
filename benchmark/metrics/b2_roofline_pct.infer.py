"""Kernel B2 (``resolve_band_kernel``, the fused upsample + argmax): its
least time by the frozen formulas over its measured time in the traced
request."""


def read(r):
    if r.kind != "infer":
        return None
    t = r.trace.seconds(r.dtrace.kernels("resolve_band_kernel"))
    return 100.0 * r.b2_bound_s / t if t > 0 else None
