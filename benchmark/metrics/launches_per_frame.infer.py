"""Kernels the card ran in the traced request, per video frame."""


def read(r):
    if r.kind != "infer" or not r.frames:
        return None
    n = len(r.dtrace.kernels())
    return n / r.frames if n else None
