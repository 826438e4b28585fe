"""Kernels the card ran in the traced steps, per train step."""


def read(r):
    if r.kind != "train" or not r.steps:
        return None
    n = len(r.dtrace.kernels())
    return n / r.steps if n else None
