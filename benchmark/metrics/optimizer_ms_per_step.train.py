"""Device ms of the operations launched inside the optimizer's update
(``bench/optimizer``: the global norm, the clip, AdamW), per train step."""


def read(r):
    if r.kind != "train" or not r.steps:
        return None
    ops = r.trace.device_in(r.trace.spans("bench/optimizer"))
    return 1e3 * r.trace.seconds(ops) / r.steps if ops else None
