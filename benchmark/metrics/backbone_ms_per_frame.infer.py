"""Device ms of the operations launched inside the backbone's calls
(``bench/backbone``: frame steps and template features), per video frame."""


def read(r):
    if r.kind != "infer" or not r.frames:
        return None
    ops = r.trace.device_in(r.trace.spans("bench/backbone"))
    return 1e3 * r.trace.seconds(ops) / r.frames if ops else None
