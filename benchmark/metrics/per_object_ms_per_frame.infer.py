"""Device ms of the frame step's operations outside the backbone (the
embedding, pooling, cost and Sinkhorn, aggregation, the decoder), per video
frame: launched inside ``bench/frame_step`` and not inside
``bench/backbone``."""


def read(r):
    if r.kind != "infer" or not r.frames:
        return None
    step = r.trace.device_in(r.trace.spans("bench/frame_step"))
    backbone = {id(e) for e in r.trace.device_in(r.trace.spans("bench/backbone"))}
    rest = [e for e in step if id(e) not in backbone]
    return 1e3 * r.trace.seconds(rest) / r.frames if rest else None
