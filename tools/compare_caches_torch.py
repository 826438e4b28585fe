#!/usr/bin/env python3
"""Two proposal caches of the same frames, frame by frame: the JAX package's
cache tool (tools/extract_proposals.py) against the port's
(tools/extract_proposals_torch.py) on one detector file, for instance.

Both caches must hold the same frames. Each frame must hold the same number
of detections in the same order, boxes within BOX_TOL px, scores within
SCORE_TOL, and the decoded masks must differ in fewer than MASK_TOL of their
pixels on average over all detections. tests/test_torch_port_pipeline.py's
``test_cache_tool_matches_jax_detector`` holds the port's cache tool to the
same tolerances.

Usage: python tools/compare_caches_torch.py CACHE_A CACHE_B
Prints one JSON line; exits 1 when the caches disagree.
"""
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BOX_TOL, SCORE_TOL, MASK_TOL = 1e-3, 1e-5, 1e-3


def compare(a, b):
    """{"frames", "detections", "only_in_a", "only_in_b" (frames that one
    cache lacks), "count_mismatch" (frames whose counts differ),
    "max_box_diff", "max_score_diff", "mean_mask_mismatch",
    "max_mask_mismatch", "agree"} of cache ``b`` against cache ``a`` over
    the frames both hold."""
    import numpy as np

    from dmm_net_tpu_torch.ops import rle

    a, b = Path(a), Path(b)
    in_a, in_b = ({str(f.relative_to(r)) for f in r.rglob("*.json")} for r in (a, b))
    frames = sorted(in_a & in_b)
    counts, box, score, mism, n = [], 0.0, 0.0, [], 0
    for f in frames:
        pa, pb = (json.loads((r / f).read_text()) for r in (a, b))
        if len(pa) != len(pb):
            counts.append(f)
            continue
        for p, q in zip(pa, pb):
            box = max(box, float(np.abs(np.subtract(p["bbox"], q["bbox"])).max()))
            score = max(score, abs(p["score"] - q["score"]))
            mism.append(float((rle.decode(p["rle"]) != rle.decode(q["rle"])).mean()))
        n += len(pa)
    mean = float(np.mean(mism)) if mism else 0.0
    only_a, only_b = sorted(in_a - in_b), sorted(in_b - in_a)
    return {"frames": len(frames), "detections": n, "only_in_a": only_a,
            "only_in_b": only_b, "count_mismatch": counts,
            "max_box_diff": box, "max_score_diff": score,
            "mean_mask_mismatch": mean, "max_mask_mismatch": max(mism, default=0.0),
            "agree": bool(frames) and not (only_a or only_b or counts)
            and box <= BOX_TOL and score <= SCORE_TOL and mean < MASK_TOL}


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        raise SystemExit(__doc__)
    out = compare(*args)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["agree"] else 1)
