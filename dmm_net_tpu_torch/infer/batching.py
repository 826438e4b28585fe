"""Batch several per-sequence streams into one engine call (numpy only;
a copy of the JAX package's infer/batching.py).

`batch_sequence_streams` zips the per-sequence dicts produced by
DavisDataset.sequence_stream into one batched stream dict of the shape the
InferenceEngine consumes. Shorter sequences are edge-padded (their last
item repeats) up to the group's max length; callers slice each sequence's
results back to its true length with the returned "lengths".
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def _default_live_from(sd: Dict) -> np.ndarray:
    lf = sd.get("live_from")
    if lf is None:
        # slots live from frame 0; dead slots gated by tmpl_valid anyway
        return np.zeros(sd["tmpl_valid"].shape, np.int32)
    return np.asarray(lf, np.int32)


def batch_sequence_streams(streams: List[Dict]) -> Dict:
    """Combine n sequence-stream dicts (each with batch axis B=1) into one
    with B=n. All per-frame items must carry the same keys (all full-mask
    or all compact). Adds "lengths" (list of true frame counts) and
    "names". If any stream has live_from/tmpl_frames, all get them
    (defaults: live from 0 / the first frame)."""
    if not streams:
        raise ValueError("no streams to batch")
    lengths = [sd["num_frames"] for sd in streams]
    max_len = max(lengths)
    gated = any(sd.get("live_from") is not None for sd in streams)

    out: Dict = {
        "names": [sd.get("name") for sd in streams],
        "lengths": lengths,
        "num_frames": max_len,
        "tmpl_masks": np.concatenate([sd["tmpl_masks"] for sd in streams]),
        "tmpl_valid": np.concatenate([sd["tmpl_valid"] for sd in streams]),
        "first_frame": np.concatenate([sd["first_frame"] for sd in streams]),
        "object_ids": [sd["object_ids"] for sd in streams],
    }
    if gated:
        out["live_from"] = np.concatenate(
            [_default_live_from(sd) for sd in streams])
        if all(sd.get("tmpl_frames") is not None for sd in streams):
            out["tmpl_frames"] = np.concatenate(
                [sd["tmpl_frames"] for sd in streams])

    def gen() -> Iterator[Dict[str, np.ndarray]]:
        iters = [iter(sd["frames"]) for sd in streams]
        last: List[Dict[str, np.ndarray]] = [None] * len(streams)
        for t in range(max_len):
            items = []
            for i, it in enumerate(iters):
                if t < lengths[i]:
                    last[i] = next(it)
                items.append(last[i])      # edge-pad exhausted streams
            keys = items[0].keys()
            yield {k: np.concatenate([item[k] for item in items])
                   for k in keys}

    out["frames"] = gen()
    return out
