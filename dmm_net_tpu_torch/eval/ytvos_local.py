"""Local YouTube-VOS scoring (a copy of the JAX package's
eval/ytvos_local.py on the port's J and F).

The official metric is computed by the evaluation server, whose input the
submission writer produces; this scorer reproduces the protocol for
annotated data whose ground truth you hold:

  per video and object: J and F on the annotated frames AFTER the object's
  first annotated frame (the template frame itself is excluded);
  overall G = mean over objects of (mean J + mean F) / 2.

Seen/unseen splits need category labels (meta.json of the full release);
without them everything is scored as one group.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from dmm_net_tpu_torch.eval.davis_jf import db_eval_boundary, db_eval_iou


def evaluate_video(gt_by_stem: Mapping[str, np.ndarray],
                   pred_by_stem: Mapping[str, np.ndarray],
                   object_first_stem: Mapping[int, str]) -> Dict:
    """gt/pred: stem -> (H, W) integer label map. object_first_stem: each
    object id's first annotated stem (that frame and earlier ones, by
    string order of the zero-padded stems, are excluded)."""
    stems = sorted(set(gt_by_stem) & set(pred_by_stem))
    out = {}
    for oid, first in object_first_stem.items():
        js, fs = [], []
        for stem in stems:
            if stem <= first:
                continue
            g = gt_by_stem[stem] == oid
            p = pred_by_stem[stem] == oid
            js.append(db_eval_iou(g, p))
            fs.append(db_eval_boundary(g, p))
        if js:
            out[oid] = {"J": float(np.mean(js)), "F": float(np.mean(fs))}
    return out


def seen_split_from_meta(meta_videos: Mapping[str, Dict],
                         seen_category_names: Sequence[str]
                         ) -> Dict[str, List[int]]:
    """The "videos" dict of a category-labelled meta.json and the categories
    of the train split (the official seen set) -> {video: [object ids whose
    category is seen]}, the seen-split mapping ``summarize`` takes."""
    seen = set(seen_category_names)
    return {vid: [int(oid) for oid, od in vd.get("objects", {}).items()
                  if od.get("category") in seen]
            for vid, vd in meta_videos.items()}


def summarize(per_video: Mapping[str, Dict],
              seen_categories: Optional[Mapping[str, Sequence[int]]] = None
              ) -> Dict:
    """per_video: video -> {oid: {J, F}}. Returns the overall J, F and G,
    and the seen/unseen groups when ``seen_categories`` (video -> seen
    object ids) is given."""
    def agg(items: List[Dict]) -> Dict:
        if not items:
            return {"J": None, "F": None, "G": None}
        J = float(np.mean([x["J"] for x in items]))
        F = float(np.mean([x["F"] for x in items]))
        return {"J": J, "F": F, "G": (J + F) / 2}

    all_items, seen_items, unseen_items = [], [], []
    for vid, objs in per_video.items():
        seen_ids = set(seen_categories.get(vid, [])) if seen_categories else None
        for oid, scores in objs.items():
            all_items.append(scores)
            if seen_ids is not None:
                (seen_items if oid in seen_ids else unseen_items).append(scores)
    out = {"overall": agg(all_items)}
    if seen_categories is not None:
        out["seen"] = agg(seen_items)
        out["unseen"] = agg(unseen_items)
    return out
