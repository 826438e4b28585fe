"""YouTube-VOS reader for inference and the submission writer.

Layout (the standard YouTube-VOS 2018/2019 release):
    <root>/<split>/JPEGImages/<video_id>/00000.jpg ...
    <root>/<split>/Annotations/<video_id>/00000.png ...
    <root>/<split>/meta.json:
        {"videos": {vid: {"objects": {oid: {"frames": [...]}}}}}

What differs from DAVIS:
  * objects appear mid-video: each object's template comes from its own
    first annotated frame, and its slot is live from that frame on
    (``live_from``; ``tmpl_frames`` holds each object's template frame);
  * only some frames are annotated (every 5th in the release); inference
    runs on every frame, the server scores the frames meta.json lists;
  * the proposal cache (tools/extract_proposals_torch.py) and every lookup
    are keyed by the raw frame's stem, never by a loop index.

Counterpart of the JAX package's data/ytvos.py: the inference streams and
the training clips (``clip_batches``, with ``live_from`` and
``gt_valid``). Frames and annotations are decoded as the port's DAVIS
reader decodes them (``data/native_loader.py``: the C++ loader when it
builds, else PIL); cached proposal masks are resized with PIL's NEAREST.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from dmm_net_tpu_torch.data import native_loader
from dmm_net_tpu_torch.data.davis import _resize
from dmm_net_tpu_torch.eval.davis_jf import upsample_labels
from dmm_net_tpu_torch.infer.engine import InferenceEngine
from dmm_net_tpu_torch.ops import rle as rle_codec


class YTVOSDataset:
    """Per-video access to a YouTube-VOS split."""

    def __init__(self, root: str, split: str = "valid",
                 image_size: Tuple[int, int] = (256, 448),
                 proposal_dir: Optional[str] = None,
                 max_objects: int = 16, max_proposals: int = 128):
        self.root = root
        self.split = split
        self.image_size = image_size
        self.proposal_dir = proposal_dir
        self.max_objects = max_objects
        self.max_proposals = max_proposals
        meta_path = os.path.join(root, split, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self.meta = json.load(f)["videos"]
        else:
            img_root = os.path.join(root, split, "JPEGImages")
            self.meta = {v: {"objects": {}} for v in
                         (sorted(os.listdir(img_root))
                          if os.path.isdir(img_root) else [])}
        self.videos = sorted(self.meta)
        native_loader.announce()

    def frame_paths(self, vid: str) -> List[str]:
        d = os.path.join(self.root, self.split, "JPEGImages", vid)
        return [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith((".jpg", ".png"))]

    def annotation_paths(self, vid: str) -> Dict[str, str]:
        """Stem -> path of each annotated frame."""
        d = os.path.join(self.root, self.split, "Annotations", vid)
        if not os.path.isdir(d):
            return {}
        return {os.path.splitext(f)[0]: os.path.join(d, f)
                for f in sorted(os.listdir(d)) if f.endswith(".png")}

    def load_frame(self, path: str) -> np.ndarray:
        """(H, W, 3) uint8 RGB at image_size."""
        return native_loader.load_rgb_batch([path], self.image_size)[0]

    def load_annotation(self, path: str) -> np.ndarray:
        """Palette-index label map, nearest-resized to image_size."""
        return native_loader.load_label_batch([path], self.image_size)[0]

    def object_first_frames(self, vid: str) -> Dict[int, str]:
        """Object id -> stem of its first annotated frame: from meta.json,
        else from the annotations in stem order."""
        info = self.meta.get(vid, {}).get("objects", {})
        out = {}
        if info:
            for oid, od in info.items():
                frames = od.get("frames", [])
                if frames:
                    out[int(oid)] = frames[0]
        else:
            for stem, path in self.annotation_paths(vid).items():
                ann = self.load_annotation(path)
                for oid in set(np.unique(ann)) - {0}:
                    out.setdefault(int(oid), stem)
        return out

    def sequence_stream(self, vid: str) -> Dict:
        """Everything the inference engine needs for one video (batch axis
        1): each object's template from its first annotated frame, the frame
        it is live from (``live_from``, the frame count for an empty slot),
        its template frame (``tmpl_frames``), and a generator of per-frame
        items."""
        frames = self.frame_paths(vid)
        stems = [os.path.splitext(os.path.basename(f))[0] for f in frames]
        anns = self.annotation_paths(vid)
        first = self.object_first_frames(vid)
        oids = sorted(first)[: self.max_objects]
        M = self.max_objects
        H, W = self.image_size

        tmpl = np.zeros((M, H, W), np.float32)
        tv = np.zeros((M,), bool)
        live_from = np.full((M,), len(frames), np.int64)
        tmpl_frames = np.zeros((M, H, W, 3), np.uint8)
        for i, oid in enumerate(oids):
            stem = first[oid]
            if stem in anns:
                tmpl[i] = self.load_annotation(anns[stem]) == oid
                tv[i] = True
                t_idx = stems.index(stem) if stem in stems else 0
                live_from[i] = t_idx
                tmpl_frames[i] = self.load_frame(frames[t_idx])

        def gen() -> Iterator[Dict[str, np.ndarray]]:
            for t, fp in enumerate(frames):
                img = self.load_frame(fp)
                gt = (self.load_annotation(anns[stems[t]])
                      if stems[t] in anns else None)
                pm, pv = self.load_proposals(vid, stems[t], gt)
                yield {"frame": img[None], "prop_masks": pm[None],
                       "prop_valid": pv[None]}

        return {"name": vid, "frames": gen(), "tmpl_masks": tmpl[None],
                "tmpl_valid": tv[None], "object_ids": oids,
                "live_from": live_from[None],
                "tmpl_frames": tmpl_frames[None],
                "first_frame": self.load_frame(frames[0])[None],
                "frame_stems": stems,
                "annotated_stems": sorted(anns),
                "num_frames": len(frames)}

    def load_proposals(self, vid: str, stem: str,
                       gt_labels: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(masks (N, H, W) float32, valid (N,) bool) for the raw frame
        ``stem``: from the cache when it has the frame, else synthesised
        from ``gt_labels`` (the masks, then shifted copies, seeded by the
        video and stem as the JAX package seeds them)."""
        N = self.max_proposals
        H, W = self.image_size
        masks = np.zeros((N, H, W), np.float32)
        valid = np.zeros((N,), bool)
        if self.proposal_dir is not None:
            pf = os.path.join(self.proposal_dir, vid, f"{stem}.json")
            if os.path.exists(pf):
                from PIL import Image
                with open(pf) as f:
                    props = json.load(f)
                props = sorted(props, key=lambda p: -p.get("score", 0.0))[:N]
                for i, p in enumerate(props):
                    m = rle_codec.decode(p["rle"]).astype(np.uint8) * 255
                    masks[i] = _resize(Image.fromarray(m), self.image_size,
                                       nearest=True) > 127
                    valid[i] = True
                return masks, valid
        if gt_labels is None:
            return masks, valid
        rng = np.random.RandomState(zlib.crc32(f"{vid}/{stem}".encode()) % (2 ** 31))
        i = 0
        for oid in sorted(set(np.unique(gt_labels)) - {0}):
            if i >= N:
                break
            masks[i] = gt_labels == oid
            valid[i] = True
            i += 1
        for _ in range(min(N - i, i * 2)):
            src = masks[rng.randint(max(i, 1))]
            dy, dx = rng.randint(-10, 11, 2)
            masks[i] = np.roll(np.roll(src, dy, 0), dx, 1)
            valid[i] = True
            i += 1
        return masks, valid


    def clip_batches(self, batch_size: int, clip_length: int,
                     seed: int = 0, max_objects: Optional[int] = None
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Random training clips, drawn as the JAX package's reader draws
        them. What differs from the DAVIS sampler:
          * the clip timeline is the video's ANNOTATED frames (every ~5th
            raw frame) — the reference's training recipe supervises only
            annotated frames;
          * objects may appear mid-clip: each object's template mask comes
            from its own first annotated frame inside the clip, exported
            as `live_from` (B, M) clip indices (the training analog of the
            engine's live_from gating), and `gt_valid` (B, T, M) masks the
            loss to frames where the object is live.
        Yields the train/loop.py batch layout + live_from + gt_valid.
        """
        rng = np.random.RandomState(seed)
        M = max_objects or self.max_objects
        H, W = self.image_size
        # only videos with at least one annotated frame can train
        vids = [v for v in self.videos if self.annotation_paths(v)]
        if not vids:
            raise ValueError(f"no annotated videos under {self.root}/"
                             f"{self.split}")
        while True:
            batch = {"frames": [], "prop_masks": [], "prop_valid": [],
                     "gt_masks": [], "tmpl_masks": [], "tmpl_valid": [],
                     "live_from": [], "gt_valid": []}
            for _ in range(batch_size):
                vid = vids[rng.randint(len(vids))]
                anns = self.annotation_paths(vid)
                stems = sorted(anns)
                frame_by_stem = {
                    os.path.splitext(os.path.basename(p))[0]: p
                    for p in self.frame_paths(vid)}
                stems = [s for s in stems if s in frame_by_stem]
                t0 = rng.randint(0, max(len(stems) - clip_length + 1, 1))
                ts = stems[t0:t0 + clip_length]
                ts = ts + [ts[-1]] * (clip_length - len(ts))  # pad short

                gts, frames, pms, pvs = [], [], [], []
                for t, stem in enumerate(ts):
                    frames.append(self.load_frame(frame_by_stem[stem]))
                    gts.append(self.load_annotation(anns[stem]))
                    pm, pv = self.load_proposals(vid, stem, gts[-1])
                    pms.append(pm)
                    pvs.append(pv)

                # objects present in the clip, templated at their first
                # annotated clip frame
                tm = np.zeros((M, H, W), np.float32)
                tv = np.zeros((M,), bool)
                live = np.zeros((M,), np.int32)
                gt_m = np.zeros((clip_length, M, H, W), np.float32)
                gt_v = np.zeros((clip_length, M), bool)
                slot = 0
                seen: Dict[int, int] = {}
                for t, gt in enumerate(gts):
                    for oid in sorted(set(np.unique(gt)) - {0}):
                        if oid not in seen and slot < M:
                            seen[oid] = slot
                            tm[slot] = (gt == oid)
                            tv[slot] = True
                            live[slot] = t
                            slot += 1
                        if oid in seen:
                            i = seen[oid]
                            gt_m[t, i] = (gt == oid)
                # every clip frame is annotated by construction, so a live
                # object is supervised at every t >= live_from — including
                # occlusion frames, where its (empty) GT teaches "absent"
                for i in range(slot):
                    gt_v[:, i] = np.arange(clip_length) >= live[i]

                batch["frames"].append(np.stack(frames))
                batch["prop_masks"].append(np.stack(pms))
                batch["prop_valid"].append(np.stack(pvs))
                batch["gt_masks"].append(gt_m)
                batch["tmpl_masks"].append(tm)
                batch["tmpl_valid"].append(tv)
                batch["live_from"].append(live)
                batch["gt_valid"].append(gt_v)
            yield {k: np.stack(v) for k, v in batch.items()}


def write_submission(out_dir: str, vid: str, stems: List[str],
                     labels: np.ndarray, object_ids: List[int],
                     full_size: Optional[Tuple[int, int]] = None) -> None:
    """Write the server's palette PNGs, ``<out_dir>/Annotations/<vid>/
    <stem>.png``: labels (T, H, W) in [0, M], slot i written as the object
    id ``object_ids[i]``; only the frames named in ``stems`` are written,
    nearest-resized to ``full_size`` (the video's original size) first."""
    remap = np.zeros(labels.max() + 1 if labels.size else 1, np.uint8)
    for i, oid in enumerate(object_ids):
        if i + 1 < len(remap):
            remap[i + 1] = oid
    for t, stem in enumerate(stems):
        lab = labels[t].astype(np.uint8)
        if full_size is not None and lab.shape != tuple(full_size):
            lab = upsample_labels(lab[None], full_size)[0]
        InferenceEngine.write_png(
            remap[lab], os.path.join(out_dir, "Annotations", vid, f"{stem}.png"))
