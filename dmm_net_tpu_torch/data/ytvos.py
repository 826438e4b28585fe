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

Counterpart of the JAX package's data/ytvos.py as its inference CLI uses
it; training clips (``clip_batches``) come with training. Images are
decoded with PIL, imported only when a file is read, with the resizes of
the port's DAVIS reader (BILINEAR frames, NEAREST labels and masks).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from dmm_net_tpu_torch.data.davis import _open, _resize
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
        with _open(path) as im:
            return _resize(im.convert("RGB"), self.image_size, nearest=False)

    def load_annotation(self, path: str) -> np.ndarray:
        """Palette-index label map, nearest-resized to image_size."""
        with _open(path) as im:
            a = _resize(im, self.image_size, nearest=True)
        return a[..., 0] if a.ndim == 3 else a

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
