"""DAVIS-2017 dataset reader for inference.

Directory layout (the standard DAVIS-2017 release):
    <root>/JPEGImages/480p/<seq>/00000.jpg ...
    <root>/Annotations/480p/<seq>/00000.png ...   (palette-indexed labels)
    <root>/ImageSets/2017/{train,val}.txt
Proposal cache (the JAX package's format): <proposals>/<seq>/00000.json
with [{"rle": {...}, "score": s}, ...]. Without a cache, proposals are
synthesised from the ground truth (the masks, shifted copies and random
boxes) with the JAX package's seeds, so both packages see the same inputs.

Counterpart of the JAX package's data/davis.py: the inference streams and
the training clips (``clip_batches``).
Frames and annotations are decoded as the JAX package's reader decodes
them, through ``data/native_loader.py``: the C++ loader when it builds
(antialiased bilinear frames, nearest labels), else PIL (BILINEAR frames,
NEAREST labels); the reader says which once. Cached proposal masks are
resized with PIL's NEAREST in both packages.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from dmm_net_tpu_torch.data import native_loader
from dmm_net_tpu_torch.ops import rle as rle_codec


def _resize(im, hw: Tuple[int, int], nearest: bool) -> np.ndarray:
    from PIL import Image
    mode = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(im.resize((hw[1], hw[0]), mode))


class DavisDataset:
    """Per-sequence access to DAVIS-2017."""

    def __init__(self, root: str, split: str = "val", year: str = "2017",
                 image_size: Tuple[int, int] = (256, 448),
                 proposal_dir: Optional[str] = None,
                 max_objects: int = 16, max_proposals: int = 128):
        self.root = root
        self.split = split
        self.image_size = image_size
        self.proposal_dir = proposal_dir
        self.max_objects = max_objects
        self.max_proposals = max_proposals
        split_file = os.path.join(root, "ImageSets", year, f"{split}.txt")
        if os.path.exists(split_file):
            with open(split_file) as f:
                self.sequences = [ln.strip() for ln in f if ln.strip()]
        else:
            img_root = os.path.join(root, "JPEGImages", "480p")
            self.sequences = (sorted(os.listdir(img_root))
                              if os.path.isdir(img_root) else [])
        native_loader.announce()

    def frame_paths(self, seq: str) -> List[str]:
        d = os.path.join(self.root, "JPEGImages", "480p", seq)
        return [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith((".jpg", ".png"))]

    def annotation_paths(self, seq: str) -> List[str]:
        d = os.path.join(self.root, "Annotations", "480p", seq)
        return [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith(".png")]

    def load_frame(self, path: str) -> np.ndarray:
        """(H, W, 3) uint8 RGB at image_size."""
        return native_loader.load_rgb_batch([path], self.image_size)[0]

    def load_annotation(self, path: str) -> np.ndarray:
        """Palette-index label map, nearest-resized to image_size."""
        return native_loader.load_label_batch([path], self.image_size)[0]

    def load_annotation_native(self, path: str) -> np.ndarray:
        """Palette-index label map at the annotation's native resolution
        (where the official protocol scores)."""
        a = native_loader.load_label_native_size(path)
        return a[..., 0] if a.ndim == 3 else a       # RGB-coded labels

    def load_proposals(self, seq: str, t: int,
                       gt_labels: Optional[np.ndarray] = None,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """(masks (N, H, W) float32, valid (N,) bool) for frame t: from the
        cache when it has the frame, else synthesised from ``gt_labels``."""
        N = self.max_proposals
        H, W = self.image_size
        masks = np.zeros((N, H, W), np.float32)
        valid = np.zeros((N,), bool)
        if self.proposal_dir is not None:
            pf = os.path.join(self.proposal_dir, seq, f"{t:05d}.json")
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
        # the ground-truth masks, then shifted copies and random boxes
        rng = np.random.RandomState(seed * 10007 + t)
        i = 0
        for oid in sorted(set(np.unique(gt_labels)) - {0}):
            if i >= N:
                break
            masks[i] = (gt_labels == oid)
            valid[i] = True
            i += 1
        for k in range(min(N - i, 2 * i + 4)):
            if i >= N:
                break
            if k % 2 == 0 and i > 0:
                src = masks[rng.randint(i)]
                dy, dx = rng.randint(-12, 13, 2)
                masks[i] = np.roll(np.roll(src, dy, 0), dx, 1)
            else:
                y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
                masks[i, y0:y0 + H // 4, x0:x0 + W // 4] = 1.0
            valid[i] = True
            i += 1
        return masks, valid

    def sequence_stream(self, seq: str) -> Dict:
        """Everything the inference engine needs for one sequence: frame-1
        templates and a generator of per-frame items (batch axis 1)."""
        frames = self.frame_paths(seq)
        anns = self.annotation_paths(seq)
        ann0 = self.load_annotation(anns[0])
        oids = sorted(int(x) for x in set(np.unique(ann0)) - {0})[: self.max_objects]
        M = self.max_objects
        H, W = self.image_size
        tmpl = np.zeros((M, H, W), np.float32)
        tv = np.zeros((M,), bool)
        for i, oid in enumerate(oids):
            tmpl[i] = (ann0 == oid)
            tv[i] = True

        def gen() -> Iterator[Dict[str, np.ndarray]]:
            for t, fp in enumerate(frames):
                img = self.load_frame(fp)
                gt = self.load_annotation(anns[t]) if t < len(anns) else None
                pm, pv = self.load_proposals(seq, t, gt_labels=gt)
                yield {"frame": img[None], "prop_masks": pm[None],
                       "prop_valid": pv[None]}

        return {"name": seq, "frames": gen(), "tmpl_masks": tmpl[None],
                "tmpl_valid": tv[None], "object_ids": oids,
                "first_frame": self.load_frame(frames[0])[None],
                "num_frames": len(frames),
                "annotations": anns}

    def clip_batches(self, batch_size: int, clip_length: int,
                     seed: int = 0, max_objects: Optional[int] = None
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Random training clips in the train/loop.py batch layout, drawn
        as the JAX package's reader draws them (same RandomState order,
        same ground-truth proposals)."""
        rng = np.random.RandomState(seed)
        M = max_objects or self.max_objects
        H, W = self.image_size
        while True:
            batch = {"frames": [], "prop_masks": [], "prop_valid": [],
                     "gt_masks": [], "tmpl_masks": [], "tmpl_valid": []}
            for _ in range(batch_size):
                seq = self.sequences[rng.randint(len(self.sequences))]
                fps = self.frame_paths(seq)
                anns = self.annotation_paths(seq)
                T = min(len(fps), len(anns))
                t0 = rng.randint(0, max(T - clip_length + 1, 1))
                ts = range(t0, min(t0 + clip_length, T))
                ts = list(ts) + [ts[-1]] * (clip_length - len(list(ts)))
                frames, pms, pvs, gts = [], [], [], []
                ann_first = self.load_annotation(anns[ts[0]])
                oids = sorted(int(x) for x in set(np.unique(ann_first)) - {0})[:M]
                for t in ts:
                    frames.append(self.load_frame(fps[t]))
                    gt = self.load_annotation(anns[t])
                    pm, pv = self.load_proposals(seq, t, gt_labels=gt,
                                                 seed=seed)
                    pms.append(pm)
                    pvs.append(pv)
                    g = np.zeros((M, H, W), np.float32)
                    for i, oid in enumerate(oids):
                        g[i] = (gt == oid)
                    gts.append(g)
                tm = np.zeros((M, H, W), np.float32)
                tv = np.zeros((M,), bool)
                for i, oid in enumerate(oids):
                    tm[i] = (ann_first == oid)
                    tv[i] = True
                batch["frames"].append(np.stack(frames))
                batch["prop_masks"].append(np.stack(pms))
                batch["prop_valid"].append(np.stack(pvs))
                batch["gt_masks"].append(np.stack(gts))
                batch["tmpl_masks"].append(tm)
                batch["tmpl_valid"].append(tv)
            yield {k: np.stack(v) for k, v in batch.items()}
