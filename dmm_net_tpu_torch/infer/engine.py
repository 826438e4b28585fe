"""Per-sequence streaming inference engine.

Counterpart of the JAX package's infer/engine.py. The JAX package scans a
K-frame chunk in one device dispatch; here a chunk is a Python loop over its
frames, with the frame step's tensors kept on the device and one host copy
of the labels and assignments at the end of the sequence.

Per frame: paste compact proposals onto the mask grid, run the DMM frame
step (backbone, fused pooling/cost/Sinkhorn kernel, aggregation, decoder),
and resolve overlaps into uint8 labels (fused upsample/argmax kernel for
mask-grid logits). With ``matching.decode="hungarian"`` the step runs in two
halves around a host-side Hungarian decode of X (``run_sequence`` only).

Not ported: the multi-device mesh (ROADMAP.md §A, item 9).
"""

from __future__ import annotations

import math
import os
import struct
import time
import zlib
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from dmm_net_tpu_torch import resolve_device
from dmm_net_tpu_torch.config import Config
from dmm_net_tpu_torch.kernels.resolve import fused_resolve_upsample
from dmm_net_tpu_torch.models.dmm import (DMMNet, _mask_dtype, _to_mask_grid,
                                          mask_hw)
from dmm_net_tpu_torch.models.proposal.maskrcnn import paste_masks
from dmm_net_tpu_torch.ops.matching import hard_assignment_hungarian
from dmm_net_tpu_torch.ops.resize import resize
from dmm_net_tpu_torch.weights import load_flax_variables


def _davis_palette() -> np.ndarray:
    """The 256-entry VOC/DAVIS colormap."""
    palette = np.zeros((256, 3), np.uint8)
    for i in range(256):
        lab, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((lab >> 0) & 1) << (7 - j)
            g |= ((lab >> 1) & 1) << (7 - j)
            b |= ((lab >> 2) & 1) << (7 - j)
            lab >>= 3
        palette[i] = (r, g, b)
    return palette


DAVIS_PALETTE = _davis_palette()


def _grid_like(m: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Match a host-provided mask stack to the carried template grid."""
    return resize(m, ref.shape[-2:]).to(ref.dtype)


def resolve_overlaps(logits: torch.Tensor, tmpl_valid: torch.Tensor,
                     bg_threshold: float = 0.5) -> torch.Tensor:
    """Pixel-wise argmax over background + objects: logits (B, M, H, W) ->
    uint8 labels (B, H, W), 0 = background (the sigmoid threshold in logit
    space); ties go to the lower object index, ties with background to
    background."""
    bg_logit = math.log(bg_threshold / (1 - bg_threshold))
    masked = torch.where(tmpl_valid.bool()[..., None, None], logits,
                         torch.full_like(logits, -1e4))
    best, idx = masked.max(dim=1)
    return torch.where(best > bg_logit, idx + 1,
                       torch.zeros_like(idx)).to(torch.uint8)


def resolve_labels(logits: torch.Tensor, tmpl_valid: torch.Tensor,
                   image_hw) -> torch.Tensor:
    """Logits at any resolution -> uint8 labels at image_hw. Full-resolution
    logits take resolve_overlaps; mask-grid logits take the fused
    upsample + argmax (the CUDA kernel for CUDA tensors, its plain version
    for CPU tensors)."""
    if tuple(logits.shape[-2:]) == tuple(image_hw):
        return resolve_overlaps(logits, tmpl_valid)
    return fused_resolve_upsample(logits.contiguous(), tmpl_valid,
                                  tuple(image_hw))


_BUCKETS = (1, 2, 4, 8, 16, 32)


def bucket_objects(count: int, m_max: int) -> int:
    """Smallest bucket size >= count (capped at m_max): the decoder's cost
    is linear in the padded object count."""
    for b in _BUCKETS:
        if b >= max(count, 1):
            return min(b, m_max)
    return m_max


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md §A, "
                               f"{item})")


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


class InferenceEngine:
    """Streaming per-sequence inference on one device.

    ``model``: a DMMNet; built from ``cfg`` with random weights from
    ``seed`` when omitted. ``variables``: optional JAX-package checkpoint
    variables ({"params", "batch_stats"} as nested numpy dicts), loaded
    into the model. Runs on CUDA unless ``device`` says otherwise."""

    def __init__(self, cfg: Config, model: Optional[DMMNet] = None,
                 variables=None, update_templates: bool = True,
                 bucket_templates: bool = True, mesh=None, device=None,
                 seed: int = 0):
        if mesh is not None:
            raise _not_ported("the multi-device mesh", "item 9")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model if model is not None else DMMNet(
            cfg, device=self.device, seed=seed)
        if variables is not None:
            load_flax_variables(self.model, variables)
        self.update_templates = update_templates
        self.bucket_templates = bucket_templates
        # host seconds spent in the Hungarian decode (scipy), summed over steps
        self.hungarian_host_s = 0.0

    # -- host <-> device ---------------------------------------------------
    def _t(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _bucket_slice(self, tmpl_masks, tmpl_valid, extras=()):
        """Slice template arrays down to the active-object bucket (valid
        slots must be contiguous from 0; otherwise nothing is sliced)."""
        M = tmpl_valid.shape[1]
        if not self.bucket_templates:
            return tmpl_masks, tmpl_valid, extras
        valid_np = np.asarray(tmpl_valid)
        count = int(valid_np.sum(axis=1).max())
        if not all((v[:v.sum()].all() and not v[v.sum():].any())
                   for v in valid_np):
            return tmpl_masks, tmpl_valid, extras
        M_b = bucket_objects(count, M)
        if M_b >= M:
            return tmpl_masks, tmpl_valid, extras
        return (tmpl_masks[:, :M_b], tmpl_valid[:, :M_b],
                tuple(None if e is None else e[:, :M_b] for e in extras))

    # -- pieces ------------------------------------------------------------
    def _template_features(self, frame0, tmpl_masks):
        feats = self.model.extract_features(frame0)
        return self.model.pool_mask_features(feats, tmpl_masks)

    def _template_features_per_object(self, obj_frames, tmpl_masks):
        """Pool each object's template features from its own first annotated
        frame: obj_frames (B, M, H, W, 3), tmpl_masks (B, M, H, W) ->
        (B, M, D)."""
        B, M = obj_frames.shape[:2]
        feats = self.model.extract_features(
            obj_frames.reshape((B * M,) + tuple(obj_frames.shape[2:])))
        flat = tmpl_masks.reshape((B * M, 1) + tuple(tmpl_masks.shape[2:]))
        return self.model.pool_mask_features(feats, flat).reshape(B, M, -1)

    def _resolve(self, logits, tmpl_valid):
        return resolve_labels(logits, tmpl_valid, self.cfg.model.image_size)

    def _paste(self, boxes, masks28, valid):
        """Compact proposals (boxes (B, N, 4) in image coordinates, box-local
        masks (B, N, mh, mw)) -> binary masks on the mask grid."""
        H, W = self.cfg.model.image_size
        mh, mw = mask_hw(self.cfg)
        scale = torch.tensor([mw / W, mh / H, mw / W, mh / H],
                             dtype=torch.float32, device=boxes.device)
        return paste_masks(masks28.float(), boxes.float() * scale, valid,
                           (mh, mw), dtype=_mask_dtype(self.cfg))

    def _frame_step(self, frame, prop_masks, prop_valid, tmpl_feats,
                    tmpl_valid, state):
        out, new_state = self.model(frame, prop_masks, prop_valid,
                                    tmpl_feats, tmpl_valid, state)
        return self._finish_step(out, new_state, state, tmpl_valid)

    def _finish_step(self, out, new_state, state, tmpl_valid):
        """Labels from the step's logits; the carried templates stay the
        frame-1 ones without template updates."""
        labels = self._resolve(out.logits, tmpl_valid)
        if not self.update_templates:
            new_state = new_state._replace(template_masks=state.template_masks)
        return labels, out.assignment, new_state

    def _frame_step_compact(self, frame, prop_boxes, prop_masks28, prop_valid,
                            tmpl_feats, tmpl_valid, state):
        pm = self._paste(prop_boxes, prop_masks28, prop_valid)
        return self._frame_step(frame, pm, prop_valid, tmpl_feats, tmpl_valid,
                                state)

    def _hungarian_step(self, frame, prop_masks, prop_valid, tmpl_feats,
                        tmpl_valid, state):
        """One-to-one decode in two halves: soft X on the device, the
        Hungarian decode on the host, then aggregation + refinement from the
        one-hot X. The proposals go to the mask grid once, for both halves."""
        cfg = self.cfg
        prop_masks = _to_mask_grid(prop_masks.to(_mask_dtype(cfg)), mask_hw(cfg))
        feats, X = self.model.match_assignment(frame, prop_masks, prop_valid,
                                               tmpl_feats, tmpl_valid, state)
        Xn = X.cpu().numpy()
        rows, cols = tmpl_valid.cpu().numpy(), prop_valid.cpu().numpy()
        t0 = time.perf_counter()
        idx = hard_assignment_hungarian(Xn, rows, cols)
        self.hungarian_host_s += time.perf_counter() - t0
        Xh = np.zeros_like(Xn)
        b_ix, m_ix = np.nonzero(idx >= 0)
        Xh[b_ix, m_ix, idx[b_ix, m_ix]] = 1.0
        out, new_state = self.model.decode_from_assignment(
            feats, self._t(Xh), prop_masks, tmpl_valid, state)
        return self._finish_step(out, new_state, state, tmpl_valid)

    def _run_chunk(self, step, per_frame, tmpl_feats, tmpl_valid, state, t0,
                   live_from, tmpl_masks0):
        """Run ``step`` over the K frames of ``per_frame`` (tensors (K, B, ...))
        in order. With ``live_from`` (B, M), a slot before its first
        annotated frame is masked out and keeps its initial template
        ``tmpl_masks0``. Returns labels (K, B, H, W), assignments
        (K, B, M, N) and the carried state."""
        labels, X = [], []
        for k in range(per_frame[0].shape[0]):
            valid_t = (tmpl_valid if live_from is None
                       else tmpl_valid & (t0 + k >= live_from))
            lab, x, state = step(*(a[k] for a in per_frame), tmpl_feats,
                                 valid_t, state)
            if self.update_templates and live_from is not None:
                state = state._replace(template_masks=torch.where(
                    valid_t[..., None, None], state.template_masks,
                    _grid_like(tmpl_masks0, state.template_masks)))
            labels.append(lab)
            X.append(x)
        return torch.stack(labels), torch.stack(X), state

    def _chunk_step(self, frames, prop_masks, prop_valid, tmpl_feats,
                    tmpl_valid, state, t0=0, live_from=None, tmpl_masks0=None):
        """K frames with full-grid proposal masks (K, B, N, h, w)."""
        return self._run_chunk(self._frame_step,
                               (frames, prop_masks, prop_valid), tmpl_feats,
                               tmpl_valid, state, t0, live_from, tmpl_masks0)

    def _chunk_step_compact(self, frames, prop_boxes, prop_masks28, prop_valid,
                            tmpl_feats, tmpl_valid, state, t0=0,
                            live_from=None, tmpl_masks0=None):
        """K frames of compact proposals: boxes + box-local masks cross the
        host boundary and are pasted on the device frame by frame."""
        return self._run_chunk(self._frame_step_compact,
                               (frames, prop_boxes, prop_masks28, prop_valid),
                               tmpl_feats, tmpl_valid, state, t0, live_from,
                               tmpl_masks0)

    # -- host loops --------------------------------------------------------
    @torch.no_grad()
    def run_sequence(self, frames_iter: Iterator[Dict[str, np.ndarray]],
                     tmpl_masks: np.ndarray, tmpl_valid: np.ndarray,
                     first_frame: np.ndarray) -> Dict[str, np.ndarray]:
        """One frame step per item. Items are {"frame", "prop_masks",
        "prop_valid"} or the compact {"frame", "prop_boxes", "prop_masks28",
        "prop_valid"}. Returns labels (T, B, H, W) uint8 and assignments
        (T, B, M, N) padded back to M_max. With ``matching.decode=
        "hungarian"`` every item must carry full-grid masks."""
        hungarian = self.cfg.matching.decode == "hungarian"
        M_full = tmpl_valid.shape[1]
        tmpl_masks, tmpl_valid, _ = self._bucket_slice(
            np.asarray(tmpl_masks), np.asarray(tmpl_valid))
        tmpl_masks, tmpl_valid = self._t(tmpl_masks), self._t(tmpl_valid)
        tmpl_feats = self._template_features(self._t(first_frame), tmpl_masks)
        state = self.model.init_state(tmpl_masks)
        labels_out, assign_out = [], []
        for item in frames_iter:
            if hungarian:
                if "prop_boxes" in item:
                    raise ValueError("hungarian decode supports full-mask "
                                     "items only")
                labels, X, state = self._hungarian_step(
                    self._t(item["frame"]), self._t(item["prop_masks"]),
                    self._t(item["prop_valid"]), tmpl_feats, tmpl_valid, state)
            elif "prop_boxes" in item:
                labels, X, state = self._frame_step_compact(
                    self._t(item["frame"]), self._t(item["prop_boxes"]),
                    self._t(item["prop_masks28"]), self._t(item["prop_valid"]),
                    tmpl_feats, tmpl_valid, state)
            else:
                labels, X, state = self._frame_step(
                    self._t(item["frame"]), self._t(item["prop_masks"]),
                    self._t(item["prop_valid"]), tmpl_feats, tmpl_valid, state)
            labels_out.append(labels)
            assign_out.append(X)
        return self._gather(labels_out, assign_out, M_full)

    @staticmethod
    def _gather(labels_out, assign_out, M_full):
        labels = torch.stack(labels_out).cpu().numpy()
        assignments = torch.stack(assign_out).cpu().numpy()
        if assignments.shape[2] < M_full:      # pad bucketed slots back
            assignments = np.pad(assignments, ((0, 0), (0, 0),
                                               (0, M_full - assignments.shape[2]),
                                               (0, 0)))
        return {"labels": labels, "assignments": assignments}

    def _reject_hungarian(self, where: str) -> None:
        """The Hungarian decode runs on the host between two device halves
        (run_sequence only)."""
        if self.cfg.matching.decode == "hungarian":
            raise ValueError(
                f"{where} cannot apply matching.decode='hungarian' (host-"
                "side two-phase decode); use run_sequence / --per-frame")

    @torch.no_grad()
    def run_sequence_chunked(self, frames: np.ndarray, prop_masks: np.ndarray,
                             prop_valid: np.ndarray, tmpl_masks: np.ndarray,
                             tmpl_valid: np.ndarray, chunk: int = 8
                             ) -> Dict[str, np.ndarray]:
        """Whole-sequence inference, K frames per chunk (the last chunk may
        be shorter), no object bucketing. frames (T, B, H, W, 3); prop_masks
        (T, B, N, H, W) full-grid; prop_valid (T, B, N); tmpl_masks (B, M,
        H, W); tmpl_valid (B, M). One chunk of inputs is on the device at a
        time."""
        self._reject_hungarian("run_sequence_chunked")
        T = frames.shape[0]
        tmpl_masks, tmpl_valid = self._t(tmpl_masks), self._t(tmpl_valid)
        tmpl_feats = self._template_features(self._t(frames[0]), tmpl_masks)
        state = self.model.init_state(tmpl_masks)
        labels_out, assign_out = [], []
        for t0 in range(0, T, chunk):
            sl = slice(t0, min(t0 + chunk, T))
            labels, X, state = self._chunk_step(
                self._t(frames[sl]), self._t(prop_masks[sl]),
                self._t(prop_valid[sl]), tmpl_feats, tmpl_valid, state)
            labels_out.extend(labels.unbind(0))
            assign_out.extend(X.unbind(0))
        return self._gather(labels_out, assign_out, tmpl_valid.shape[1])

    @torch.no_grad()
    def run_stream_chunked(self, frames_iter: Iterator[Dict[str, np.ndarray]],
                           tmpl_masks: np.ndarray, tmpl_valid: np.ndarray,
                           first_frame: np.ndarray, chunk: int = 8,
                           live_from: Optional[np.ndarray] = None,
                           tmpl_frames: Optional[np.ndarray] = None
                           ) -> Dict[str, np.ndarray]:
        """Consume the per-frame item stream ``chunk`` frames at a time (only
        one chunk of proposals is host-resident). Mid-video objects: pass
        ``live_from`` (B, M) first-frame indices and ``tmpl_frames``
        (B, M, H, W, 3) per-object template frames."""
        self._reject_hungarian("run_stream_chunked")
        M_full = tmpl_valid.shape[1]
        tmpl_masks, tmpl_valid, (live_from, tmpl_frames) = \
            self._bucket_slice(np.asarray(tmpl_masks), np.asarray(tmpl_valid),
                               extras=(live_from, tmpl_frames))
        tmpl_masks, tmpl_valid = self._t(tmpl_masks), self._t(tmpl_valid)
        if tmpl_frames is not None:
            tmpl_feats = self._template_features_per_object(
                self._t(tmpl_frames), tmpl_masks)
        else:
            tmpl_feats = self._template_features(self._t(first_frame),
                                                 tmpl_masks)
        state = self.model.init_state(tmpl_masks)
        live = (None if live_from is None
                else self._t(np.asarray(live_from, np.int64)))
        labels_out, assign_out = [], []
        buf: list = []
        t_seen = 0

        def flush():
            nonlocal state, t_seen
            if not buf:
                return

            def stack(key):
                # items staged on the device (data/pipeline.RingStager) stay
                # there; numpy items are stacked on the host and copied once
                vals = [b[key] for b in buf]
                if isinstance(vals[0], torch.Tensor):
                    return self._t(torch.stack(vals))
                return self._t(np.stack(vals))

            if "prop_boxes" in buf[0]:
                labels, X, state = self._chunk_step_compact(
                    stack("frame"), stack("prop_boxes"), stack("prop_masks28"),
                    stack("prop_valid"), tmpl_feats, tmpl_valid, state,
                    t_seen, live, tmpl_masks if live is not None else None)
            else:
                labels, X, state = self._chunk_step(
                    stack("frame"), stack("prop_masks"), stack("prop_valid"),
                    tmpl_feats, tmpl_valid, state, t_seen, live,
                    tmpl_masks if live is not None else None)
            labels_out.extend(labels.unbind(0))
            assign_out.extend(X.unbind(0))
            t_seen += len(buf)
            buf.clear()

        for item in frames_iter:
            buf.append(item)
            if len(buf) == chunk:
                flush()
        flush()
        return self._gather(labels_out, assign_out, M_full)

    @staticmethod
    def write_png(labels: np.ndarray, path: str) -> None:
        """Write an (H, W) label map as an 8-bit palette PNG with the DAVIS
        palette (standard library only: zlib + struct)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        lab = np.ascontiguousarray(labels.astype(np.uint8))
        h, w = lab.shape
        rows = np.concatenate([np.zeros((h, 1), np.uint8), lab], 1)  # filter 0
        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n")
            f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3,
                                                    0, 0, 0)))
            f.write(_png_chunk(b"PLTE", DAVIS_PALETTE.tobytes()))
            f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
            f.write(_png_chunk(b"IEND", b""))
