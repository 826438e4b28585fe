"""The one traffic generator: every mix is a data file of parameters
(``benchmark/traffic/<name>.json``) that this module reads. Two kinds:

``video_offline`` -- an offline evaluator's requests: each request is a
batch of videos of one length, run front to back. A bank of videos is
drawn on the device from the seed (moving rectangles and ellipses over a
shaded background, as the program's ``data/synthetic.py`` draws them), with
each frame's compact proposals (boxes in image coordinates and 28x28
box-local masks: the objects' boxes jittered, then decoys) and each video's
first-frame template masks on the mask grid. A request takes a contiguous
block of bank videos and its first T frames; the lengths are a fixed list
in an order drawn from the seed, so every seed sends the same set of sizes.

``train_clips`` -- a trainer's batches: clips of T frames at full size with
ground truth, full-grid proposal masks (jittered ground truth and decoys)
and first-frame templates, padded to the configuration's M and N. A pool of
distinct batches is drawn on the device from the seed; the steps cycle it.

Everything is drawn from ``torch.Generator`` / ``numpy`` generators seeded
by the run's seed; the same seed gives the same requests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch


def _gen(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return g


def _u(shape, lo, hi, g, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _objects(shape, H: int, W: int, L: int, g, device, size=(0.06, 0.16)):
    """Objects' tracks: per slot a shape (0 rect, 1 ellipse), half sizes
    (sy, sx), a colour, and centres (..., L, 2) moving at a constant
    velocity, kept inside the frame."""
    sy = _u(shape, size[0], size[1], g, device) * H
    sx = sy * _u(shape, 0.6, 1.4, g, device)
    c0 = torch.stack([_u(shape, 0.2, 0.8, g, device) * H,
                      _u(shape, 0.2, 0.8, g, device) * W], -1)
    vel = torch.randn(shape + (2,), generator=g, device=device) * (H / 160.0)
    t = torch.arange(L, device=device, dtype=torch.float32)
    c = c0[..., None, :] + vel[..., None, :] * t[:, None]
    cy = torch.minimum(torch.maximum(c[..., 0], sy[..., None]), H - sy[..., None])
    cx = torch.minimum(torch.maximum(c[..., 1], sx[..., None]), W - sx[..., None])
    return {"shape": torch.randint(0, 2, shape, generator=g, device=device),
            "sy": sy, "sx": sx, "cy": cy, "cx": cx,
            "color": _u(shape + (3,), 60.0, 255.0, g, device)}


def _inside(shape, cy, cx, sy, sx, yy, xx):
    """Masks of rectangles (shape 0) or ellipses (1): every argument
    broadcasts against the pixel grid ``yy`` (h, 1), ``xx`` (1, w)."""
    dy, dx = (yy - cy) / sy, (xx - cx) / sx
    return torch.where(shape == 1, dy * dy + dx * dx < 1.0,
                       (dy.abs() < 1.0) & (dx.abs() < 1.0))


def _grid(h, w, H, W, device):
    """Pixel centres of an (h, w) grid in (H, W) image coordinates."""
    yy = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) * (H / h)
    xx = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) * (W / w)
    return yy[:, None], xx[None, :]


def _background(lead, g, device):
    """Per video a base colour and a linear shade across the frame."""
    return _u(lead + (3,), 20.0, 90.0, g, device), _u(lead + (2,), -40.0, 40.0, g, device)


def _paint(lead, bg, obj, count, H, W, device):
    """uint8 frames (V, L, H, W, 3): each video's shaded background, then
    its valid objects painted in slot order (later slots occlude)."""
    base, grad = bg
    yy, xx = _grid(H, W, H, W, device)
    out = []
    for i in range(lead[0]):            # one video (or clip) at a time
        f = (base[i][..., None, None, None, :]
             + grad[i][..., None, None, None, 0:1] * (yy / H)[..., None]
             + grad[i][..., None, None, None, 1:2] * (xx / W)[..., None])
        L = obj["cy"].shape[-1]
        f = f.expand(lead[1:] + (L, H, W, 3)).clone()
        for m in range(obj["sy"].shape[-1]):
            sl = (i,) + (slice(None),) * (len(lead) - 1) + (m,)
            on = _inside(obj["shape"][sl][..., None, None, None],
                         obj["cy"][sl][..., None, None], obj["cx"][sl][..., None, None],
                         obj["sy"][sl][..., None, None, None],
                         obj["sx"][sl][..., None, None, None], yy, xx)
            on = on & (m < count[i])[..., None, None, None]
            f = torch.where(on[..., None], obj["color"][sl][..., None, None, None, :], f)
        out.append(f.round().clamp(0, 255).to(torch.uint8))
    return torch.stack(out)


def _proposal_params(lead, L, N, count, obj, plo, phi, jitter, H, W, g, device):
    """Each frame's N proposal slots, valid ones first in a shuffled order:
    (shape, cy, cx, sy, sx) of the objects' jittered boxes, then decoys;
    ``valid`` (..., L, N)."""
    shp = lead + (L, N)
    n_valid = torch.randint(plo, phi + 1, shp[:-1], generator=g, device=device)
    n_valid = torch.maximum(n_valid, count[..., None])
    M = obj["sy"].shape[-1]
    slot = torch.arange(N, device=device)

    def from_obj(key):          # (..., L, N): object j's value in slot j < M
        v = obj[key]
        v = v[..., None].expand(v.shape + (L,)) if v.dim() == len(lead) + 1 else v
        v = v.movedim(len(lead), -1)                           # (..., L, M)
        pad = torch.zeros(v.shape[:-1] + (N - M,), dtype=v.dtype, device=device)
        return torch.cat([v, pad], -1)

    is_obj = slot < count[..., None, None]
    jit = lambda: 1.0 + jitter * torch.randn(shp, generator=g, device=device)
    sy = torch.where(is_obj, from_obj("sy") * jit(), _u(shp, 0.03, 0.15, g, device) * H)
    sx = torch.where(is_obj, from_obj("sx") * jit(), sy * _u(shp, 0.6, 1.4, g, device))
    cy = torch.where(is_obj, from_obj("cy") + jitter * sy * torch.randn(shp, generator=g, device=device),
                     _u(shp, 0.05, 0.95, g, device) * H)
    cx = torch.where(is_obj, from_obj("cx") + jitter * sx * torch.randn(shp, generator=g, device=device),
                     _u(shp, 0.05, 0.95, g, device) * W)
    shape = torch.where(is_obj, from_obj("shape"),
                        torch.randint(0, 2, shp, generator=g, device=device))
    valid = slot < n_valid[..., None]
    key = torch.rand(shp, generator=g, device=device) + (~valid).float() * 2.0
    perm = key.argsort(-1)
    take = lambda v: torch.gather(v, -1, perm)
    return {"shape": take(shape), "cy": take(cy), "cx": take(cx), "sy": take(sy),
            "sx": take(sx), "valid": take(valid)}


# -- video_offline -------------------------------------------------------------

@dataclass
class VideoBank:
    """The requests' material on the device: frames (V, L, H, W, 3) uint8,
    boxes (V, L, N, 4), masks28 (V, L, N, 28, 28) uint8, valid (V, L, N)
    bool; on the host, tmpl_masks (V, M, h, w) float32 at the mask grid and
    tmpl_valid (V, M) bool; counts (V,) objects per video."""
    frames: torch.Tensor
    boxes: torch.Tensor
    masks28: torch.Tensor
    valid: torch.Tensor
    tmpl_masks: np.ndarray
    tmpl_valid: np.ndarray
    counts: np.ndarray


def video_bank(p: dict, sizes: dict, seed: int, device) -> VideoBank:
    V, L = p["bank_videos"], max(p["lengths"])
    H, W = sizes["image_hw"]
    gh, gw = sizes["mask_hw"]
    M, N = sizes["M"], sizes["N"]
    g = _gen(seed, device, 1)
    lo, hi = p["objects"]
    if hi > M or p["proposals_valid"][1] > N:
        raise ValueError(f"traffic needs {hi} objects and {p['proposals_valid'][1]} "
                         f"proposals; the configuration has M={M}, N={N}")
    count = torch.randint(lo, hi + 1, (V,), generator=g, device=device)
    count[::p["most_objects_every"]] = hi          # every block of a batch holds one
    obj = _objects((V, M), H, W, L, g, device)
    frames = _paint((V,), _background((V,), g, device), obj, count, H, W, device)
    yy, xx = _grid(gh, gw, H, W, device)
    sl = (slice(None), slice(None), 0)
    tm = _inside(obj["shape"][..., None, None], obj["cy"][sl][..., None, None],
                 obj["cx"][sl][..., None, None], obj["sy"][..., None, None],
                 obj["sx"][..., None, None], yy, xx)
    slots = torch.arange(M, device=device)
    tvalid = slots[None] < count[:, None]
    tm = (tm & tvalid[..., None, None]).float()
    pp = _proposal_params((V,), L, N, count, obj, *p["proposals_valid"],
                          p["proposal_jitter"], H, W, g, device)
    boxes = torch.stack([pp["cx"] - pp["sx"], pp["cy"] - pp["sy"],
                         pp["cx"] + pp["sx"], pp["cy"] + pp["sy"]], -1)
    unit = (torch.arange(28, device=device, dtype=torch.float32) + 0.5) / 14.0 - 1.0
    disk = (unit[:, None] ** 2 + unit[None, :] ** 2 < 1.0)
    m28 = torch.where(pp["shape"][..., None, None] == 1, disk, torch.ones_like(disk))
    m28 = (m28 & pp["valid"][..., None, None]).to(torch.uint8)
    boxes = torch.where(pp["valid"][..., None], boxes,
                        torch.tensor([0.0, 0.0, 1.0, 1.0], device=device))
    return VideoBank(frames, boxes.float().contiguous(), m28, pp["valid"],
                     tm.cpu().numpy(), tvalid.cpu().numpy(), count.cpu().numpy())


@dataclass
class Request:
    index: int
    T: int          # frames asked for
    start: int      # first bank video of the block


def request_plan(p: dict, seed: int, count: int) -> List[Request]:
    """The first ``count`` requests: lengths in a seed-drawn order of the
    mix's list (cycled), blocks of ``batch_videos`` contiguous bank videos
    at seed-drawn starts."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    lengths = list(p["lengths"])
    order: List[int] = []
    while len(order) < count:
        order += [lengths[i] for i in rng.permutation(len(lengths))]
    starts = rng.integers(0, p["bank_videos"] - p["batch_videos"] + 1, size=count)
    return [Request(i, int(order[i]), int(starts[i])) for i in range(count)]


def request_inputs(bank: VideoBank, req: Request, B: int, T: int):
    """A request's inputs as the program and the reference take them:
    per-frame items (device tensors, views of the bank), template masks and
    validity (host), the first frame (device)."""
    sl = slice(req.start, req.start + B)
    items = [{"frame": bank.frames[sl, t], "prop_boxes": bank.boxes[sl, t],
              "prop_masks28": bank.masks28[sl, t], "prop_valid": bank.valid[sl, t]}
             for t in range(T)]
    return items, bank.tmpl_masks[sl], bank.tmpl_valid[sl], bank.frames[sl, 0]


def stacked_inputs(bank: VideoBank, req: Request, B: int, T: int):
    """The same request as (T, B, ...) stacks for the reference."""
    sl = slice(req.start, req.start + B)
    return (bank.frames[sl, :T].transpose(0, 1), bank.boxes[sl, :T].transpose(0, 1),
            bank.masks28[sl, :T].transpose(0, 1), bank.valid[sl, :T].transpose(0, 1))


# -- train_clips ---------------------------------------------------------------

def clip_pool(p: dict, sizes: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``pool_batches`` batches of ``global_clips`` clips."""
    P, Bg, T = p["pool_batches"], sizes["global_clips"], sizes["T"]
    H, W = sizes["image_hw"]
    M, N = sizes["M"], sizes["N"]
    g = _gen(seed, device, 2)
    lo, hi = p["objects"]
    if hi > M or p["proposals_valid"][1] > N:
        raise ValueError(f"traffic needs {hi} objects and {p['proposals_valid'][1]} "
                         f"proposals; the configuration has M={M}, N={N}")
    count = torch.randint(lo, hi + 1, (P, Bg), generator=g, device=device)
    obj = _objects((P, Bg, M), H, W, T, g, device)
    pp = _proposal_params((P, Bg), T, N, count, obj, *p["proposals_valid"],
                          p["proposal_jitter"], H, W, g, device)
    bg = _background((P, Bg), g, device)
    yy, xx = _grid(H, W, H, W, device)
    slots = torch.arange(M, device=device)
    batches = []
    for b in range(P):
        sub = {k: v[b] for k, v in obj.items()}
        cnt = count[b]
        frames = _paint((cnt.shape[0],), (bg[0][b], bg[1][b]), sub, cnt,
                        H, W, device)
        tvalid = slots[None] < cnt[:, None]
        gt = torch.stack([
            _inside(sub["shape"][:, m, None, None, None], sub["cy"][:, m, :, None, None],
                    sub["cx"][:, m, :, None, None], sub["sy"][:, m, None, None, None],
                    sub["sx"][:, m, None, None, None], yy, xx)
            & tvalid[:, m, None, None, None] for m in range(M)], 2).float()
        q = {k: v[b] for k, v in pp.items()}
        props = torch.stack([          # one clip at a time: small transients
            _inside(q["shape"][r, ..., None, None], q["cy"][r, ..., None, None],
                    q["cx"][r, ..., None, None], q["sy"][r, ..., None, None],
                    q["sx"][r, ..., None, None], yy, xx)
            & q["valid"][r, ..., None, None] for r in range(cnt.shape[0])]).float()
        batches.append({"frames": frames, "prop_masks": props, "prop_valid": q["valid"],
                        "tmpl_masks": gt[:, 0].contiguous(), "tmpl_valid": tvalid,
                        "gt_masks": gt})
    return batches
