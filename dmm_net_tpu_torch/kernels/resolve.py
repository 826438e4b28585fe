"""Fused bilinear-upsample + overlap-argmax label resolution.

Replaces the TPU kernel ``fused_resolve_upsample`` (body ``_resolve_kernel``)
in dmm_net_tpu/kernels/resolve.py. The decoder leaves logits at its stride-4
mask grid; this turns them into full-resolution uint8 labels without ever
materialising the (B, M, H, W) upsampled logits. The CUDA source is
``csrc/resolve.cu`` (one thread per output pixel, two row and two column
taps, bf16-rounded column pass, running max/argmax over valid slots). What
bounds it on the card is bytes: at p3 B=16 it must read 7.3 MB of float32
logits and write 1.8 MB of labels, ~2.7 us at 3.35 TB/s.

Semantics (both versions): logits are rounded to bf16, the column pass
(w -> W) is rounded to bf16, the row pass (h -> H) accumulates in f32;
invalid slots never win; strict ``>`` keeps the lower index on ties;
label = idx + 1 where the best value > logit(bg_threshold), else 0.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from dmm_net_tpu_torch.kernels import _build


@functools.lru_cache(maxsize=32)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) matrix I with upsample(x) == x @ I: triangle weights at
    half-pixel sample centers with edge clamp (jax.image.resize's bilinear
    upsampling convention)."""
    out = np.zeros((n_in, n_out), np.float32)
    if n_in == n_out:
        np.fill_diagonal(out, 1.0)
        return out
    scale = n_in / n_out
    for o in range(n_out):
        x = min(max((o + 0.5) * scale - 0.5, 0.0), n_in - 1.0)
        i0 = int(np.floor(x))
        f = x - i0
        i1 = min(i0 + 1, n_in - 1)
        out[i0, o] += 1.0 - f
        out[i1, o] += f
    return out


def _bf16_matrix(n_in: int, n_out: int) -> torch.Tensor:
    return torch.from_numpy(_interp_matrix(n_in, n_out)).to(torch.bfloat16)


@functools.lru_cache(maxsize=32)
def _taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (at most two) nonzero entries of each column of the bf16-rounded
    interpolation matrix: indices (n_out, 2) int32, weights (n_out, 2) f32.
    A column with one nonzero gets a second tap of weight 0."""
    mat = _bf16_matrix(n_in, n_out).float().numpy()
    idx = np.zeros((n_out, 2), np.int32)
    wts = np.zeros((n_out, 2), np.float32)
    for o in range(n_out):
        nz = np.nonzero(mat[:, o])[0]
        if not 1 <= nz.size <= 2:
            raise AssertionError(f"interp column {o} has {nz.size} taps")
        idx[o, :] = nz[0]
        idx[o, :nz.size] = nz
        wts[o, :nz.size] = mat[nz, o]
    return idx, wts


@functools.lru_cache(maxsize=16)
def _device_taps(h: int, w: int, H: int, W: int, device: str):
    ri, rw = _taps(h, H)
    ci, cw = _taps(w, W)
    dev = torch.device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (ri, rw, ci, cw))


def _bg_logit(bg_threshold: float) -> float:
    return float(math.log(bg_threshold / (1.0 - bg_threshold)))


def resolve_upsample_plain(logits: torch.Tensor, tmpl_valid: torch.Tensor,
                           out_hw: Sequence[int],
                           bg_threshold: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: the same bf16 operands and column-then-row
    association as the kernel (and as the JAX package's
    resolve_upsample_jnp)."""
    B, M, h, w = logits.shape
    H, W = out_hw
    dev = logits.device
    lg = logits.to(torch.bfloat16).float()
    R = _bf16_matrix(h, H).float().to(dev)                  # (h, H)
    C = _bf16_matrix(w, W).float().to(dev)                  # (w, W)
    u1 = (lg @ C).to(torch.bfloat16).float()                # (B, M, h, W)
    up = torch.einsum("hH,bmhW->bmHW", R, u1)
    up = torch.where(tmpl_valid.bool()[..., None, None], up,
                     torch.full_like(up, -math.inf))
    best, idx = up.max(dim=1)
    # torch.max returns the first maximal index, as jnp.argmax does
    return torch.where(best > _bg_logit(bg_threshold), idx + 1,
                       torch.zeros_like(idx)).to(torch.uint8)


def fused_resolve_upsample(logits: torch.Tensor, tmpl_valid: torch.Tensor,
                           out_hw: Sequence[int],
                           bg_threshold: float = 0.5) -> torch.Tensor:
    """logits (B, M, h, w) float32 or bfloat16 at the mask grid, tmpl_valid
    (B, M) -> labels (B, H, W) uint8 at full resolution."""
    if logits.dim() != 4:
        raise ValueError(f"logits must be (B, M, h, w), got {tuple(logits.shape)}")
    B, M, h, w = logits.shape
    H, W = int(out_hw[0]), int(out_hw[1])
    if tuple(tmpl_valid.shape) != (B, M):
        raise ValueError(f"tmpl_valid: shape {tuple(tmpl_valid.shape)}, "
                         f"expected {(B, M)}")
    if tmpl_valid.device != logits.device:
        raise ValueError("tmpl_valid and logits lie on different devices")
    if logits.device.type == "cpu":
        return resolve_upsample_plain(logits, tmpl_valid, (H, W), bg_threshold)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_resolve_upsample: unsupported device {logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"logits: needs float32 or bfloat16, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    if not 1 <= M <= 255:
        raise ValueError(f"M={M}: labels are uint8, so 1 <= M <= 255")

    valid = tmpl_valid.to(torch.uint8).contiguous()
    ri, rw, ci, cw = _device_taps(h, w, H, W, str(logits.device))
    out = torch.empty((B, H, W), dtype=torch.uint8, device=logits.device)
    lib = _build.library("resolve")
    fn = (lib.dmm_resolve_upsample_f32 if logits.dtype == torch.float32
          else lib.dmm_resolve_upsample_bf16)
    with torch.cuda.device(logits.device):
        err = fn(logits.data_ptr(), valid.data_ptr(), ri.data_ptr(),
                 rw.data_ptr(), ci.data_ptr(), cw.data_ptr(), out.data_ptr(),
                 B, M, h, w, H, W, _bg_logit(bg_threshold),
                 torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(err, "fused_resolve_upsample")
    _build.count("fused_resolve_upsample")
    return out
