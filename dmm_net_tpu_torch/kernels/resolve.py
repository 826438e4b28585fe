"""Fused bilinear-upsample + overlap-argmax label resolution (kernel B2).

Replaces the TPU kernel ``fused_resolve_upsample`` (body ``_resolve_kernel``)
in dmm_net_tpu/kernels/resolve.py. The decoder leaves logits at its stride-4
mask grid; this turns them into full-resolution uint8 labels without ever
materialising the (B, M, H, W) upsampled logits.

The CUDA source is ``csrc/resolve.cu``: one block per (batch element, band
of 32 output rows, tile of 32 output columns; the source fixes both and
tells the wrapper through ``dmm_resolve_band_rows`` and
``dmm_resolve_tile_cols``). The block compacts the valid slots once,
stages each valid object's window of logits in shared memory, runs the
column pass once per
(object, window row, output column), then each thread walks the valid
objects in index order for 4 columns of 2 rows with the running max and
argmax in registers. ``band_windows`` and ``tile_windows`` cut the windows
(each band's and tile's first input row or column, and the largest window,
which sizes shared memory); the wrapper raises where they would not fit.

On an NVIDIA H100 80GB HBM3 at a 700 W power limit it takes 0.0195 ms at p3
B=16 (16 objects, 64x112 -> 256x448, float32 logits, 190 of 256 slots
valid) against a bound of 0.0022 ms (the valid slots' 5.45 MB of logits
read and 1.84 MB of labels written at 3.35 TB/s), and 0.0075 ms at the main
path's B=4 (bound 0.00054 ms). Bytes do not bound it: the row pass and
argmax (about six instructions per pixel and valid object) and the
per-block work around them do (phase cuts in PERF.md).

Semantics (both versions): logits are rounded to bf16, the column pass
(w -> W) is rounded to bf16, the row pass (h -> H) accumulates in f32;
invalid slots never win; strict ``>`` keeps the lower index on ties;
label = idx + 1 where the best value > logit(bg_threshold), else 0.
Every product is of two bf16 values, exact in f32, and every sum has at
most two nonzero terms, so each pass rounds once in any order: the kernel,
``resolve_upsample_plain`` and the dense-matmul form give equal labels.
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


@functools.lru_cache(maxsize=32)
def _pair_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The taps as a pair of neighbours: first index (n_out,) int32 and the
    weights of it and of the next (n_out, 2) f32 (0 where the matrix has
    one nonzero). The first index is at most n_in - 2, so that both lie in
    [0, n_in) for n_in >= 2."""
    idx, wts = _taps(n_in, n_out)
    first = np.minimum(idx[:, 0], max(n_in - 2, 0)).astype(np.int32)
    pair = np.zeros((n_out, 2), np.float32)
    for k in range(2):
        pos = idx[:, k] - first
        if not ((pos >= 0) & (pos <= 1)).all():
            raise AssertionError("interp taps are not neighbours")
        np.add.at(pair, (np.arange(n_out), pos), wts[:, k])
    return first, pair


def _windows(first: np.ndarray, last: np.ndarray, n_in: int,
             band: int) -> Tuple[np.ndarray, int]:
    """Windows of one size over the inputs that each band of ``band``
    outputs reads (output o reads first[o]..last[o]), each moved left where
    it would pass the last input."""
    n_bands = -(-first.shape[0] // band)
    lo = np.array([first[k * band:(k + 1) * band].min()
                   for k in range(n_bands)], np.int32)
    hi = np.array([last[k * band:(k + 1) * band].max()
                   for k in range(n_bands)], np.int32)
    size = int((hi - lo).max()) + 1
    return np.minimum(lo, n_in - size).astype(np.int32), size


@functools.lru_cache(maxsize=32)
def band_windows(n_in: int, n_out: int, band: int) -> Tuple[np.ndarray, int]:
    """The input rows each band of ``band`` output rows reads: where each
    band's window starts, lo (n_bands,) int32, and the rows of the largest
    window, ``size``. Every tap of every output row of band k lies in
    [lo[k], lo[k] + size), and lo[k] + size <= n_in."""
    idx, _ = _taps(n_in, n_out)
    return _windows(idx.min(1), idx.max(1), n_in, band)


@functools.lru_cache(maxsize=32)
def tile_windows(n_in: int, n_out: int, tile: int) -> Tuple[np.ndarray, int]:
    """The same for the input columns each tile of ``tile`` output columns
    reads through its neighbour-pair taps (``_pair_taps``; a single input
    column is read with a copy of itself beside it)."""
    first, _ = _pair_taps(n_in, n_out)
    return _windows(first, first + 1, max(n_in, 2), tile)


@functools.lru_cache(maxsize=16)
def _plan(h: int, w: int, H: int, W: int, M: int, device: str):
    """One shape's taps and windows on the device, in the kernel's argument
    order, and the window sizes; raises where the windows and M would not
    fit in a block's shared memory."""
    lib = _build.library("resolve")
    rlo, nwr = band_windows(h, H, lib.dmm_resolve_band_rows())
    clo, nwc = tile_windows(w, W, lib.dmm_resolve_tile_cols())
    if lib.dmm_resolve_smem_bytes(nwr, nwc, M) < 0:
        raise ValueError(f"{h}x{w} -> {H}x{W}, M={M}: a block's windows of "
                         f"{nwr} input rows by {nwc} input columns do not fit "
                         f"in shared memory")
    ri, rw = _taps(h, H)
    ci, cw = _pair_taps(w, W)
    dev = torch.device(device)
    taps = tuple(torch.from_numpy(a).to(dev) for a in (rlo, clo, ri, rw, ci, cw))
    return taps, nwr, nwc


def _bg_logit(bg_threshold: float) -> float:
    return float(math.log(bg_threshold / (1.0 - bg_threshold)))


def resolve_upsample_ops(valid_slots: int, h: int, H: int, W: int) -> int:
    """Arithmetic operations of one B2 call: the column pass (h x W outputs
    of 3 operations) and the row pass (H x W outputs of 3) of each of the
    ``valid_slots`` valid (batch element, object) slots, and the argmax's
    compare per output pixel and slot; only valid slots can change a label.
    The bound in chip_smoke.py and bench_torch.py's FLOP count use it."""
    return 3 * valid_slots * h * W + 3 * valid_slots * H * W + valid_slots * H * W


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
    taps, nwr, nwc = _plan(h, w, H, W, M, str(logits.device))
    if w == 1:                 # the kernel reads each tap with its right neighbour
        logits = torch.cat([logits, logits], dim=-1)
    valid = tmpl_valid.to(torch.uint8).contiguous()
    out = torch.empty((B, H, W), dtype=torch.uint8, device=logits.device)
    lib = _build.library("resolve")
    fn = (lib.dmm_resolve_upsample_f32 if logits.dtype == torch.float32
          else lib.dmm_resolve_upsample_bf16)
    with torch.cuda.device(logits.device):
        err = fn(logits.data_ptr(), valid.data_ptr(), *(t.data_ptr() for t in taps),
                 out.data_ptr(), B, M, h, logits.shape[-1], H, W, nwr, nwc,
                 _bg_logit(bg_threshold),
                 torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(err, "fused_resolve_upsample")
    _build.count("fused_resolve_upsample")
    return out
