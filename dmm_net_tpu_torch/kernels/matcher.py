"""Cost matrix + Sinkhorn as CUDA kernel pairs: B1 pools the proposal
features first (one call per frame step), B3 takes them pooled.

B1 ``fused_pool_cost_match`` replaces the TPU kernel
``_fused_pool_cost_match`` (its body ``_pool_matcher_kernel``) in
dmm_net_tpu/kernels/matcher.py; B3 ``fused_cost_match`` replaces that
file's ``_pallas_forward`` (public ``fused_cost_match``). The CUDA source
is ``csrc/matcher.cu``: B1 is three launches (pooling, the cost phase
spread over pixel slices, Sinkhorn), B3 the last two. Its header says how
the work is split and what bounds it on the card (bytes: ~49 MB read by B1
at p3 B=16, ~15 us at 3.35 TB/s; the Sinkhorn's dependent iterations are a
latency floor at small batches).

B1 is differentiable (B1', the counterpart of the JAX package's
``_fpcm_fwd`` / ``_fpcm_bwd`` custom VJP): ``_PoolCostMatch`` is a
``torch.autograd.Function`` whose forward is the kernel (the plain version
on the CPU) and whose backward recomputes ``pool_cost_match_plain`` on the
saved inputs and differentiates it with autograd: the exact gradient of the
unrolled Sinkhorn with respect to the embedding, both pooling and cost
masks and the template features, none for the validity masks. The JAX
backward is the same plain-jnp recompute, with no Pallas, so this is the
faithful port rather than a fallback. ``matching.implicit_grad`` does not
reach the fused path in either package.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version (``pool_cost_match_plain``, ``cost_match_plain``) for CPU
tensors. A plain version is the same function written with the port's ops:
it serves the CPU tests and the on-card comparison.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dmm_net_tpu_torch.kernels import _build
from dmm_net_tpu_torch.ops.cost import cost_matrix
from dmm_net_tpu_torch.ops.matching import sinkhorn_match

_MAX_M = 64     # csrc/matcher.cu: 8 template rows per thread x 8 warps


def _bool(mask: torch.Tensor) -> torch.Tensor:
    return mask if mask.dtype == torch.bool else mask > 0.5


def _check_shapes(shapes, device) -> None:
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_cuda_inputs(what, shapes, M) -> None:
    for name, (t, _) in shapes.items():
        if name.endswith("_mask"):
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32, got {t.dtype}"
                             f" (contiguous={t.is_contiguous()})")
    if not 1 <= M <= _MAX_M:
        raise ValueError(f"{what}: M={M} outside [1, {_MAX_M}]")


def _scratch(lib, device, B, M, N, Pc, D, pooling: bool) -> torch.Tensor:
    """The kernels' float32 scratch (pooled features, cosine, and the cost
    phase's per-slice partial sums); its size comes from the CUDA source,
    which chooses the slices."""
    n = lib.dmm_matcher_scratch_floats(B, M, N, Pc, D, int(pooling))
    if n < 0:
        raise ValueError(f"matcher: sizes B={B} M={M} N={N} Pc={Pc} D={D} "
                         "not taken by the kernel")
    return torch.empty((n,), dtype=torch.float32, device=device)


def pool_cost_match_plain(emb, prop_masks_pool, tmpl_masks_cost,
                          prop_masks_cost, tmpl_feats, row_mask, col_mask,
                          epsilon: float = 0.05, iters: int = 30,
                          iou_weight: float = 0.3,
                          epsilon_init: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (same shapes)."""
    rm, cm = _bool(row_mask), _bool(col_mask)
    pmp = prop_masks_pool.float()
    pooled = pmp @ emb.float()
    pf = pooled / pmp.sum(-1, keepdim=True).clamp_min(1e-6)
    C = cost_matrix(tmpl_masks_cost, prop_masks_cost, tmpl_feats, pf,
                    row_mask=rm, col_mask=cm, iou_weight=iou_weight)
    return sinkhorn_match(C, rm, cm, epsilon=epsilon, iters=iters,
                          epsilon_init=epsilon_init)


def fused_pool_cost_match(emb: torch.Tensor, prop_masks_pool: torch.Tensor,
                          tmpl_masks_cost: torch.Tensor,
                          prop_masks_cost: torch.Tensor,
                          tmpl_feats: torch.Tensor,
                          row_mask: torch.Tensor, col_mask: torch.Tensor,
                          epsilon: float = 0.05, iters: int = 30,
                          iou_weight: float = 0.3,
                          epsilon_init: Optional[float] = None) -> torch.Tensor:
    """Feature pooling + cost + Sinkhorn.

    emb (B, P, D) flattened embedding map; prop_masks_pool (B, N, P)
    proposal masks at the embedding grid; tmpl_masks_cost (B, M, Pc) and
    prop_masks_cost (B, N, Pc) masks at the cost-IoU grid; tmpl_feats
    (B, M, D); row_mask (B, M), col_mask (B, N) validity. Float inputs must
    be float32 and contiguous. Returns X (B, M, N) float32 with padded rows
    and columns exactly 0.
    """
    B, P, D = emb.shape
    M, Pc = tmpl_masks_cost.shape[1:]
    N = prop_masks_pool.shape[1]
    shapes = {"emb": (emb, (B, P, D)),
              "prop_masks_pool": (prop_masks_pool, (B, N, P)),
              "tmpl_masks_cost": (tmpl_masks_cost, (B, M, Pc)),
              "prop_masks_cost": (prop_masks_cost, (B, N, Pc)),
              "tmpl_feats": (tmpl_feats, (B, M, D)),
              "row_mask": (row_mask, (B, M)), "col_mask": (col_mask, (B, N))}
    _check_shapes(shapes, emb.device)
    if emb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_pool_cost_match: unsupported device {emb.device}")
    if emb.device.type == "cuda":
        _check_cuda_inputs("fused_pool_cost_match", shapes, M)
    return _PoolCostMatch.apply(
        emb, prop_masks_pool, tmpl_masks_cost, prop_masks_cost, tmpl_feats,
        row_mask, col_mask, float(epsilon), int(iters), float(iou_weight),
        epsilon_init)


def _launch_pool_cost_match(emb, prop_masks_pool, tmpl_masks_cost,
                            prop_masks_cost, tmpl_feats, row_mask, col_mask,
                            epsilon, iters, iou_weight, epsilon_init):
    """One B1 launch on checked CUDA inputs."""
    B, P, D = emb.shape
    M, Pc = tmpl_masks_cost.shape[1:]
    N = prop_masks_pool.shape[1]
    rm = row_mask.to(torch.float32).contiguous()
    cm = col_mask.to(torch.float32).contiguous()
    lib = _build.library("matcher")
    scratch = _scratch(lib, emb.device, B, M, N, Pc, D, pooling=True)
    X = torch.empty((B, M, N), dtype=torch.float32, device=emb.device)
    anneal = epsilon_init is not None and epsilon_init > epsilon
    log_decay = 0.0
    if anneal:
        steps = max(int(iters * 0.7), 1)
        log_decay = math.log((epsilon / epsilon_init) ** (1.0 / steps))
    with torch.cuda.device(emb.device):
        err = lib.dmm_fused_pool_cost_match(
            emb.data_ptr(), prop_masks_pool.data_ptr(),
            tmpl_masks_cost.data_ptr(), prop_masks_cost.data_ptr(),
            tmpl_feats.data_ptr(), rm.data_ptr(), cm.data_ptr(),
            scratch.data_ptr(), X.data_ptr(), B, M, N, P, Pc, D, float(epsilon),
            int(iters), float(iou_weight), int(anneal),
            float(epsilon_init or 0.0), float(log_decay),
            torch.cuda.current_stream(emb.device).cuda_stream)
    _build.check(err, "fused_pool_cost_match")
    _build.count("fused_pool_cost_match")
    return X


class _PoolCostMatch(torch.autograd.Function):
    """B1 with B1' as its backward. Forward: the CUDA kernel (the plain
    version for CPU tensors); it saves the five float inputs and the two
    validity masks. Backward: ``pool_cost_match_plain`` recomputed on
    detached copies under ``enable_grad`` and differentiated by
    ``torch.autograd.grad``; on CUDA each backward counts one call in
    ``_build.backward_calls()`` (it launches no kernel of its own)."""

    @staticmethod
    def forward(ctx, emb, prop_masks_pool, tmpl_masks_cost, prop_masks_cost,
                tmpl_feats, row_mask, col_mask, epsilon, iters, iou_weight,
                epsilon_init):
        args = (emb, prop_masks_pool, tmpl_masks_cost, prop_masks_cost,
                tmpl_feats, row_mask, col_mask)
        ctx.save_for_backward(*args)
        ctx.opts = dict(epsilon=epsilon, iters=iters, iou_weight=iou_weight,
                        epsilon_init=epsilon_init)
        if emb.device.type == "cpu":
            return pool_cost_match_plain(*args, **ctx.opts)
        return _launch_pool_cost_match(*args, **ctx.opts)

    @staticmethod
    def backward(ctx, gX):
        *floats, row_mask, col_mask = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in floats]
            X = pool_cost_match_plain(*xs, row_mask, col_mask, **ctx.opts)
            grads = torch.autograd.grad(X, xs, gX)
        if gX.device.type == "cuda":
            _build.count_backward("fused_pool_cost_match")
        return (*grads, None, None, None, None, None, None)


def cost_match_plain(tmpl_masks, prop_masks, tmpl_feats, prop_feats,
                     row_mask, col_mask, epsilon: float = 0.05,
                     iters: int = 30, iou_weight: float = 0.3) -> torch.Tensor:
    """Plain PyTorch version of B3 (same shapes)."""
    rm, cm = _bool(row_mask), _bool(col_mask)
    C = cost_matrix(tmpl_masks, prop_masks, tmpl_feats, prop_feats,
                    row_mask=rm, col_mask=cm, iou_weight=iou_weight)
    return sinkhorn_match(C, rm, cm, epsilon=epsilon, iters=iters)


def fused_cost_match(tmpl_masks: torch.Tensor, prop_masks: torch.Tensor,
                     tmpl_feats: torch.Tensor, prop_feats: torch.Tensor,
                     row_mask: torch.Tensor, col_mask: torch.Tensor,
                     epsilon: float = 0.05, iters: int = 30,
                     iou_weight: float = 0.3) -> torch.Tensor:
    """Cost + Sinkhorn from pooled features (B3).

    tmpl_masks (B, M, P), prop_masks (B, N, P) soft masks; tmpl_feats
    (B, M, D), prop_feats (B, N, D) pooled features; row_mask (B, M),
    col_mask (B, N) validity. Natural sizes, no padding. Float inputs must
    be float32 and contiguous. Returns X (B, M, N) float32 with padded rows
    and columns exactly 0.
    """
    B, M, P = tmpl_masks.shape
    N = prop_masks.shape[1]
    D = tmpl_feats.shape[2]
    shapes = {"tmpl_masks": (tmpl_masks, (B, M, P)),
              "prop_masks": (prop_masks, (B, N, P)),
              "tmpl_feats": (tmpl_feats, (B, M, D)),
              "prop_feats": (prop_feats, (B, N, D)),
              "row_mask": (row_mask, (B, M)), "col_mask": (col_mask, (B, N))}
    _check_shapes(shapes, tmpl_masks.device)
    if tmpl_masks.device.type == "cpu":
        return cost_match_plain(tmpl_masks, prop_masks, tmpl_feats, prop_feats,
                                row_mask, col_mask, epsilon=epsilon,
                                iters=iters, iou_weight=iou_weight)
    if tmpl_masks.device.type != "cuda":
        raise ValueError(f"fused_cost_match: unsupported device {tmpl_masks.device}")
    _check_cuda_inputs("fused_cost_match", shapes, M)
    dev = tmpl_masks.device
    rm = row_mask.to(torch.float32).contiguous()
    cm = col_mask.to(torch.float32).contiguous()
    lib = _build.library("matcher")
    scratch = _scratch(lib, dev, B, M, N, P, D, pooling=False)
    X = torch.empty((B, M, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dmm_fused_cost_match(
            tmpl_masks.data_ptr(), prop_masks.data_ptr(), tmpl_feats.data_ptr(),
            prop_feats.data_ptr(), rm.data_ptr(), cm.data_ptr(), scratch.data_ptr(),
            X.data_ptr(), B, M, N, P, D, float(epsilon), int(iters),
            float(iou_weight), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_cost_match")
    _build.count("fused_cost_match")
    return X
