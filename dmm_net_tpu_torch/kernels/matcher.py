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
``torch.autograd.Function`` whose forward is the kernel and whose backward
is the exact gradient of the unrolled Sinkhorn with respect to the
embedding, both pooling and cost masks and the template features, none for
the validity masks. On CUDA the backward is two kernels of its own in the
same source, on the forward's scratch and what the forward kept for it (the
Sinkhorn's duals, C, the intersections and mask areas):
``matcher_sweep_kernel``, the reverse sweep, sized to each element's pairs
(``sweep_geometry`` reads its launch), and ``matcher_tail_kernel``, the cost's tail across
the card; then four products for the mask and pooling inputs, which stay
``torch.baddbmm`` / ``torch.bmm`` as the JAX backward leaves them to XLA;
products for inputs that need no gradient are skipped. On the CPU it is
``pool_cost_match_backward_plain``, the same forward-then-reverse sweep
written step by step in torch. The JAX backward differentiates its plain
jnp recompute, with no Pallas. ``matching.implicit_grad`` does not reach
the fused path in either package.

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
from dmm_net_tpu_torch.ops.cost import _EPS, cost_matrix
from dmm_net_tpu_torch.ops.matching import _NEG, sinkhorn_match
from dmm_net_tpu_torch.ops.pool_cost import pool_cost_sinkhorn

_MAX_M = 64     # csrc/matcher.cu: 8 template rows per thread x 8 warps
_MAX_N = 1024   # csrc/matcher.cu: 32 columns per lane in the Sinkhorn's row pass


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
    N = shapes["col_mask"][1][1]
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"{what}: N={N} outside [1, {_MAX_N}]")


def sweep_geometry(M: int, N: int):
    """B1''s reverse sweep for one batch element of M x N pairs, as
    csrc/matcher.cu chooses it (its ``sweep_geometry``; needs the built
    library): (warps a block, blocks a cluster)."""
    g = _build.library("matcher").dmm_matcher_sweep_geometry(M, N)
    if g < 0:
        raise ValueError(f"sweep_geometry: M={M}, N={N} outside the kernel's limits")
    return g // 256, g % 256


def _scratch(lib, device, B, M, N, Pc, D, pooling: bool) -> torch.Tensor:
    """The kernels' float32 scratch (pooled features, cosine, and the cost
    phase's per-slice partial sums); its size comes from the CUDA source,
    which chooses the slices."""
    n = lib.dmm_matcher_scratch_floats(B, M, N, Pc, D, int(pooling))
    if n < 0:
        raise ValueError(f"matcher: sizes B={B} M={M} N={N} Pc={Pc} D={D} "
                         "not taken by the kernel")
    return torch.empty((n,), dtype=torch.float32, device=device)


def pool_cost_match_ops(B: int, M: int, N: int, P: int, D: int, Pc: int,
                        iters: int, pairs: int) -> int:
    """Arithmetic operations of one B1 call: pooling (a product and the
    mask areas), the mask intersections and areas on the cost grid, the
    cosine term and the norms, and each Sinkhorn iteration's row and column
    log-sum-exps over the ``pairs`` valid (template, proposal) entries.
    The bound in chip_smoke.py and bench_torch.py's FLOP count use it."""
    return (2 * B * N * P * D + B * N * P            # pooling + mask areas
            + 2 * B * M * N * Pc + B * (M + N) * Pc  # intersections + areas
            + 2 * B * M * N * D + 2 * B * (M + N) * D  # cosine + norms
            + 10 * (iters + 1) * pairs)              # Sinkhorn row/col LSEs


def pool_cost_match_plain(emb, prop_masks_pool, tmpl_masks_cost,
                          prop_masks_cost, tmpl_feats, row_mask, col_mask,
                          epsilon: float = 0.05, iters: int = 30,
                          iou_weight: float = 0.3,
                          epsilon_init: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (same shapes), in float32."""
    floats = (emb, prop_masks_pool, tmpl_masks_cost, prop_masks_cost, tmpl_feats)
    return pool_cost_sinkhorn(*(t.float() for t in floats), _bool(row_mask),
                              _bool(col_mask), epsilon, iters, iou_weight,
                              epsilon_init).X


def pool_cost_match_backward_plain(emb, prop_masks_pool, tmpl_masks_cost,
                                   prop_masks_cost, tmpl_feats, row_mask,
                                   col_mask, gX, epsilon: float = 0.05,
                                   iters: int = 30, iou_weight: float = 0.3,
                                   epsilon_init: Optional[float] = None,
                                   needs=(True,) * 5):
    """Plain PyTorch version of B1': the gradients of
    ``pool_cost_match_plain``'s X with respect to (emb, prop_masks_pool,
    tmpl_masks_cost, prop_masks_cost, tmpl_feats) for an upstream gradient
    gX (B, M, N), None where ``needs`` says no; float32, or float64 for
    float64 inputs. The forward again (``ops.pool_cost.pool_cost_sinkhorn``,
    which keeps each Sinkhorn step's duals and log-sum-exps), then the
    reverse sweep: every dual enters as f + g - C, so each step adds to dC
    what it takes from df or dg, with the row pass's weights
    P = exp(z - lse) and the column pass's Q; then the cost's tail (IoU and
    cosine) and the pooling. Rounding points as autograd through the plain
    version: padded pairs, the clip at 30, a capped column, and the clamps
    of the union and the pooling denominator at 1e-6 pass no gradient; a
    NaN travels on."""
    rm, cm = _bool(row_mask), _bool(col_mask)
    ins = (emb, prop_masks_pool, tmpl_masks_cost, prop_masks_cost, tmpl_feats)
    dt = torch.float64 if emb.dtype == torch.float64 else torch.float32
    emb, pmp, tm, pm, tf = (t.to(dt) for t in ins)
    gX = gX.to(dt)
    lam = iou_weight
    tr = pool_cost_sinkhorn(emb, pmp, tm, pm, tf, rm, cm, epsilon, iters,
                            iou_weight, epsilon_init)
    pair, C, g, lr = tr.pair, tr.C, tr.g, tr.lr
    neg, zero = torch.full_like(C, _NEG), torch.zeros_like(C)
    zero_f, zero_g = torch.zeros_like(tr.f), torch.zeros_like(g)

    # X = exp(min(L, 30)) with L = (f + g - C) / epsilon: dL = gX * X below
    # the clip; C takes -dL / epsilon, f and g +dL / epsilon
    inc = torch.where(pair & (tr.L <= 30.0), -(gX * tr.X) / epsilon, zero)
    dC = inc
    df = torch.where(rm, -inc.sum(-1), zero_f)
    negC = torch.where(pair, -C / epsilon, neg)
    P = torch.exp(negC + g[..., None, :] / epsilon - lr[..., :, None])
    inc2 = torch.where(pair, df[..., :, None] * P, zero)
    dC = dC + inc2
    dg = -(inc + inc2).sum(-2)
    for eps, g_in, lr, f, lc, h in reversed(tr.steps):
        negC = torch.where(pair, -C / eps, neg)
        dh = torch.where(cm & (h <= 0.0), dg, zero_g)          # the cap at 0
        Q = torch.exp(negC + f[..., :, None] / eps - lc[..., None, :])
        inc = torch.where(pair, dh[..., None, :] * Q, zero)
        dC = dC + inc
        df = torch.where(rm, -inc.sum(-1), zero_f)
        P = torch.exp(negC + g_in[..., None, :] / eps - lr[..., :, None])
        inc = torch.where(pair, df[..., :, None] * P, zero)
        dC = dC + inc
        dg = -inc.sum(-2)

    # the cost's tail: iou = inter / max(union, 1e-6), the cosine through
    # rsqrt(|t|^2 + 1e-12), pf = pooled / max(area, 1e-6)
    d_iou = -(lam * dC)
    inter, union, U = tr.inter, tr.union, tr.U
    area, den, pf, rt, rp, tn, pn = tr.area, tr.den, tr.pf, tr.rt, tr.rp, tr.tn, tr.pn
    du = torch.where(union >= _EPS, -d_iou * ((inter / U) / U), zero)
    coef = d_iou / U - du
    dcos = -((1.0 - lam) * dC)
    grads = [None] * 5
    if needs[2]:
        grads[2] = coef @ pm + du.sum(-1)[..., None]
    if needs[3]:
        grads[3] = coef.transpose(-1, -2) @ tm + du.sum(-2)[..., None]
    if needs[4]:
        d_tn = dcos @ pn
        grads[4] = rt * d_tn - rt ** 3 * (d_tn * tf).sum(-1, keepdim=True) * tf
    if needs[0] or needs[1]:
        d_pn = dcos.transpose(-1, -2) @ tn
        d_pf = rp * d_pn - rp ** 3 * (d_pn * pf).sum(-1, keepdim=True) * pf
        d_pooled = d_pf / den[..., None]
        if needs[0]:
            grads[0] = pmp.transpose(-1, -2) @ d_pooled
        if needs[1]:
            d_area = torch.where(area >= 1e-6, -(d_pf * pf).sum(-1) / den,
                                 torch.zeros_like(area))
            grads[1] = d_pooled @ emb.transpose(-1, -2) + d_area[..., None]
    return tuple(None if d is None else d.to(x.dtype) for d, x in zip(grads, ins))


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


def _anneal(epsilon, iters, epsilon_init):
    """The kernels' annealed schedule, max(eps0 * exp(k * log_decay), eps):
    (anneal, log_decay)."""
    if epsilon_init is None or epsilon_init <= epsilon:
        return False, 0.0
    steps = max(int(iters * 0.7), 1)
    return True, math.log((epsilon / epsilon_init) ** (1.0 / steps))


def _launch_pool_cost_match(emb, prop_masks_pool, tmpl_masks_cost,
                            prop_masks_cost, tmpl_feats, row_mask, col_mask,
                            epsilon, iters, iou_weight, epsilon_init,
                            keep: bool = False):
    """One B1 launch on checked CUDA inputs; returns X, and with ``keep``
    what B1' reads: the scratch (pooled features, cosine and its inverse
    norms, partial sums, mask areas) and the kept buffer (the Sinkhorn's
    duals, C, the intersections and mask areas), else None."""
    B, P, D = emb.shape
    M, Pc = tmpl_masks_cost.shape[1:]
    N = prop_masks_pool.shape[1]
    rm = row_mask.to(torch.float32).contiguous()
    cm = col_mask.to(torch.float32).contiguous()
    lib = _build.library("matcher")
    scratch = _scratch(lib, emb.device, B, M, N, Pc, D, pooling=True)
    X = torch.empty((B, M, N), dtype=torch.float32, device=emb.device)
    hist = (torch.empty((lib.dmm_matcher_kept_floats(B, M, N, iters),),
                        dtype=torch.float32, device=emb.device) if keep else None)
    anneal, log_decay = _anneal(epsilon, iters, epsilon_init)
    with torch.cuda.device(emb.device):
        err = lib.dmm_fused_pool_cost_match(
            emb.data_ptr(), prop_masks_pool.data_ptr(),
            tmpl_masks_cost.data_ptr(), prop_masks_cost.data_ptr(),
            tmpl_feats.data_ptr(), rm.data_ptr(), cm.data_ptr(),
            scratch.data_ptr(), X.data_ptr(),
            None if hist is None else hist.data_ptr(), B, M, N, P, Pc, D, float(epsilon),
            int(iters), float(iou_weight), int(anneal),
            float(epsilon_init or 0.0), float(log_decay),
            torch.cuda.current_stream(emb.device).cuda_stream)
    _build.check(err, "fused_pool_cost_match")
    _build.count("fused_pool_cost_match")
    return X, ((scratch, hist) if keep else None)


def _launch_pool_cost_match_backward(saved, kept, gX, epsilon, iters,
                                     iou_weight, epsilon_init, needs):
    """B1''s two launches (the sweep, the tail) on the
    forward's inputs, scratch and kept buffer, then the products for the
    inputs in ``needs``: d_emb = pmp^T @ d_pooled, d_pmp = d_pooled @ emb^T
    + d_area, d_tm = coef @ pm + urow, d_pm = coef^T @ tm + ucol (torch.bmm
    / baddbmm); d_tf from the kernel."""
    emb, pmp, tm, pm, tf, row_mask, col_mask = saved
    B, P, D = emb.shape
    M, Pc = tm.shape[1:]
    N = pmp.shape[1]
    dev = emb.device
    if gX.device != dev or gX.dtype != torch.float32 or tuple(gX.shape) != (B, M, N):
        raise ValueError(f"fused_pool_cost_match backward: gX {tuple(gX.shape)} "
                         f"{gX.dtype} on {gX.device}, expected ({B}, {M}, {N}) "
                         f"float32 on {dev}")
    gX = gX.contiguous()
    rm = row_mask.to(torch.float32).contiguous()
    cm = col_mask.to(torch.float32).contiguous()

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    scratch, hist = kept
    dC = f32(B, M, N)
    coef, urow, ucol = f32(B, M, N), f32(B, M), f32(B, N)
    d_tf, d_pooled, d_area = f32(B, M, D), f32(B, N, D), f32(B, N)
    anneal, log_decay = _anneal(epsilon, iters, epsilon_init)
    lib = _build.library("matcher")
    with torch.cuda.device(dev):
        err = lib.dmm_fused_pool_cost_match_backward(
            tf.data_ptr(), rm.data_ptr(), cm.data_ptr(), gX.data_ptr(),
            scratch.data_ptr(), hist.data_ptr(), dC.data_ptr(), coef.data_ptr(),
            urow.data_ptr(), ucol.data_ptr(), d_tf.data_ptr(), d_pooled.data_ptr(),
            d_area.data_ptr(), B, M, N, Pc, D, float(epsilon), int(iters),
            float(iou_weight), int(anneal), float(epsilon_init or 0.0),
            float(log_decay), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_pool_cost_match_backward")
    _build.count("fused_pool_cost_match_backward")
    grads = [None] * 5
    if needs[0]:
        grads[0] = torch.bmm(pmp.transpose(1, 2), d_pooled)
    if needs[1]:
        grads[1] = torch.baddbmm(d_area[..., None], d_pooled, emb.transpose(1, 2))
    if needs[2]:
        grads[2] = torch.baddbmm(urow[..., None], coef, pm)
    if needs[3]:
        grads[3] = torch.baddbmm(ucol[..., None], coef.transpose(1, 2), tm)
    if needs[4]:
        grads[4] = d_tf
    return tuple(grads)


class _PoolCostMatch(torch.autograd.Function):
    """B1 with B1' as its backward. Forward: the CUDA kernel (the plain
    version for CPU tensors); it saves the five float inputs and the two
    validity masks, and on CUDA, when an input needs a gradient, the
    kernel's scratch and kept buffer. Backward: B1''s kernels for CUDA
    tensors (the sweep and the tail, counted once as a
    ``fused_pool_cost_match_backward`` launch, then the products), the
    plain version ``pool_cost_match_backward_plain`` for CPU tensors; on
    CUDA each backward also counts one call in
    ``_build.backward_calls()``."""

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
        X, ctx.kept = _launch_pool_cost_match(
            *args, **ctx.opts, keep=any(ctx.needs_input_grad[:5]))
        return X

    @staticmethod
    def backward(ctx, gX):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        if gX.device.type == "cpu":
            grads = pool_cost_match_backward_plain(*saved, gX, **ctx.opts,
                                                   needs=needs)
        else:
            grads = _launch_pool_cost_match_backward(saved, ctx.kept, gX,
                                                     **ctx.opts, needs=needs)
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
