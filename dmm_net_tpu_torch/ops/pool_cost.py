"""B1's function written once in plain torch: feature pooling, the cost
matrix and the unrolled log-domain Sinkhorn, in the dtype of its inputs,
keeping the pieces its gradient reads.

``kernels/matcher.py`` builds both plain versions on it: the forward
(``pool_cost_match_plain``, which casts to float32 first) reads ``X``, the
backward (``pool_cost_match_backward_plain``) sweeps back through the rest.
The values and their order of operations are those of
``ops.cost.cost_matrix`` and ``ops.matching.sinkhorn_match``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from dmm_net_tpu_torch.ops.cost import _EPS
from dmm_net_tpu_torch.ops.matching import (_NEG, _epsilon_schedule,
                                            _masked_logsumexp)


class PoolCostTrace(NamedTuple):
    """The forward's pieces. Pooling: ``area`` (B, N) and its clamp ``den``,
    ``pf`` (B, N, D). IoU: ``inter`` and ``union`` (B, M, N), ``U`` the
    clamped union. Cosine: ``rt`` (B, M, 1), ``rp`` (B, N, 1) the inverse
    norms, ``tn``, ``pn`` the normalised features. ``C`` (B, M, N) with
    ``pad_cost`` 10.0 outside ``pair``. ``steps``: each iteration's
    (eps, g before it, the row log-sum-exp lr, f, the column log-sum-exp lc,
    h = -eps * lc before the cap). The final row pass at ``epsilon``:
    ``lr``, ``f``; ``g`` the last column duals; ``L`` the logits and ``X``
    the plan."""
    area: torch.Tensor
    den: torch.Tensor
    pf: torch.Tensor
    inter: torch.Tensor
    union: torch.Tensor
    U: torch.Tensor
    rt: torch.Tensor
    rp: torch.Tensor
    tn: torch.Tensor
    pn: torch.Tensor
    pair: torch.Tensor
    C: torch.Tensor
    steps: List[Tuple]
    lr: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    L: torch.Tensor
    X: torch.Tensor


def pool_cost_sinkhorn(emb, pmp, tm, pm, tf, row_mask, col_mask,
                       epsilon: float, iters: int, iou_weight: float,
                       epsilon_init: Optional[float] = None) -> PoolCostTrace:
    """emb (B, P, D), pmp (B, N, P), tm (B, M, Pc), pm (B, N, Pc),
    tf (B, M, D) of one float dtype; row_mask (B, M), col_mask (B, N) bool.
    pf = (pmp @ emb) / max(area, 1e-6); C = lam * (1 - IoU) +
    (1 - lam) * (1 - cos) on valid pairs; X = exp(min((f + g - C) / eps, 30))
    from ``iters`` Sinkhorn steps and a final row pass."""
    rm, cm = row_mask, col_mask
    lam = iou_weight
    pair = rm[..., :, None] & cm[..., None, :]
    area = pmp.sum(-1)
    den = area.clamp_min(1e-6)
    pf = (pmp @ emb) / den[..., None]
    inter = tm @ pm.transpose(-1, -2)
    union = tm.sum(-1)[..., :, None] + pm.sum(-1)[..., None, :] - inter
    U = union.clamp_min(_EPS)
    iou = inter / U
    rt = torch.rsqrt((tf * tf).sum(-1, keepdim=True) + _EPS * _EPS)
    rp = torch.rsqrt((pf * pf).sum(-1, keepdim=True) + _EPS * _EPS)
    tn, pn = tf * rt, pf * rp
    cos = tn @ pn.transpose(-1, -2)
    C = lam * (1.0 - iou) + (1.0 - lam) * (1.0 - cos)
    C = torch.where(pair, C, torch.full_like(C, 10.0))

    neg = torch.full_like(C, _NEG)
    zero_f = torch.zeros(C.shape[:-1], dtype=C.dtype, device=C.device)
    zero_g = torch.zeros(C.shape[:-2] + C.shape[-1:], dtype=C.dtype,
                         device=C.device)
    g, steps = zero_g, []
    for eps in _epsilon_schedule(epsilon, iters, epsilon_init):
        negC = torch.where(pair, -C / eps, neg)
        lr = _masked_logsumexp(negC + g[..., None, :] / eps, pair, -1)
        f = torch.where(rm, -eps * lr, zero_f)
        lc = _masked_logsumexp(negC + f[..., :, None] / eps, pair, -2)
        h = -eps * lc
        steps.append((eps, g, lr, f, lc, h))
        g = torch.where(cm, h.clamp_max(0.0), zero_g)
    negC = torch.where(pair, -C / epsilon, neg)
    lr = _masked_logsumexp(negC + g[..., None, :] / epsilon, pair, -1)
    f = torch.where(rm, -epsilon * lr, zero_f)
    L = (f[..., :, None] + g[..., None, :] - C) / epsilon
    X = torch.where(pair, torch.exp(L.clamp_max(30.0)), torch.zeros_like(C))
    return PoolCostTrace(area, den, pf, inter, union, U, rt, rp, tn, pn, pair,
                         C, steps, lr, f, g, L, X)
