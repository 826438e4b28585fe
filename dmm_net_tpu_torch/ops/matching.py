"""Differentiable bipartite matching on the relaxed assignment polytope:

    min <C, X>   over  {X >= 0;  sum_j X[i,j] = 1  (valid rows);
                               sum_i X[i,j] <= 1 (valid cols)}

``sinkhorn_match`` solves the entropic relaxation with log-domain dual
updates; the column inequality is handled by clamping the column dual at 0.
``pgd_match`` is projected gradient descent with Dykstra projections (the
paper's formulation). The JAX package's ``lax.scan`` over iterations is a
Python loop here. ``hard_assignment_hungarian`` is the one-to-one hard
decode on the host (scipy).

Shapes: C (..., M, N); row_mask (..., M) bool; col_mask (..., N) bool.
Returns X (..., M, N) with padded rows/cols exactly 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dmm_net_tpu_torch.ops.projections import (dykstra_project,
                                               project_rows_simplex)

_NEG = -1e30


def _masked_logsumexp(x: torch.Tensor, mask: torch.Tensor,
                      dim: int) -> torch.Tensor:
    """logsumexp over ``dim`` counting only mask-valid entries; returns a
    large negative value where no entry is valid (callers guard)."""
    xm = torch.where(mask, x, torch.full_like(x, _NEG))
    mx = xm.amax(dim=dim, keepdim=True).clamp_min(_NEG / 2)
    s = torch.where(mask, torch.exp(xm - mx), torch.zeros_like(x)).sum(
        dim=dim, keepdim=True)
    return (mx + torch.log(s.clamp_min(1e-38))).squeeze(dim)


def _epsilon_schedule(epsilon: float, iters: int,
                      epsilon_init: Optional[float] = None) -> list:
    """Per-iteration temperatures. With ``epsilon_init > epsilon`` the
    schedule decays geometrically to ``epsilon`` by ~70% of the budget and
    then holds."""
    if epsilon_init is None or epsilon_init <= epsilon:
        return [epsilon] * iters
    anneal_steps = max(int(iters * 0.7), 1)
    decay = (epsilon / epsilon_init) ** (1.0 / anneal_steps)
    sched = torch.maximum(
        epsilon_init * torch.full((iters,), decay, dtype=torch.float32)
        ** torch.arange(iters, dtype=torch.float32),
        torch.tensor(epsilon, dtype=torch.float32))
    return sched.tolist()


def sinkhorn_duals(C: torch.Tensor, row_mask: torch.Tensor,
                   col_mask: torch.Tensor, epsilon: float, iters: int,
                   epsilon_init: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-domain Sinkhorn; returns the duals (f (..., M), g (..., N) <= 0).
    Rows sum to exactly 1 after the final row update at ``epsilon``."""
    pair = row_mask[..., :, None] & col_mask[..., None, :]
    neg = torch.full_like(C, _NEG)
    g = torch.zeros(C.shape[:-2] + C.shape[-1:], dtype=C.dtype,
                    device=C.device)
    zero_f = torch.zeros(C.shape[:-1], dtype=C.dtype, device=C.device)
    for eps in _epsilon_schedule(epsilon, iters, epsilon_init):
        negC = torch.where(pair, -C / eps, neg)
        f = -eps * _masked_logsumexp(negC + g[..., None, :] / eps, pair, -1)
        f = torch.where(row_mask, f, zero_f)
        g_bal = -eps * _masked_logsumexp(negC + f[..., :, None] / eps, pair, -2)
        g = torch.where(col_mask, g_bal.clamp_max(0.0), torch.zeros_like(g))
    negC = torch.where(pair, -C / epsilon, neg)
    f = -epsilon * _masked_logsumexp(negC + g[..., None, :] / epsilon, pair, -1)
    f = torch.where(row_mask, f, zero_f)
    return f, g


def _primal_from_duals(C, f, g, row_mask, col_mask, epsilon):
    pair = row_mask[..., :, None] & col_mask[..., None, :]
    logits = (f[..., :, None] + g[..., None, :] - C) / epsilon
    return torch.where(pair, torch.exp(logits.clamp_max(30.0)),
                       torch.zeros_like(C))


def sinkhorn_match(C: torch.Tensor, row_mask: torch.Tensor,
                   col_mask: torch.Tensor, epsilon: float = 0.05,
                   iters: int = 30, implicit_grad: bool = False,
                   epsilon_init: Optional[float] = None) -> torch.Tensor:
    """Entropic relaxed matching. ``implicit_grad`` detaches the duals so
    gradients flow only through the final primal recovery."""
    if implicit_grad:
        f, g = sinkhorn_duals(C.detach(), row_mask, col_mask, epsilon, iters,
                              epsilon_init=epsilon_init)
        f, g = f.detach(), g.detach()
    else:
        f, g = sinkhorn_duals(C, row_mask, col_mask, epsilon, iters,
                              epsilon_init=epsilon_init)
    return _primal_from_duals(C, f, g, row_mask, col_mask, epsilon)


def pgd_match(C: torch.Tensor, row_mask: torch.Tensor, col_mask: torch.Tensor,
              step: float = 0.1, pgd_iters: int = 20,
              dykstra_iters: int = 10) -> torch.Tensor:
    """Projected gradient descent on <C, X>: the objective is linear, so each
    step is X <- Pi(X - step * C), from the uniform feasible point
    X0[i, j] = 1 / n_valid_cols, then one final row projection so the row
    constraints hold exactly."""
    n_valid = col_mask.sum(-1, keepdim=True).clamp_min(1)        # (..., 1)
    pair = row_mask[..., :, None] & col_mask[..., None, :]
    X = torch.where(pair, 1.0 / n_valid[..., None, :].to(C.dtype),
                    torch.zeros_like(C))
    for _ in range(pgd_iters):
        X = dykstra_project(X - step * C, row_mask, col_mask,
                            iters=dykstra_iters)
    return project_rows_simplex(X, row_mask, col_mask)


def match(C: torch.Tensor, row_mask: Optional[torch.Tensor] = None,
          col_mask: Optional[torch.Tensor] = None, solver: str = "sinkhorn",
          epsilon: float = 0.05, iters: int = 30, implicit_grad: bool = False,
          step: float = 0.1, pgd_iters: int = 20, dykstra_iters: int = 10,
          epsilon_init: Optional[float] = None) -> torch.Tensor:
    """Unified matching entry point; masks default to all-valid."""
    if row_mask is None:
        row_mask = torch.ones(C.shape[:-1], dtype=torch.bool, device=C.device)
    if col_mask is None:
        col_mask = torch.ones(C.shape[:-2] + C.shape[-1:], dtype=torch.bool,
                              device=C.device)
    if solver == "sinkhorn":
        return sinkhorn_match(C, row_mask, col_mask, epsilon=epsilon,
                              iters=iters, implicit_grad=implicit_grad,
                              epsilon_init=epsilon_init)
    if solver == "pgd":
        return pgd_match(C, row_mask, col_mask, step=step,
                         pgd_iters=pgd_iters, dykstra_iters=dykstra_iters)
    raise ValueError(f"unknown solver {solver!r}")


def hard_assignment(X: torch.Tensor, row_mask: torch.Tensor,
                    col_mask: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax: int32 (..., M) proposal index per template, -1 for
    padded rows."""
    Xm = torch.where(col_mask[..., None, :], X, torch.full_like(X, -1.0))
    idx = Xm.argmax(dim=-1).to(torch.int32)
    return torch.where(row_mask, idx, torch.full_like(idx, -1))


def hard_assignment_hungarian(X, row_mask, col_mask) -> np.ndarray:
    """One-to-one hard decode on the host: maximise the total soft mass with
    each proposal used at most once (scipy's Hungarian solver). X (M, N) or
    (B, M, N) numpy; returns int32 indices shaped like row_mask, -1 for
    padded rows."""
    from scipy.optimize import linear_sum_assignment

    X, row_mask, col_mask = map(np.asarray, (X, row_mask, col_mask))
    squeeze = X.ndim == 2
    if squeeze:
        X, row_mask, col_mask = X[None], row_mask[None], col_mask[None]
    out = np.full(row_mask.shape, -1, np.int32)
    for b in range(X.shape[0]):
        rows = np.nonzero(row_mask[b])[0]
        cols = np.nonzero(col_mask[b])[0]
        if rows.size == 0 or cols.size == 0:
            continue
        ri, ci = linear_sum_assignment(-X[b][np.ix_(rows, cols)])
        out[b, rows[ri]] = cols[ci]
    return out[0] if squeeze else out
