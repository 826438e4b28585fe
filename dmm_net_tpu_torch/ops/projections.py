"""Euclidean projections onto the relaxed assignment polytope's factor sets,
for the PGD solver (ops/matching.pgd_match):

  * rows: the probability simplex {x >= 0, sum x = 1} (sort + threshold);
  * cols: the capped set {x >= 0, sum x <= 1} (clip at zero; if the sum
    still exceeds 1, the simplex projection).

Counterpart of the JAX package's ops/projections.py: mask-aware for padded
shapes, vectorised over leading axes, no data-dependent control flow. The
JAX package's ``lax.scan`` over Dykstra iterations is a Python loop here.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_NEG = -1e30  # effective -inf that survives arithmetic in float32


def _full_mask(v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones(v.shape, dtype=torch.bool, device=v.device)
    return mask.expand(v.shape)


def project_simplex(v: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    radius: Union[float, torch.Tensor] = 1.0) -> torch.Tensor:
    """Projection of the last axis of ``v`` onto {x >= 0, sum x = radius},
    restricted to ``mask``-valid entries; invalid entries get exactly 0.
    tau = (cumsum - radius) / k at the largest k with
    v_(k) - (cumsum_k - radius) / k > 0, then x = max(v - tau, 0)."""
    n = v.shape[-1]
    mask = _full_mask(v, mask)
    vm = torch.where(mask, v, torch.full_like(v, _NEG))
    u = torch.sort(vm, dim=-1, descending=True).values
    k = torch.arange(1, n + 1, dtype=v.dtype, device=v.device)
    css = torch.cumsum(u, dim=-1)
    # masked entries sort last with u = _NEG, so the condition is a prefix
    rho = ((u * k) > (css - radius)).sum(-1, keepdim=True).clamp_min(1)
    tau = (torch.gather(css, -1, rho - 1) - radius) / rho.to(v.dtype)
    x = (v - tau).clamp_min(0.0)
    return torch.where(mask, x, torch.zeros_like(x))


def project_capped_simplex(v: torch.Tensor, mask: Optional[torch.Tensor] = None,
                           cap: float = 1.0) -> torch.Tensor:
    """Projection onto {x >= 0, sum x <= cap} along the last axis."""
    mask = _full_mask(v, mask)
    clipped = torch.where(mask, v.clamp_min(0.0), torch.zeros_like(v))
    s = clipped.sum(-1, keepdim=True)
    on_face = project_simplex(v, mask=mask, radius=cap)
    return torch.where(s <= cap, clipped, on_face)


def project_rows_simplex(X: torch.Tensor, row_mask: torch.Tensor,
                         col_mask: torch.Tensor) -> torch.Tensor:
    """Each valid row of X (..., M, N) onto the simplex over valid columns;
    padded rows and columns are zeroed."""
    m = row_mask[..., :, None] & col_mask[..., None, :]
    out = project_simplex(X, mask=m)
    return torch.where(row_mask[..., :, None], out, torch.zeros_like(out))


def project_cols_capped(X: torch.Tensor, row_mask: torch.Tensor,
                        col_mask: torch.Tensor, cap: float = 1.0) -> torch.Tensor:
    """Each valid column of X (..., M, N) onto {x >= 0, sum <= cap}."""
    m = col_mask[..., :, None] & row_mask[..., None, :]
    out = project_capped_simplex(X.transpose(-1, -2), mask=m, cap=cap)
    return out.transpose(-1, -2)


def dykstra_project(X: torch.Tensor, row_mask: torch.Tensor,
                    col_mask: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Dykstra's alternating projection onto {rows on the simplex} ∩ {columns
    capped at 1}: converges to the Euclidean projection onto the
    intersection, which PGD needs."""
    x, p, q = X, torch.zeros_like(X), torch.zeros_like(X)
    for _ in range(iters):
        y = project_rows_simplex(x + p, row_mask, col_mask)
        p = x + p - y
        x2 = project_cols_capped(y + q, row_mask, col_mask)
        q = y + q - x2
        x = x2
    return x
