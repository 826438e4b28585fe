"""optax's ``adamw`` as a torch optimizer, in optax's float32 order of
operations.

``torch.optim.AdamW`` computes the same update in another order: it first
scales each parameter by ``1 - lr * weight_decay`` in a rounding of its
own, then adds the Adam step. In float32 that factor rounds to 1 whenever
``lr * weight_decay`` is below half an ulp of 1 (~6e-8), as it is at every
learning rate the trainers use (3e-4 x 1e-5), so the decay is dropped
altogether; optax adds ``weight_decay * p`` to the Adam step before the
learning rate scales it, where it survives. Its moments differ in rounding
too (``lerp`` against optax's ``(1 - b) * g + b * m``). Each of these is a
rounding-level difference per step, but one that the teacher-forced
horizon tests see in parameters whose Adam step is small
(``tests/test_torch_port_train_horizon.py``).

Per parameter, with g its gradient and t its step count after this update:

    m = (1 - b1) * g + b1 * m
    v = (1 - b2) * g * g + b2 * v
    u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + weight_decay * p
    p = p + u * (-lr)

each operation rounded to float32 as XLA rounds it (the scalars and
``b^t`` taken in float32). The state keeps ``torch.optim.AdamW``'s names
(``step``, ``exp_avg``, ``exp_avg_sq``) and its param-group keys, so
checkpoints of either load into the other and a ``LambdaLR`` drives
``lr``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


def _f32(x: float) -> float:
    """A Python float rounded to float32, as XLA takes a weak scalar."""
    return float(np.float32(x))


class AdamW(torch.optim.Optimizer):
    """optax.adamw(lr, b1, b2, eps, weight_decay) over ``params``; ``lr``
    is read from the param group at each step (a scheduler may set it)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
            grads = [p.grad for p in params]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            counts = [np.float32(st["step"].item()) for st in states]
            bc1 = [float(np.float32(1) - np.float32(b1) ** t) for t in counts]
            bc2 = [float(np.float32(1) - np.float32(b2) ** t) for t in counts]

            torch._foreach_mul_(mus, _f32(b1))
            torch._foreach_add_(mus, torch._foreach_mul(grads, _f32(1 - b1)))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, _f32(1 - b2))
            torch._foreach_mul_(nus, _f32(b2))
            torch._foreach_add_(nus, sq)

            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, _f32(group["eps"]))
            upd = torch._foreach_div(mus, bc1)
            torch._foreach_div_(upd, den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(
                    params, _f32(group["weight_decay"])))
            torch._foreach_mul_(upd, -_f32(group["lr"]))
            torch._foreach_add_(params, upd)
        return None
