"""The yardstick's arithmetic, frozen here so that a program change cannot
move it: the card's published peaks, each kernel's operations and its
least bytes (each input read once, each output written once), and the
roofline bound that follows.

Copied from the program's measurement tools as they stood when the
benchmark was defined: ``pool_cost_match_ops`` and ``resolve_upsample_ops``
(the kernels' operation counts), and ``chip_smoke.py``'s bounds of B1, B2
and B1' (``matcher_bound``, ``resolve_bound``, ``bound_ms``).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit.
BF16_PEAK_FLOPS = 989e12
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def pool_cost_match_ops(B, M, N, P, D, Pc, iters, pairs) -> int:
    """Arithmetic operations of one B1 call: pooling (a product and the
    mask areas), the mask intersections and areas on the cost grid, the
    cosine term and the norms, and each Sinkhorn iteration's row and column
    log-sum-exps over the ``pairs`` valid (template, proposal) entries."""
    return (2 * B * N * P * D + B * N * P
            + 2 * B * M * N * Pc + B * (M + N) * Pc
            + 2 * B * M * N * D + 2 * B * (M + N) * D
            + 10 * (iters + 1) * pairs)


def b1_bytes(B, M, N, P, D, Pc) -> int:
    """B1's inputs read once (float32 embedding, masks at the pooling and
    cost grids, template features; boolean validity) and X written."""
    floats = B * P * D + B * N * P + B * M * Pc + B * N * Pc + B * M * D
    return 4 * floats + B * M + B * N + 4 * B * M * N


def b1_backward_bytes(B, M, N, P, D, Pc) -> int:
    """B1''s least bytes: the forward's saved inputs and gX read once, the
    five float gradients written."""
    floats = B * P * D + B * N * P + B * M * Pc + B * N * Pc + B * M * D
    return 4 * floats + B * M + B * N + 4 * B * M * N + 4 * floats


def resolve_upsample_ops(valid_slots, h, H, W) -> int:
    """One B2 call: the column pass and the row pass of each valid
    (element, object) slot, and the argmax's compare per pixel and slot."""
    return 3 * valid_slots * h * W + 3 * valid_slots * H * W + valid_slots * H * W


def b2_bytes(B, M, valid_slots, h, w, H, W, logit_bytes=4) -> int:
    """Only the valid slots' logits can change a label, so only they are
    read; the validity flags read, the uint8 labels written."""
    return valid_slots * h * w * logit_bytes + B * M + B * H * W


def bound_s(nbytes: float, ops: float, flops_peak: float = F32_PEAK_FLOPS):
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the peak."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / flops_peak
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")
