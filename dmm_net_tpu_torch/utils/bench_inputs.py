"""The frame-step inputs every bench measures (bench_torch.py and
bench/*_torch.py), made on the device: the full-resolution proposal
tensor alone is B*N*H*W*4 bytes, 0.94 GB at p3 with B=16. One definition
keeps the benches measuring identical inputs.

Counterpart of the JAX package's utils/bench_inputs.py: the same six
tensors, shapes and dtypes and the same densities. Its random numbers come
from a ``torch.Generator`` on ``device`` seeded by ``seed``, so they are
not JAX's numbers.
"""

from __future__ import annotations

import torch

from dmm_net_tpu_torch import resolve_device
from dmm_net_tpu_torch.models.dmm import init_frame_state


def make_frame_inputs(cfg, B: int, seed: int = 0, device=None):
    """(frame, prop_masks, prop_valid, tmpl_feats, tmpl_valid, state) for
    one frame step at batch B on ``device`` (CUDA unless asked otherwise):
    frame (B, H, W, 3) float32 in [0, 1); prop_masks (B, N, H, W) float32,
    each pixel 1 with probability 0.2; prop_valid (B, N) all True;
    tmpl_feats (B, M, D) float32 standard normal; tmpl_valid (B, M) all
    True; state from ``init_frame_state`` on templates drawn as the
    proposals are (its grid and dtype are the ones the step returns, so a
    timed loop can carry it)."""
    dev = resolve_device(device)
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals
    g = torch.Generator(device=dev).manual_seed(seed)

    def binary(*shape):
        return (torch.rand(shape, generator=g, device=dev) > 0.8).float()

    frame = torch.rand((B, H, W, 3), generator=g, device=dev)
    pm = binary(B, N, H, W)
    pv = torch.ones((B, N), dtype=torch.bool, device=dev)
    tf_ = torch.randn((B, M, cfg.model.feature_dim), generator=g, device=dev)
    tv = torch.ones((B, M), dtype=torch.bool, device=dev)
    state = init_frame_state(cfg, binary(B, M, H, W))
    return frame, pm, pv, tf_, tv, state
