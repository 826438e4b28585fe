"""Mask-refinement decoders with a ConvGRU recurrence at stride 32, NCHW
inside.

Counterpart of the JAX package's models/decoder.py with every knob a
checkpoint can carry.

``SharedFPNDecoder`` (the production variant): a shared FPN top-down path
runs once per frame at batch B; a narrow per-object path runs at batch B*M
on projected shared features plus each object's soft mask. Frame-shared
inputs enter the per-object convs through ``SplitConcatConv``: the shared
kernel slice runs at batch B and is broadcast-added, each partial conv
rounded to the decoder dtype before the sum, as in the reference.

``RefinementDecoder`` (``decoder_variant="legacy"``): the frame pyramid is
broadcast to every object slot and the full-width conv stack runs at batch
B*M, each level's skip concatenated with the object's mask.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dmm_net_tpu_torch.models.layers import Conv
from dmm_net_tpu_torch.ops.resize import resize


class ConvParams(nn.Module):
    """Kernel + bias of a conv whose call its owner makes (OIHW)."""

    def __init__(self, cin: int, cout: int, k: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=dtype))


def _conv(x, w, dtype):
    return F.conv2d(x.to(dtype), w.to(dtype), None, 1, w.shape[-1] // 2)


class ConvGRUCell(nn.Module):
    """Convolutional GRU; the z and r gates run as one conv with their
    kernels concatenated along the output channels."""

    def __init__(self, cin_x: int, features: int, dtype, k: int = 3):
        super().__init__()
        self.f = features
        self.dtype = dtype
        cin = cin_x + features
        self.gate_z = ConvParams(cin, features, k, dtype)
        self.gate_r = ConvParams(cin, features, k, dtype)
        self.cand = ConvParams(cin, features, k, dtype)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dt, f = self.dtype, self.f
        h = h.to(dt)
        x = x.to(dt)
        w = torch.cat([self.gate_z.weight, self.gate_r.weight], 0)
        b = torch.cat([self.gate_z.bias, self.gate_r.bias])
        zr = torch.sigmoid(_conv(torch.cat([x, h], 1), w, dt)
                           + b.to(dt)[:, None, None])
        z, r = zr[:, :f], zr[:, f:]
        cand = torch.tanh(_conv(torch.cat([x, r * h], 1), self.cand.weight, dt)
                          + self.cand.bias.to(dt)[:, None, None])
        return (1.0 - z) * h + z * cand


class _UpBlock(nn.Module):
    """Upsample to the skip's size, merge a lateral 1x1 of the skip, fuse
    with a 3x3 conv."""

    def __init__(self, cin_x: int, cin_skip: int, features: int, dtype):
        super().__init__()
        self.lateral = Conv(cin_skip, features, 1, dtype=dtype)
        self.merge = Conv(cin_x, features, 3, dtype=dtype)
        self.fuse = Conv(features, features, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = resize(x, skip.shape[-2:])
        x = F.relu(self.merge(x) + self.lateral(skip))
        return F.relu(self.fuse(x))


class RefinementDecoder(nn.Module):
    """forward(feats, agg_masks, state, out_hw) with
      feats: NCHW pyramid {"c2".."c5"}
      agg_masks: (B, M, h, w) soft masks from the matcher
      state: (B, M, H/32, W/32, features) float32 ConvGRU state or None
    returns (logits (B, M, *out_hw) float32, new_state)."""

    def __init__(self, in_channels: Dict[str, int], features: int = 128,
                 recurrent: bool = True, dtype=torch.float32,
                 fine_level: str = "c2"):
        super().__init__()
        levels = ("c4", "c3", "c2")
        self.levels = levels[:levels.index(fine_level) + 1]
        self.dtype = dtype
        self.recurrent = recurrent
        self.f = features
        self.head = Conv(in_channels["c5"] + 1, features, 3, dtype=dtype)
        if recurrent:
            self.gru = ConvGRUCell(features, features, dtype)
        for level in self.levels:
            setattr(self, f"up_{level}",
                    _UpBlock(features, in_channels[level] + 1, features, dtype))
        self.out = Conv(features, 1, 3, dtype=torch.float32)

    def forward(self, feats: Dict[str, torch.Tensor], agg_masks: torch.Tensor,
                state: Optional[torch.Tensor] = None,
                out_hw: Optional[Tuple[int, int]] = None):
        B, M, mh, mw = agg_masks.shape
        c2 = feats["c2"]
        H, W = out_hw or (c2.shape[-2] * 4, c2.shape[-1] * 4)
        dt, f = self.dtype, self.f

        def fold(x):            # (B, c, h, w) -> (B*M, c, h, w)
            x = x.to(dt)
            return x[:, None].expand((B, M) + x.shape[1:]).reshape(
                (B * M,) + x.shape[1:])

        def with_mask(x):       # the object's mask as one more channel
            return torch.cat([x, resize(mask3, x.shape[-2:])], 1)

        mask3 = agg_masks.reshape(B * M, 1, mh, mw).to(dt)
        x = F.relu(self.head(with_mask(fold(feats["c5"]))))
        h32 = tuple(x.shape[-2:])
        if self.recurrent:
            if state is None:
                h_prev = torch.zeros((B * M, f) + h32, dtype=dt, device=x.device)
            else:
                h_prev = state.reshape((B * M,) + h32 + (f,)).permute(0, 3, 1, 2)
            x = self.gru(h_prev, x)
            new_state = x.permute(0, 2, 3, 1).reshape((B, M) + h32 + (f,)).float()
        else:
            new_state = torch.zeros((B, M) + h32 + (f,), dtype=torch.float32,
                                    device=x.device)
        for level in self.levels:
            x = getattr(self, f"up_{level}")(x, with_mask(fold(feats[level])))
        logits = resize(self.out(x)[:, 0], (H, W))
        return logits.reshape(B, M, H, W), new_state


class SplitConcatConv(nn.Module):
    """Conv over ``concat(parts)`` where some parts are frame-shared:
    per-object parts are (B*M, c, h, w), shared parts (B, c, h, w). The
    kernel covers the full concatenation in part order."""

    def __init__(self, cin: int, cout: int, k: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=dtype))

    def forward(self, parts: Sequence[Tuple[torch.Tensor, bool]], B: int,
                M: int) -> torch.Tensor:
        bounds, off = [], 0
        for p, _ in parts:
            bounds.append((off, off + p.shape[1]))
            off += p.shape[1]

        def group_conv(shared: bool):
            idx = [i for i, (_, sh) in enumerate(parts) if sh == shared]
            if not idx:
                return None
            x = torch.cat([parts[i][0].to(self.dtype) for i in idx], 1)
            w = torch.cat([self.weight[:, bounds[i][0]:bounds[i][1]]
                           for i in idx], 1)
            return _conv(x, w, self.dtype)

        obj, shared = group_conv(False), group_conv(True)
        bias = self.bias.to(self.dtype)[:, None, None]
        if obj is None:
            out = (shared + bias)[:, None].expand((B, M) + shared.shape[1:])
            return out.reshape((B * M,) + shared.shape[1:])
        chw = obj.shape[1:]
        out = obj.reshape((B, M) + chw)
        if shared is not None:
            out = out + shared[:, None]
        return (out + bias).reshape((B * M,) + chw)


class SharedFPNDecoder(nn.Module):
    """forward(feats, agg_masks, state, out_hw) with
      feats: NCHW pyramid {"c2".."c5"}
      agg_masks: (B, M, h, w) soft masks from the matcher
      state: (B, M, H/32, W/32, obj_features) float32 ConvGRU state (the JAX
        package's layout)
    returns (logits (B, M, *out_hw) float32, new_state)."""

    def __init__(self, in_channels: Dict[str, int], features: int = 128,
                 obj_features: int = 32, recurrent: bool = True,
                 dtype=torch.float32, fine_level: str = "c2",
                 obj_fuse: str = "conv3", obj_features_fine: int = 0,
                 features_fine: int = 0, obj_merge_fine_k: int = 3,
                 obj_fine_level: str = "", detail_dim: int = 16,
                 detail_basis_k: int = 3):
        super().__init__()
        if obj_fuse not in ("conv3", "conv1", "none"):
            raise ValueError(f"unknown obj_fuse {obj_fuse!r}")
        levels = ("c4", "c3", "c2")
        self.levels = levels[:levels.index(fine_level) + 1]
        self.obj_levels = self.levels
        if obj_fine_level:
            if obj_fine_level not in self.levels:
                raise ValueError(
                    f"obj_fine_level {obj_fine_level!r} not within "
                    f"fine_level {fine_level!r}'s pyramid {self.levels}")
            self.obj_levels = self.levels[:self.levels.index(obj_fine_level) + 1]
        # The reference gates the detail head on tuple identity
        # (`obj_levels is not levels`). CPython returns the same tuple for a
        # full slice, so the head exists exactly when the per-object path
        # stops above the finest shared level.
        self.detail = len(self.obj_levels) < len(self.levels)
        self.dtype = dtype
        self.recurrent = recurrent
        self.obj_fuse = obj_fuse
        f, g = features, obj_features
        self.g = g
        dt = dtype

        self.head = Conv(in_channels["c5"], f, 3, dtype=dt)
        shared_ch = {"c5": f}
        cin = f
        for level in self.levels:
            f_l = features_fine if (level == self.levels[-1] and features_fine) else f
            setattr(self, f"lat_{level}", Conv(in_channels[level], f_l, 1, dtype=dt))
            setattr(self, f"merge_{level}", Conv(cin, f_l, 3, dtype=dt))
            setattr(self, f"fuse_{level}", Conv(f_l, f_l, 3, dtype=dt))
            shared_ch[level] = f_l
            cin = f_l
        for k, ch in shared_ch.items():
            setattr(self, f"toobj_{k}", Conv(ch, g, 1, dtype=dt))

        self.obj_head = SplitConcatConv(g + 1, g, 3, dt)
        if recurrent:
            self.gru = ConvGRUCell(g, g, dt)
        g_prev = g
        for level in self.obj_levels:
            g_l, k_l = g, 3
            if level == self.obj_levels[-1]:
                g_l = obj_features_fine or g
                k_l = obj_merge_fine_k
            setattr(self, f"obj_merge_{level}",
                    SplitConcatConv(g_prev + g + 1, g_l, k_l, dt))
            if obj_fuse != "none":
                kf = 3 if obj_fuse == "conv3" else 1
                setattr(self, f"obj_fuse_{level}", Conv(g_l, g_l, kf, dtype=dt))
            g_prev = g_l
        self.out = Conv(g_prev, 1, 3, dtype=torch.float32)
        if self.detail:
            fine = self.levels[-1]
            self.detail_basis = Conv(shared_ch[fine], detail_dim,
                                     detail_basis_k, dtype=dt)
            self.detail_mix = nn.Linear(g_prev, detail_dim)

    def forward(self, feats: Dict[str, torch.Tensor], agg_masks: torch.Tensor,
                state: Optional[torch.Tensor] = None,
                out_hw: Optional[Tuple[int, int]] = None):
        B, M, mh, mw = agg_masks.shape
        c2 = feats["c2"]
        H, W = out_hw or (c2.shape[-2] * 4, c2.shape[-1] * 4)
        dt, g = self.dtype, self.g

        # ---- shared frame path: FPN top-down at batch B ----
        x = F.relu(self.head(feats["c5"].to(dt)))
        shared = {"c5": x}
        for level in self.levels:
            skip = feats[level].to(dt)
            x = resize(x, skip.shape[-2:])
            lat = getattr(self, f"lat_{level}")(skip)
            x = F.relu(getattr(self, f"merge_{level}")(x) + lat)
            x = F.relu(getattr(self, f"fuse_{level}")(x))
            shared[level] = x
        proj = {k: getattr(self, f"toobj_{k}")(v) for k, v in shared.items()}

        # ---- per-object path at batch B*M ----
        mask3 = agg_masks.reshape(B * M, 1, mh, mw).to(dt)
        h32 = proj["c5"].shape[-2:]
        x = F.relu(self.obj_head([(proj["c5"], True),
                                  (resize(mask3, h32), False)], B, M))
        if self.recurrent:
            if state is None:
                h_prev = torch.zeros((B * M, g) + tuple(h32), dtype=dt,
                                     device=x.device)
            else:
                h_prev = state.reshape((B * M,) + tuple(h32) + (g,)) \
                              .permute(0, 3, 1, 2)
            x = self.gru(h_prev, x)
            new_state = x.permute(0, 2, 3, 1).reshape(
                (B, M) + tuple(h32) + (g,)).float()
        else:
            new_state = torch.zeros((B, M) + tuple(h32) + (g,),
                                    dtype=torch.float32, device=x.device)

        for level in self.obj_levels:
            hw = proj[level].shape[-2:]
            x = resize(x, hw)
            x = F.relu(getattr(self, f"obj_merge_{level}")(
                [(x, False), (proj[level], True), (resize(mask3, hw), False)],
                B, M))
            if self.obj_fuse != "none":
                x = x + F.relu(getattr(self, f"obj_fuse_{level}")(x))

        logits = self.out(x)[:, 0]                      # (B*M, h_obj, w_obj)
        if self.detail:
            fine = self.levels[-1]
            hw_f = tuple(proj[fine].shape[-2:])
            logits = resize(logits, hw_f)
            basis = self.detail_basis(shared[fine])     # (B, D, h, w)
            pooled = x.float().mean(dim=(2, 3)).to(x.dtype)
            mix = self.detail_mix(pooled.float().reshape(B, M, -1))
            detail = torch.einsum("bdhw,bmd->bmhw", basis.float(), mix)
            logits = (logits.reshape((B, M) + hw_f) + detail).reshape(
                (B * M,) + hw_f)
        logits = resize(logits, (H, W))
        return logits.reshape(B, M, H, W), new_state
