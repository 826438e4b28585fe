"""Plain PyTorch reference of the DMM-Net frame step, the yardstick that
decides a run's ``correct``.

A frozen copy of the model's mathematics as the benchmark's configurations
run it: a ResNet-50 with frozen BatchNorm, the 1x1 embedding projection,
mask-weighted feature pooling, the IoU + cosine cost, the unrolled
log-domain Sinkhorn, soft aggregation, the shared-FPN decoder with its
ConvGRU and detail head, the paste of compact proposals and the bilinear
upsample + argmax that gives labels. Written with ``torch`` operations
only: it imports nothing of the program, calls none of its kernels and
reads none of its state. Layouts follow the program's public ones (frames
(B, H, W, 3), masks (B, K, h, w), X (B, M, N)); parameter names follow its
module tree, so one state dict made by the benchmark loads into both.

Precision: each layer computes in the dtype the configuration states
(``model.backbone_dtype``, ``model.decoder_dtype``, ``model.mask_dtype``;
float32 elsewhere, with TF32 off). ``Precision.lowp`` is the control: every
bfloat16 convolution then takes float8 (e4m3) operands with a per-tensor
scale, and float32 products run in TF32, one step below what the
configuration states.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_NEG = -1e30
_EPS = 1e-6
_FP8_MAX = 448.0


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class Precision:
    """Shared by every layer of one reference model: ``lowp`` switches the
    control's float8 operands on."""

    def __init__(self, lowp: bool = False):
        self.lowp = lowp


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with a per-tensor scale (its largest
    magnitude maps to e4m3's largest finite value), back in x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = amax / _FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    # straight-through, so that the control can also be trained on
    return x + (q.to(x.dtype) - x).detach()


def conv2d(x, w, b, stride, padding, dtype, prec: Precision):
    x, w = x.to(dtype), w.to(dtype)
    if prec.lowp and dtype == torch.bfloat16:
        x, w = fp8_round(x), fp8_round(w)
    y = F.conv2d(x, w, None, stride, padding)
    if b is not None:
        y = y + b.to(dtype)[:, None, None]
    return y


def resize(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """Antialiased bilinear resize of the trailing (h, w) in float32, back
    in x's dtype (jax.image.resize's weights); no-op at the same size."""
    hw = (int(hw[0]), int(hw[1]))
    if tuple(x.shape[-2:]) == hw:
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((1, -1) + tuple(x.shape[-2:])).float(),
                      size=hw, mode="bilinear", align_corners=False,
                      antialias=True)
    return y.reshape(lead + hw).to(x.dtype)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=None, bias=True,
                 dtype=torch.float32, prec: Optional[Precision] = None):
        super().__init__()
        self.stride, self.padding = stride, k // 2 if padding is None else padding
        self.dtype, self.prec = dtype, prec
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(cout, dtype=dtype)) if bias else None

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dtype, self.prec)


class FrozenBN(nn.Module):
    """BatchNorm on running statistics: float32 arithmetic, eps 1e-5,
    output in the layer's dtype."""

    def __init__(self, ch, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))
        self.register_buffer("running_mean", torch.empty(ch))
        self.register_buffer("running_var", torch.empty(ch))

    def forward(self, x):
        x = x.float()
        mul = torch.rsqrt(self.running_var + 1e-5) * self.weight
        y = (x - self.running_mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


class Bottleneck(nn.Module):
    def __init__(self, cin, filters, stride, dtype, prec):
        super().__init__()
        out = filters * 4
        self.conv0 = Conv(cin, filters, 1, bias=False, dtype=dtype, prec=prec)
        self.bn0 = FrozenBN(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, stride, 1, bias=False,
                          dtype=dtype, prec=prec)
        self.bn1 = FrozenBN(filters, dtype)
        self.conv2 = Conv(filters, out, 1, bias=False, dtype=dtype, prec=prec)
        self.bn2 = FrozenBN(out, dtype)
        self.has_proj = stride != 1 or cin != out
        if self.has_proj:
            self.conv_proj = Conv(cin, out, 1, stride, 0, bias=False,
                                  dtype=dtype, prec=prec)
            self.norm_proj = FrozenBN(out, dtype)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        res = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return F.relu(y + res)


class ResNet50(nn.Module):
    stages = (3, 4, 6, 3)

    def __init__(self, dtype, prec):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, 64, 7, 2, 3, bias=False, dtype=dtype, prec=prec)
        self.bn_init = FrozenBN(64, dtype)
        blocks, self.stage_ends, cin = [], [], 64
        for i, count in enumerate(self.stages):
            filters = 64 * 2 ** i
            for j in range(count):
                blocks.append(Bottleneck(cin, filters, 2 if i > 0 and j == 0 else 1,
                                         dtype, prec))
                cin = filters * 4
            self.stage_ends.append(len(blocks))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        x = F.relu(self.bn_init(self.conv_init(x.to(self.dtype))))
        feats = {"c1": x}
        x = F.max_pool2d(x, 3, 2, 1)
        start = 0
        for i, end in enumerate(self.stage_ends):
            for blk in self.blocks[start:end]:
                x = blk(x)
            feats[f"c{i + 2}"] = x
            start = end
        return feats


FEATURE_DIMS = {"c1": 64, "c2": 256, "c3": 512, "c4": 1024, "c5": 2048}


class ConvParams(nn.Module):
    def __init__(self, cin, cout, k, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(cout, dtype=dtype))


class ConvGRU(nn.Module):
    def __init__(self, cin_x, f, dtype, prec):
        super().__init__()
        self.f, self.dtype, self.prec = f, dtype, prec
        self.gate_z = ConvParams(cin_x + f, f, 3, dtype)
        self.gate_r = ConvParams(cin_x + f, f, 3, dtype)
        self.cand = ConvParams(cin_x + f, f, 3, dtype)

    def forward(self, h, x):
        dt, f = self.dtype, self.f
        h, x = h.to(dt), x.to(dt)
        w = torch.cat([self.gate_z.weight, self.gate_r.weight], 0)
        b = torch.cat([self.gate_z.bias, self.gate_r.bias])
        zr = torch.sigmoid(conv2d(torch.cat([x, h], 1), w, b, 1, 1, dt, self.prec))
        z, r = zr[:, :f], zr[:, f:]
        cand = torch.tanh(conv2d(torch.cat([x, r * h], 1), self.cand.weight,
                                 self.cand.bias, 1, 1, dt, self.prec))
        return (1.0 - z) * h + z * cand


class SplitConv(nn.Module):
    """Conv over the concatenation of per-object parts (B*M rows) and
    frame-shared parts (B rows): the shared slice of the kernel runs at
    batch B and is broadcast-added, each partial conv rounded to the
    layer's dtype before the sum."""

    def __init__(self, cin, cout, k, dtype, prec):
        super().__init__()
        self.dtype, self.prec = dtype, prec
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(cout, dtype=dtype))

    def forward(self, parts, B, M):
        bounds, off = [], 0
        for p, _ in parts:
            bounds.append((off, off + p.shape[1]))
            off += p.shape[1]
        pad = self.weight.shape[-1] // 2

        def group(shared):
            idx = [i for i, (_, sh) in enumerate(parts) if sh == shared]
            x = torch.cat([parts[i][0].to(self.dtype) for i in idx], 1)
            w = torch.cat([self.weight[:, bounds[i][0]:bounds[i][1]] for i in idx], 1)
            return conv2d(x, w, None, 1, pad, self.dtype, self.prec)

        obj, shared = group(False), group(True)
        out = obj.reshape((B, M) + obj.shape[1:]) + shared[:, None]
        return (out + self.bias.to(self.dtype)[:, None, None]).reshape(
            (B * M,) + obj.shape[1:])


class Decoder(nn.Module):
    """The shared-FPN decoder: a top-down path at batch B, a per-object
    path at batch B*M on projected shared features and each object's mask,
    a ConvGRU at stride 32, and the shared-basis detail head when the
    per-object path stops above the finest level."""

    def __init__(self, m: dict, prec):
        super().__init__()
        dt = dtype_of(m["decoder_dtype"])
        f, g = m["decoder_dim"], m["decoder_obj_dim"]
        levels = ("c4", "c3", "c2")
        self.levels = levels[:levels.index(m["decoder_fine_level"]) + 1]
        self.obj_levels = self.levels
        if m["decoder_obj_fine_level"]:
            self.obj_levels = self.levels[:self.levels.index(
                m["decoder_obj_fine_level"]) + 1]
        self.detail = len(self.obj_levels) < len(self.levels)
        if not m["decoder_recurrent"] or m["decoder_variant"] != "shared":
            raise ValueError("the reference covers the recurrent shared decoder")
        self.dtype, self.g, self.fuse = dt, g, m["decoder_obj_fuse"]
        self.head = Conv(FEATURE_DIMS["c5"], f, 3, dtype=dt, prec=prec)
        shared_ch, cin = {"c5": f}, f
        for level in self.levels:
            f_l = (m["decoder_dim_fine"] if level == self.levels[-1]
                   and m["decoder_dim_fine"] else f)
            setattr(self, f"lat_{level}", Conv(FEATURE_DIMS[level], f_l, 1, dtype=dt, prec=prec))
            setattr(self, f"merge_{level}", Conv(cin, f_l, 3, dtype=dt, prec=prec))
            setattr(self, f"fuse_{level}", Conv(f_l, f_l, 3, dtype=dt, prec=prec))
            shared_ch[level], cin = f_l, f_l
        for k, ch in shared_ch.items():
            setattr(self, f"toobj_{k}", Conv(ch, g, 1, dtype=dt, prec=prec))
        self.obj_head = SplitConv(g + 1, g, 3, dt, prec)
        self.gru = ConvGRU(g, g, dt, prec)
        g_prev = g
        for level in self.obj_levels:
            g_l, k_l = g, 3
            if level == self.obj_levels[-1]:
                g_l = m["decoder_obj_dim_fine"] or g
                k_l = m["decoder_obj_merge_fine_k"]
            setattr(self, f"obj_merge_{level}", SplitConv(g_prev + g + 1, g_l, k_l, dt, prec))
            if self.fuse != "none":
                kf = 3 if self.fuse == "conv3" else 1
                setattr(self, f"obj_fuse_{level}", Conv(g_l, g_l, kf, dtype=dt, prec=prec))
            g_prev = g_l
        self.out = Conv(g_prev, 1, 3, dtype=torch.float32, prec=prec)
        if self.detail:
            self.detail_basis = Conv(shared_ch[self.levels[-1]], m["decoder_detail_dim"],
                                     m["decoder_detail_basis_k"], dtype=dt, prec=prec)
            self.detail_mix = nn.Linear(g_prev, m["decoder_detail_dim"])

    def forward(self, feats, agg, state, out_hw):
        B, M, mh, mw = agg.shape
        dt, g = self.dtype, self.g
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
        mask3 = agg.reshape(B * M, 1, mh, mw).to(dt)
        h32 = tuple(proj["c5"].shape[-2:])
        x = F.relu(self.obj_head([(proj["c5"], True), (resize(mask3, h32), False)], B, M))
        h_prev = state.reshape((B * M,) + h32 + (g,)).permute(0, 3, 1, 2)
        x = self.gru(h_prev, x)
        new_state = x.permute(0, 2, 3, 1).reshape((B, M) + h32 + (g,)).float()
        for level in self.obj_levels:
            hw = proj[level].shape[-2:]
            x = resize(x, hw)
            x = F.relu(getattr(self, f"obj_merge_{level}")(
                [(x, False), (proj[level], True), (resize(mask3, hw), False)], B, M))
            if self.fuse != "none":
                x = x + F.relu(getattr(self, f"obj_fuse_{level}")(x))
        logits = self.out(x)[:, 0]
        if self.detail:
            fine = self.levels[-1]
            hw_f = tuple(proj[fine].shape[-2:])
            logits = resize(logits, hw_f)
            basis = self.detail_basis(shared[fine])
            pooled = x.float().mean(dim=(2, 3)).to(x.dtype)
            mix = self.detail_mix(pooled.float().reshape(B, M, -1))
            detail = torch.einsum("bdhw,bmd->bmhw", basis.float(), mix)
            logits = (logits.reshape((B, M) + hw_f) + detail).reshape((B * M,) + hw_f)
        logits = resize(logits, out_hw)
        return logits.reshape(B, M, *out_hw), new_state


# -- matching ---------------------------------------------------------------

def _masked_lse(x, mask, dim):
    xm = torch.where(mask, x, torch.full_like(x, _NEG))
    mx = xm.amax(dim=dim, keepdim=True).clamp_min(_NEG / 2)
    s = torch.where(mask, torch.exp(xm - mx), torch.zeros_like(x)).sum(dim=dim, keepdim=True)
    return (mx + torch.log(s.clamp_min(1e-38))).squeeze(dim)


def pool_cost_sinkhorn(emb, pmp, tm, pm, tf, rm, cm, epsilon, iters, lam):
    """X (B, M, N) of the pooled IoU + cosine cost by the unrolled
    log-domain Sinkhorn: emb (B, P, D), pmp (B, N, P) at the embedding
    grid, tm (B, M, Pc) and pm (B, N, Pc) at the cost grid, tf (B, M, D),
    rm (B, M) and cm (B, N) bool. Float32, differentiable by autograd."""
    pair = rm[..., :, None] & cm[..., None, :]
    area = pmp.sum(-1)
    pf = (pmp @ emb) / area.clamp_min(1e-6)[..., None]
    inter = tm @ pm.transpose(-1, -2)
    union = tm.sum(-1)[..., :, None] + pm.sum(-1)[..., None, :] - inter
    iou = inter / union.clamp_min(_EPS)
    tn = tf * torch.rsqrt((tf * tf).sum(-1, keepdim=True) + _EPS * _EPS)
    pn = pf * torch.rsqrt((pf * pf).sum(-1, keepdim=True) + _EPS * _EPS)
    C = lam * (1.0 - iou) + (1.0 - lam) * (1.0 - tn @ pn.transpose(-1, -2))
    C = torch.where(pair, C, torch.full_like(C, 10.0))
    neg = torch.full_like(C, _NEG)
    zf = torch.zeros(C.shape[:-1], dtype=C.dtype, device=C.device)
    zg = torch.zeros(C.shape[:-2] + C.shape[-1:], dtype=C.dtype, device=C.device)
    g = zg
    negC = torch.where(pair, -C / epsilon, neg)
    for _ in range(iters):
        f = torch.where(rm, -epsilon * _masked_lse(negC + g[..., None, :] / epsilon, pair, -1), zf)
        h = -epsilon * _masked_lse(negC + f[..., :, None] / epsilon, pair, -2)
        g = torch.where(cm, h.clamp_max(0.0), zg)
    f = torch.where(rm, -epsilon * _masked_lse(negC + g[..., None, :] / epsilon, pair, -1), zf)
    L = (f[..., :, None] + g[..., None, :] - C) / epsilon
    return torch.where(pair, torch.exp(L.clamp_max(30.0)), torch.zeros_like(C))


def mask_avg_pool(feats_nhwc, masks):
    """(B, H, W, C) features, (B, K, h, w) masks at any size -> (B, K, C)."""
    H, W, C = feats_nhwc.shape[-3:]
    m = resize(masks, (H, W)).float().reshape(masks.shape[:-2] + (H * W,))
    pooled = m @ feats_nhwc.float().reshape(feats_nhwc.shape[:-3] + (H * W, C))
    return pooled / m.sum(-1, keepdim=True).clamp_min(1e-6)


class FrameStep(nn.Module):
    """backbone -> embedding -> pooled cost + Sinkhorn -> aggregation ->
    decoder, for one frame of a batch of sequences. ``cfg``: the
    configuration as a nested dict (the benchmark's config file)."""

    def __init__(self, cfg: dict, lowp: bool = False):
        super().__init__()
        m = cfg["model"]
        if m["backbone"] != "resnet50" or m["input_norm"] != "raw01":
            raise ValueError("the reference covers ResNet-50 on raw [0, 1] frames")
        if cfg["matching"]["solver"] != "sinkhorn" or cfg["matching"]["decode"] != "soft" \
                or cfg["matching"]["epsilon_init"]:
            raise ValueError("the reference covers the soft Sinkhorn matcher")
        self.cfg = cfg
        self.prec = Precision(lowp)
        self.backbone = ResNet50(dtype_of(m["backbone_dtype"]), self.prec)
        self.feat_proj = Conv(FEATURE_DIMS["c4"], m["feature_dim"], 1,
                              dtype=torch.float32, prec=self.prec)
        self.decoder = Decoder(m, self.prec)
        H, W = m["image_size"]
        self.image_hw = (H, W)
        self.mask_hw = (H // 4, W // 4) if m["mask_res"] == "stride4" else (H, W)
        self.mask_dtype = dtype_of(m["mask_dtype"])

    def features(self, frames):
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0
        feats = dict(self.backbone(frames.permute(0, 3, 1, 2)))
        feats["emb"] = self.feat_proj(feats["c4"].float())
        return feats

    def template_features(self, frame0, tmpl_masks):
        return self.template_features_from(self.features(frame0), tmpl_masks)

    @staticmethod
    def template_features_from(feats, tmpl_masks):
        return mask_avg_pool(feats["emb"].permute(0, 2, 3, 1), tmpl_masks)

    def init_state(self, tmpl_masks):
        B, M = tmpl_masks.shape[:2]
        H, W = self.image_hw
        g = self.cfg["model"]["decoder_obj_dim"]
        dec = torch.zeros((B, M, H // 32, W // 32, g), dtype=torch.float32,
                          device=tmpl_masks.device)
        return resize(tmpl_masks.to(self.mask_dtype), self.mask_hw), dec

    def forward(self, frame, prop_masks, prop_valid, tmpl_feats, tmpl_valid,
                state, feats=None):
        """Returns (logits (B, M, *out_hw) float32, X, (templates, decoder
        state))."""
        cfg, m = self.cfg, self.cfg["model"]
        if feats is None:
            feats = self.features(frame)
        mdt = self.mask_dtype
        pm = resize(prop_masks.to(mdt), self.mask_hw)
        tm = resize(state[0].to(mdt), self.mask_hw)
        emb = feats["emb"]
        B, D, eh, ew = emb.shape
        M, N = tm.shape[1], pm.shape[1]
        mc = tuple(cfg["cost"]["mask_size"])
        X = pool_cost_sinkhorn(
            emb.permute(0, 2, 3, 1).reshape(B, eh * ew, D),
            resize(pm, (eh, ew)).reshape(B, N, -1).float(),
            resize(tm, mc).reshape(B, M, -1).float(),
            resize(pm, mc).reshape(B, N, -1).float(), tmpl_feats.float(),
            tmpl_valid.bool(), prop_valid.bool(), cfg["matching"]["epsilon"],
            cfg["matching"]["sinkhorn_iters"], cfg["cost"]["iou_weight"])
        # aggregation: X rounded to the masks' dtype, summed in float32
        h, w = pm.shape[-2:]
        agg = (X.to(mdt).float() @ pm.float().reshape(B, N, h * w)).reshape(B, M, h, w)
        agg = torch.where(tmpl_valid.bool()[..., None, None], agg, torch.zeros_like(agg))
        out_hw = self.mask_hw if m["logits_res"] == "mask" else self.image_hw
        logits, dec = self.decoder(feats, agg, state[1], out_hw)
        logits = torch.where(tmpl_valid.bool()[..., None, None], logits,
                             torch.full_like(logits, -1e4))
        if m["template_update"] != "decoder":
            raise ValueError("the reference covers decoder template updates")
        new_tm = resize(torch.sigmoid(logits), self.mask_hw).to(mdt)
        return logits, X, (new_tm, dec)


# -- the engine's pieces around the frame step -------------------------------

BUCKETS = (1, 2, 4, 8, 16, 32)


def bucket(count: int, m_max: int) -> int:
    """Smallest bucket >= count, at most m_max: the object slots a batch
    of sequences runs with."""
    for b in BUCKETS:
        if b >= max(count, 1):
            return min(b, m_max)
    return m_max


def _paste_weights(coord, m):
    inside = (coord > -0.5) & (coord < m - 0.5)
    c0 = torch.floor(coord).clamp(0, m - 1)
    d = (coord - c0).clamp(0.0, 1.0)
    c0i = c0.long()
    c1i = (c0i + 1).clamp(0, m - 1)
    bins = torch.arange(m, device=coord.device)
    R = ((1.0 - d)[..., None] * (c0i[..., None] == bins).float()
         + d[..., None] * (c1i[..., None] == bins).float())
    return R * inside[..., None].float()


def paste(masks28, boxes, valid, image_hw, grid_hw, dtype):
    """Compact proposals -> binary masks on the mask grid: boxes (B, N, 4)
    in image coordinates scaled to the grid, box-local masks (B, N, mh, mw)
    sampled bilinearly at pixel centres, thresholded at 0.5."""
    H, W = image_hw
    gh, gw = grid_hw
    mh, mw = masks28.shape[-2:]
    dev = masks28.device
    scale = torch.tensor([gw / W, gh / H, gw / W, gh / H], dtype=torch.float32, device=dev)
    b = boxes.float() * scale
    x1, y1 = b[..., 0:1], b[..., 1:2]
    bw = (b[..., 2:3] - x1).clamp_min(1e-3)
    bh = (b[..., 3:4] - y1).clamp_min(1e-3)
    u = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5 - x1) / bw * mw - 0.5
    v = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5 - y1) / bh * mh - 0.5
    out = _paste_weights(v, mh) @ masks28.float() @ _paste_weights(u, mw).transpose(-1, -2)
    out = torch.where(valid.bool()[..., None, None], out, torch.zeros_like(out))
    return (out > 0.5).to(dtype)


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    out = np.zeros((n_in, n_out), np.float32)
    if n_in == n_out:
        np.fill_diagonal(out, 1.0)
        return out
    scale = n_in / n_out
    for o in range(n_out):
        x = min(max((o + 0.5) * scale - 0.5, 0.0), n_in - 1.0)
        i0 = int(np.floor(x))
        f = x - i0
        out[i0, o] += 1.0 - f
        out[min(i0 + 1, n_in - 1), o] += f
    return out


def resolve_labels(logits, tmpl_valid, image_hw, with_margin: bool = False):
    """Mask-grid logits (B, M, h, w) -> uint8 labels (B, H, W): bf16
    operands, the column pass rounded to bf16, then the row pass; the
    argmax over valid objects, background below logit 0 (probability 0.5);
    ties to the lower object index. ``with_margin`` also returns each
    pixel's decision margin relative to its logit, min(best - second best,
    |best|) / max(|best|, 1): how far the label is from changing."""
    B, M, h, w = logits.shape
    H, W = image_hw
    dev = logits.device
    if (h, w) == (H, W):
        up = logits.float()
    else:
        R = torch.from_numpy(_interp_matrix(h, H)).to(torch.bfloat16).float().to(dev)
        Cm = torch.from_numpy(_interp_matrix(w, W)).to(torch.bfloat16).float().to(dev)
        u1 = (logits.to(torch.bfloat16).float() @ Cm).to(torch.bfloat16).float()
        up = torch.einsum("hH,bmhW->bmHW", R, u1)
    up = torch.where(tmpl_valid.bool()[..., None, None], up, torch.full_like(up, -math.inf))
    best = up.amax(dim=1)
    slot = torch.arange(M, device=dev)[None, :, None, None]
    idx = torch.where(up == best[:, None], slot, M).amin(dim=1)   # the lowest tied index
    labels = torch.where(best > 0.0, idx + 1, torch.zeros_like(idx)).to(torch.uint8)
    if not with_margin:
        return labels
    second = (up.topk(2, dim=1).values[:, 1] if M > 1
              else torch.full_like(best, -math.inf))
    margin = torch.minimum(best - second, best.abs()) / best.abs().clamp_min(1.0)
    return labels, margin
