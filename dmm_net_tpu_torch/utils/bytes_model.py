"""Hand model of the device-memory bytes per frame of the chunked frame
step (a lower bound), for bench_torch.py's roofline share.

Counterpart of the JAX package's utils/bytes_model.py: the same
per-tensor model, in the port's own copy (plain Python arithmetic).
Every materialised activation is counted once per producer (write) and
once per distinct consumer stage (read), at its travel dtype; perfect
fusion is assumed (elementwise chains are free, residual adds ride the
producing conv's epilogue); weights are read once per step and amortised
over the batch. The port's eager step moves more than this (each
elementwise op and cast reads and writes its tensor), so a share of the
memory rate computed from it is a lower bound on the real share.

One known difference from the reference: the detail head's basis conv is
counted as k*k*f*D weights with k = ``cfg.model.decoder_detail_basis_k``
(the kernel the decoder builds), where the reference counts 9*f*D
whatever k is. So the two differ by (k*k - 9)*f*D weight elements per
step, amortised over B (8*f*D fewer here at the shipped k = 1). Stage shapes
mirror models/{resnet,decoder,dmm}.py at the given config: update both
when the architecture changes.
"""

from __future__ import annotations

from typing import Dict

_STAGE_SIZES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
                "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
_BOTTLENECK = {"resnet18": False, "resnet34": False,
               "resnet50": True, "resnet101": True}


def _dt(name: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[name]


def chunk_step_bytes(cfg, B: int) -> Dict:
    """Device-memory bytes per FRAME of the chunked compact step (lower
    bound).

    Returns {"total_mb_per_frame", "stages": {name: mb}}. `B` amortizes
    weight traffic (weights are read once per step of B frames).
    """
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals
    bb = _dt(cfg.model.backbone_dtype)
    dd = _dt(cfg.model.decoder_dtype)
    md = _dt(cfg.model.mask_dtype)
    f = cfg.model.decoder_dim
    g = cfg.model.decoder_obj_dim
    g_fine = cfg.model.decoder_obj_dim_fine or g
    stride4 = cfg.model.mask_res == "stride4"
    mh, mw = (H // 4, W // 4) if stride4 else (H, W)
    stages: Dict[str, float] = {}

    def area(s):
        return (H // s) * (W // s)

    # ---- input + stem ----------------------------------------------------
    # u8 frame read; cast write+read into the stem conv
    stages["frame_in"] = H * W * 3 * (1 + 2 * bb)

    # ---- backbone (write each block output, read once by the next block;
    # bottleneck internals a1/a2 write+read) -------------------------------
    name = cfg.model.backbone
    sizes = _STAGE_SIZES[name]
    bottleneck = _BOTTLENECK[name]
    exp = 4 if bottleneck else 1
    bbytes = area(2) * 64 * bb * 2                      # c1 write + read
    n_params = 0
    cin = 64
    for i, n_blocks in enumerate(sizes):
        planes = 64 * 2 ** i
        cout = planes * exp
        s = 4 * 2 ** i                                  # output stride
        a = area(s)
        for j in range(n_blocks):
            if bottleneck:
                # reads: in(cin) + a1 + a2 (+ proj in); writes: a1,a2,out
                rw = cin + 2 * (planes * 2) + cout
                n_params += planes * cin + 9 * planes * planes \
                    + planes * cout
                if j == 0 and cin != cout:
                    rw += cin + 0                       # proj reads input
                    n_params += cin * cout
            else:
                rw = cin + 2 * planes + planes
                n_params += 9 * planes * (cin + planes)
                if j == 0 and cin != planes * exp:
                    rw += cin
                    n_params += cin * planes
            bbytes += a * rw * bb
            cin = cout
    stages["backbone"] = bbytes
    stages["weights_backbone"] = n_params * bb / B

    # ---- proposal paste + matcher (the fused kernel: one read of the mask
    # operands; pasted masks written once at mask grid, read by pool/cost
    # inside the kernel and once more by aggregation) ----------------------
    pm_bytes = N * mh * mw * md
    stages["paste_masks"] = N * (28 * 28 * 4 + 4 * 4) + pm_bytes  # write
    stages["matcher"] = pm_bytes + M * mh * mw * md \
        + (N + M) * cfg.model.feature_dim * 4 \
        + area(4) * cfg.model.feature_dim * bb          # emb read

    # ---- aggregation: reads pm once, writes (M, mh, mw) ------------------
    stages["aggregate"] = pm_bytes + M * mh * mw * md

    # ---- decoder ----------------------------------------------------------
    if cfg.model.decoder_variant == "shared":
        d = 0.0
        dw = 0
        # shared path: head at /32 + per level lat(1x1)+merge+fuse at f
        for lvl_s in (32, 16, 8, 4):
            a = area(lvl_s)
            # writes+reads of the three f-wide maps + lateral read of the
            # backbone tap (counted in backbone already as written; read
            # here)
            d += a * f * dd * (3 * 2)
            d += a * g * dd * 2                          # 1x1 proj to g
            dw += f * f * 9 * 2 + f * f + f * g
        # per-object path at g (g_fine at the finest level), batch B*M.
        # With decoder_obj_fine_level="c3" (r5 default) the loop stops at
        # stride 8; stride-4 detail comes from the dynamic-mix head.
        obj_fine_s = {"": 4, "c2": 4, "c3": 8, "c4": 16}[
            cfg.model.decoder_obj_fine_level]
        obj_strides = [s for s in (32, 16, 8, 4) if s >= obj_fine_s]
        for lvl_s in obj_strides:
            gl = g_fine if lvl_s == obj_fine_s else g
            a = area(lvl_s)
            # merge conv out + fuse conv out (write+read each) + mask read
            d += M * a * (gl * dd * 4 + md)
            dw += 9 * gl * (2 * g + 1) + 9 * gl * gl
        if obj_fine_s != 4:
            # dynamic-mix detail head: basis conv at stride 4 (batch B,
            # write+read), per-object stride-8 logits upsampled to /4
            # (read+write), detail einsum reads the basis per frame
            D = cfg.model.decoder_detail_dim
            a4, a8 = area(4), area(obj_fine_s)
            d += a4 * D * dd * 3 + M * a8 * 4 + M * a4 * 4
            k = cfg.model.decoder_detail_basis_k
            dw += k * k * f * D + g_fine * D
        # ConvGRU at /32: 3 convs on concat(x, h) -> g
        d += M * area(32) * g * dd * 8
        dw += 3 * 9 * (2 * g) * g
        stages["decoder"] = d
        stages["weights_decoder"] = dw * dd / B
    else:
        d = 0.0
        for lvl_s in (32, 16, 8, 4):
            d += M * area(lvl_s) * f * dd * 6
        stages["decoder"] = d
        stages["weights_decoder"] = (4 * 9 * f * f * 2) * dd / B

    # ---- logits + resolve -------------------------------------------------
    if cfg.model.logits_res == "mask":
        lg = M * mh * mw * 4
        stages["logits"] = lg * 2                        # write + kernel read
        stages["resolve_labels"] = H * W * 1             # u8 labels write
    else:
        lg = M * H * W * 4
        stages["logits"] = lg * 2
        stages["resolve_labels"] = H * W * 1

    total = float(sum(stages.values()))
    return {"total_mb_per_frame": total / 1e6,
            "stages": {k: round(v / 1e6, 3) for k, v in stages.items()}}
