#!/usr/bin/env python3
"""The matching layer alone (acceptance configuration #1, with
p1_matcher_only's solver settings) on precomputed backbone features and
masks of one clip, batch 1: the counterpart of examples/matcher_only.py, with the matcher on
B1 (kernels/matcher.fused_pool_cost_match: mask pooling, the IoU + cosine
cost and Sinkhorn in one kernel on the card; its plain version on the CPU).

Builds a fixtures file on its first run: the c4 features of the port's
ResNet-50 (float32, seeded random weights) on a synthetic clip of 8 frames
at 128x128 with 3 objects and 16 proposals, the stand-in for a cached
DAVIS clip. Then runs only the matcher, frame by frame, with the template
masks following the matched proposals, and reports the assignment accuracy
(a pick counts when it is the planted proposal or one whose mask has IoU
>= 0.7 with it) and the time per frame; fails below 0.9.

Usage: python examples/matcher_only_torch.py [--fixtures PATH] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def build_fixtures(path: str, device, T=8, H=128, W=128):
    """Pool per-mask features with the port's ResNet-50 once; cache to npz:
    c4 maps flattened (T, P, D), the masks, validity and the planted
    assignment."""
    import torch

    from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
    from dmm_net_tpu_torch.models.layers import init_random
    from dmm_net_tpu_torch.models.resnet import backbone_by_name

    seq = synthetic_sequence(seed=42, T=T, H=H, W=W, num_objects=3,
                             num_proposals=16)
    net = backbone_by_name("resnet50", dtype=torch.float32)
    init_random(net, torch.Generator().manual_seed(0))
    net = net.to(device).eval()
    with torch.no_grad():
        x = torch.from_numpy(seq["frames"]).to(device).permute(0, 3, 1, 2)
        c4 = net(x)["c4"]                                  # (T, D, h, w)
    feats = c4.permute(0, 2, 3, 1).reshape(T, -1, c4.shape[1])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path, feats=feats.cpu().numpy(), feat_hw=np.asarray(c4.shape[2:]),
        prop_masks=seq["prop_masks"], tmpl_masks=seq["tmpl_masks"],
        prop_valid=seq["prop_valid"], gt_assignment=seq["gt_assignment"])
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixtures", default="results/matcher_fixtures_torch.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from dmm_net_tpu_torch import resolve_device
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.kernels.matcher import fused_pool_cost_match
    from dmm_net_tpu_torch.ops.matching import hard_assignment
    from dmm_net_tpu_torch.ops.resize import resize
    from dmm_net_tpu_torch.ops.roi_pool import mask_avg_pool

    device = resolve_device(args.device)
    if not os.path.exists(args.fixtures):
        print("building fixtures (one-time ResNet-50 feature extraction)...")
        build_fixtures(args.fixtures, device)

    cfg = preset("p1_matcher_only")
    fx = np.load(args.fixtures)
    T, P, D = fx["feats"].shape
    fh, fw = (int(v) for v in fx["feat_hw"])
    N = fx["prop_masks"].shape[1]
    M = fx["tmpl_masks"].shape[0]
    mh, mw = cfg.cost.mask_size

    def dev(x):
        return torch.as_tensor(x).to(device)

    feats = dev(fx["feats"]).float()
    # template features pooled from frame 0, as the engine pools them
    tmpl_feats = mask_avg_pool(feats[0].reshape(fh, fw, D),
                               dev(fx["tmpl_masks"]))[None].contiguous()
    tmpl_m = resize(dev(fx["tmpl_masks"]).float(), (mh, mw)).reshape(1, M, -1)
    rows = torch.ones((1, M), dtype=torch.bool, device=device)
    correct = total = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for t in range(T):
        pm = dev(fx["prop_masks"][t]).float()
        cols = dev(fx["prop_valid"][t])[None]
        pm_cost = resize(pm, (mh, mw)).reshape(1, N, -1).contiguous()
        # iou_weight 0.5 (not the preset's 0.3), as the JAX example: the
        # backbone is untrained, so its cosine term is weak
        X = fused_pool_cost_match(
            feats[t][None].contiguous(),
            resize(pm, (fh, fw)).reshape(1, N, -1).contiguous(),
            tmpl_m.contiguous(), pm_cost, tmpl_feats, rows, cols,
            epsilon=cfg.matching.epsilon, iters=cfg.matching.sinkhorn_iters,
            iou_weight=0.5)
        h = hard_assignment(X, rows, cols)[0].cpu().numpy()
        masks = fx["prop_masks"][t] > 0.5
        for i in range(M):
            gt_j = fx["gt_assignment"][t][i]
            inter = (masks[h[i]] & masks[gt_j]).sum()
            union = (masks[h[i]] | masks[gt_j]).sum()
            if h[i] == gt_j or (union and inter / union >= 0.7):
                correct += 1
        total += M
        # the template masks follow the matched proposals (masks track,
        # features stay those of frame 1)
        tmpl_m = (X @ pm_cost).clamp(0.0, 1.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    acc = correct / total
    print(f"device: {device}")
    print(f"assignment accuracy: {correct}/{total} = {acc:.3f}")
    print(f"matcher wall time: {dt / T * 1e3:.2f} ms/frame")
    if acc <= 0.9:
        raise SystemExit(f"matcher accuracy regression: {acc:.3f} <= 0.9")
    print("OK")
    return {"accuracy": acc, "ms_per_frame": dt / T * 1e3}


if __name__ == "__main__":
    main()
