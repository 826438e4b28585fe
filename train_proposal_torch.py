#!/usr/bin/env python3
"""Proposal-detector training CLI of the PyTorch/CUDA port: the counterpart
of train_proposal.py, with its flags, samplers, detector settings
(pre/post-NMS top-n 64/32, 16 detections), held-out AP and metrics lines.

Usage:
  python train_proposal_torch.py [--steps 100] [--image-size 128 128] \
      [--backbone resnet18] [--logdir runs/proposal] [--device cpu] \
      [--batch 2 --data-parallel]

Trains on synthetic detection frames (``--data detection``: COCO-like,
class = shape family) or frames of the synthetic video generator
(``--data video``), with the RPN + box head + mask head losses. The batches
of --distinct-frames frames are made once, put on the device and cycled.
--eval-images N scores box and mask AP (COCO protocol,
eval/detection_ap.py) on N held-out frames (seeds 10000 and up) after
training. --save writes the trained variables as the JAX package's
{"params", "batch_stats"} flax msgpack, which tools/extract_proposals.py
and tools/extract_proposals_torch.py --params read; --init reads one.
Without --init the weights are the port's random init from --seed (with
--steps 0 --save that file is the initial state, and train_proposal.py
--init trains the JAX package from the same one). Runs on CUDA unless
--device says otherwise.

--data-parallel trains on a mesh of one rank per visible card (on the
CPU, of the ranks of an initialised group; --batch must divide over
them): each rank takes its rows of every batch and the gradients are summed
over the ranks (train/proposal_loop.py). Under torchrun's environment the
script joins torchrun's group; otherwise it starts its ranks itself. Rank
0 alone logs, scores and writes --save.
"""

import argparse
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def make_sampler(data: str, H: int, W: int, G: int, num_classes: int):
    """seed -> one frame as train_proposal.py samples it, in the dict of
    ``synthetic_detection_frame``: image (H, W, 3), boxes (G, 4), labels
    (G,), valid (G,), masks (G, H, W), numpy."""
    import numpy as np

    from dmm_net_tpu_torch.data.synthetic import (synthetic_detection_frame,
                                                  synthetic_sequence)

    def sample(seed):
        if data == "detection":
            return synthetic_detection_frame(seed=seed, H=H, W=W, max_objects=G,
                                             num_classes=num_classes)
        seq = synthetic_sequence(seed=seed, T=1, H=H, W=W,
                                 num_objects=min(2, G), num_proposals=4)
        masks = seq["gt_masks"][0]                      # (m, H, W)
        boxes = np.zeros((G, 4), np.float32)
        labels = np.zeros((G,), np.int32)
        valid = np.zeros((G,), bool)
        gt_masks = np.zeros((G, H, W), np.float32)
        for i in range(masks.shape[0]):
            ys, xs = np.nonzero(masks[i] > 0.5)
            if ys.size == 0:
                continue
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
            # class = shape family, as in the detection set
            # (video {0: rect, 1: circle} -> classes {1: rect, 2: ellipse})
            labels[i] = 1 + (int(seq["shapes"][i]) % (num_classes - 1))
            valid[i] = True
            gt_masks[i] = masks[i]
        return {"image": seq["frames"][0].astype(np.float32), "boxes": boxes,
                "labels": labels, "valid": valid, "masks": gt_masks}

    return sample


def evaluate(model, sample, n: int):
    """Box and mask AP of ``model`` on held-out seeds 10000..10000+n."""
    import torch

    from dmm_net_tpu_torch.eval.detection_ap import evaluate_detections
    from dmm_net_tpu_torch.models.proposal.maskrcnn import paste_masks

    H, W = model.image_size
    preds, gts = [], []
    for s in range(10_000, 10_000 + n):
        f = sample(s)
        x = torch.from_numpy(f["image"][None]).to(model.device).permute(0, 3, 1, 2)
        out = model(x)
        full = paste_masks(out["masks"], out["boxes"], out["valid"], (H, W))
        preds.append({k: out[k].cpu().numpy()
                      for k in ("boxes", "scores", "classes", "valid")})
        preds[-1]["masks"] = full.cpu().numpy()
        gts.append({k: f[k] for k in ("boxes", "labels", "valid", "masks")})
    return (evaluate_detections(preds, gts, iou_type="box"),
            evaluate_detections(preds, gts, iou_type="mask"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=1,
                    help="images per step (the mean of per-image losses)")
    ap.add_argument("--data-parallel", action="store_true",
                    help="split each batch over one rank per visible card")
    ap.add_argument("--image-size", type=int, nargs=2, default=(128, 128))
    ap.add_argument("--backbone", default="resnet18")
    ap.add_argument("--num-classes", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--logdir", default="runs/proposal")
    ap.add_argument("--max-objects", type=int, default=4)
    ap.add_argument("--data", default="detection",
                    choices=["detection", "video"],
                    help="'detection' = COCO-like synthetic frames; 'video' "
                    "= frames from the synthetic video generator")
    ap.add_argument("--distinct-frames", type=int, default=64)
    ap.add_argument("--eval-images", type=int, default=0,
                    help="after training, score box/mask AP on this many "
                    "held-out frames")
    ap.add_argument("--save", default=None,
                    help="write the trained variables as flax msgpack (read "
                    "by both packages' tools/extract_proposals*.py --params)")
    ap.add_argument("--init", default=None,
                    help="start from a saved msgpack (same format as --save)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random initial weights (without --init)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from dmm_net_tpu_torch.parallel import (launch, make_mesh, replicate_,
                                            shard_batch, visible_ranks)

    mesh = None
    if args.data_parallel:
        world = visible_ranks(args.device)
        if args.batch % world:
            raise SystemExit(f"--batch {args.batch} must divide over {world} "
                             "data-parallel ranks")
        device_type = torch.device(args.device).type
        if not dist.is_initialized():
            return launch(_rank_main, world, device_type, argv)[0]
        mesh = make_mesh(data=world, device_type=device_type)
    lead = mesh is None or mesh.rank == 0

    from dmm_net_tpu_torch.models.proposal.maskrcnn import MaskRCNN
    from dmm_net_tpu_torch.train.proposal_loop import (make_proposal_optimizer,
                                                       make_proposal_train_step,
                                                       proposal_batch_to,
                                                       stack_detection_frames)
    from dmm_net_tpu_torch.utils.checkpoint import (msgpack_restore,
                                                    msgpack_serialize)
    from dmm_net_tpu_torch.utils.logging import MetricsWriter
    from dmm_net_tpu_torch.weights import load_flax_variables, to_flax_variables

    logging.basicConfig(format="%(asctime)s train_proposal_torch %(levelname)s: "
                        "%(message)s", level=logging.INFO)
    log = logging.getLogger("train_proposal_torch")
    H, W = args.image_size
    G = args.max_objects
    sample = make_sampler(args.data, H, W, G, args.num_classes)

    model = MaskRCNN(image_size=(H, W), backbone_name=args.backbone,
                     num_classes=args.num_classes, pre_nms_top_n=64,
                     post_nms_top_n=32, max_detections=16,
                     device=args.device if mesh is None else mesh.device,
                     seed=args.seed)
    if args.init:
        with open(args.init, "rb") as f:
            load_flax_variables(model, msgpack_restore(f.read()))
        log.info("initialized from %s", args.init)
    if mesh is not None:
        replicate_(model, mesh)
        log.info("data-parallel mesh: %s, rank %d", mesh.shape, mesh.rank)
    model.trainable_()
    optimizer = make_proposal_optimizer(model, args.lr)
    step = make_proposal_train_step(model, optimizer, mesh=mesh)
    writer = MetricsWriter(args.logdir) if lead else None
    B = args.batch

    def rows(batch):
        return batch if mesh is None else shard_batch(batch, mesh)

    n_batches = max(args.distinct_frames // B, 1)
    batches = [proposal_batch_to(rows(stack_detection_frames(
        [sample(bi * B + j) for j in range(B)])), model.device)
        for bi in range(n_batches)]
    history, step_times = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        out = step(batches[i % n_batches])
        m = {k: float(v) for k, v in out.items()}       # waits for the step
        m["total"] = m.pop("loss")
        step_times.append(time.perf_counter())
        history.append({"step": i + 1, **m})
        if i == 0:
            log.info("first step: %.1fs", step_times[0] - t0)
        if lead and ((i + 1) % 10 == 0 or i == 0):
            logged = {k: v for k, v in m.items() if k != "grad_norm"}
            writer.write(i + 1, logged)
            log.info("step %d: %s", i + 1,
                     {k: round(v, 4) for k, v in logged.items()})
    seconds = time.perf_counter() - t0
    if args.steps > 1:
        log.info("ms per step (after the first): %.2f",
                 1e3 * (step_times[-1] - step_times[0]) / (args.steps - 1))
    result = {"history": history, "step_times": step_times, "seconds": seconds,
              "model": model}
    if lead and args.eval_images:
        box_ap, mask_ap = evaluate(model, sample, args.eval_images)
        log.info("held-out box AP: %s", {k: round(v, 4) for k, v in box_ap.items()})
        log.info("held-out mask AP: %s", {k: round(v, 4) for k, v in mask_ap.items()})
        writer.write(args.steps, {f"box_{k}": v for k, v in box_ap.items()})
        writer.write(args.steps, {f"mask_{k}": v for k, v in mask_ap.items()})
        result.update(box_ap=box_ap, mask_ap=mask_ap)
    if writer is not None:
        writer.close()

    if lead and args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        with open(args.save, "wb") as f:
            f.write(msgpack_serialize(to_flax_variables(model)))
        log.info("saved variables to %s", args.save)
    if mesh is not None:
        mesh.barrier()
    from dmm_net_tpu_torch.kernels import _build
    report = _build.cuda_report(model.device)
    if lead and report:
        print(report, flush=True)
    log.info("done")
    return result


def _rank_main(argv):
    """main on one rank started by ``launch``: its result without the
    model."""
    out = main(argv)
    out.pop("model")
    return out


if __name__ == "__main__":
    main()
