#!/usr/bin/env python3
"""Training CLI of the PyTorch/CUDA port (dmm_net_tpu_torch): the
counterpart of train.py.

Usage:
  python train_torch.py --preset p5_train \
      --set matching.use_pallas=true data.dataset=davis data.root=/data/DAVIS \
      [--steps 1000] [--resume] [--logdir runs/x] [--device cpu] \
      [--data-parallel N]

Builds the clip stream (synthetic, DAVIS or YouTube-VOS), augments each
batch and stages it on the device in data/pipeline.Prefetcher's loader
thread, initialises the model from ``train.seed`` or resumes from the
latest checkpoint under <logdir>/ckpt, and runs the clip-BPTT train loop
with jsonl metrics (<logdir>/metrics.jsonl) and checkpoints every
``train.checkpoint_every`` steps and at the end. A resumed run offsets the
data seed by its step, as train.py does, so it sees the batches an
uninterrupted run would have seen. Runs on CUDA unless --device says
otherwise.

--resume also continues a run of the JAX package's train.py: when
<logdir>/ckpt holds its orbax steps, the latest one's step, parameters, BN
statistics and optax state (Adam's moments and count, the schedule's
position, MultiSteps' accumulation under train.grad_accum > 1) are
restored (train/loop.load_jax_train_state), and the port writes its own
checkpoints to <logdir>/ckpt_torch, from which a later --resume continues.
The config comes from --preset / --set, as for train.py.

--data-parallel N trains on a mesh of N ranks (0: one per visible card;
a mesh only when N > 1; data.batch_size must divide over N). Every rank
builds the same global batches and stages its own rows, and the gradients
are summed over the ranks (train/loop.py). Under torchrun's environment
the script joins torchrun's group; otherwise it starts N processes itself
(nccl when each rank has a card of its own, gloo on the CPU or when ranks
share a card). Rank 0 alone writes the metrics and the checkpoints; every
rank restores on --resume.
"""

import argparse
import itertools
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _clip_stream(cfg, steps: int, start_step: int):
    """The training batches of steps start_step..steps-1 (numpy dicts)."""
    import numpy as np

    H, W = cfg.model.image_size
    kw = dict(image_size=cfg.model.image_size,
              proposal_dir=cfg.data.proposal_dir or None,
              max_objects=cfg.matching.max_templates,
              max_proposals=cfg.matching.max_proposals)
    if cfg.data.dataset == "synthetic":
        from dmm_net_tpu_torch.data.synthetic import synthetic_clip_batch
        return ({k: np.asarray(v) for k, v in synthetic_clip_batch(
            seed=i, batch=cfg.data.batch_size, T=cfg.data.clip_length, H=H,
            W=W, num_objects=2, num_proposals=cfg.matching.max_proposals,
            pad_objects=cfg.matching.max_templates).items()}
            for i in range(start_step, steps))
    if cfg.data.dataset == "davis":
        from dmm_net_tpu_torch.data.davis import DavisDataset
        ds = DavisDataset(cfg.data.root, split="train", **kw)
        if not ds.sequences:
            raise SystemExit(f"no DAVIS data under {cfg.data.root}")
    elif cfg.data.dataset == "ytvos":
        from dmm_net_tpu_torch.data.ytvos import YTVOSDataset
        ds = YTVOSDataset(cfg.data.root, split="train", **kw)
        if not ds.videos:
            raise SystemExit(f"no YouTube-VOS data under {cfg.data.root}")
    else:
        raise SystemExit(f"unknown dataset {cfg.data.dataset!r}")
    gen = ds.clip_batches(cfg.data.batch_size, cfg.data.clip_length,
                          seed=cfg.train.seed + start_step)
    return itertools.islice(gen, max(steps - start_step, 0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="p5_train")
    ap.add_argument("--set", nargs="*", default=[],
                    help="dot-path overrides, e.g. train.lr=3e-4")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--logdir", default="runs/default")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="ranks on the data axis (0 = one per visible card; "
                    "a mesh only above 1)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.data.augment import augment_batch
    from dmm_net_tpu_torch.data.pipeline import Prefetcher
    from dmm_net_tpu_torch.parallel import launch, make_mesh, visible_ranks
    from dmm_net_tpu_torch.train.loop import (create_train_state,
                                              load_jax_train_state, train_loop)
    from dmm_net_tpu_torch.utils.checkpoint import (Checkpointer,
                                                    checkpoint_kind,
                                                    latest_orbax_step,
                                                    read_orbax_step)
    from dmm_net_tpu_torch.utils.cli import parse_overrides
    from dmm_net_tpu_torch.utils.logging import MetricsWriter

    cfg = preset(args.preset).override(**parse_overrides(getattr(args, "set")))
    device_type = torch.device(args.device).type
    n_data = args.data_parallel or visible_ranks(args.device)
    mesh = None
    if n_data > 1:
        if cfg.data.batch_size % n_data:
            raise SystemExit(f"data.batch_size {cfg.data.batch_size} must "
                             f"divide over {n_data} data-parallel ranks")
        if not dist.is_initialized():
            return launch(_rank_main, n_data, device_type, argv)[0]
        mesh = make_mesh(data=n_data, device_type=device_type)
    lead = mesh is None or mesh.rank == 0

    logging.basicConfig(format="%(asctime)s train_torch %(levelname)s: "
                        "%(message)s", level=logging.INFO)
    log = logging.getLogger("train_torch")
    steps = args.steps or cfg.train.total_steps

    # the resume step fixes the stream's position before the stream is built;
    # train.py's orbax steps in <logdir>/ckpt resume the port, which keeps
    # its own checkpoints beside them, in <logdir>/ckpt_torch
    jax_dir = os.path.join(args.logdir, "ckpt")
    try:
        orbax = checkpoint_kind(jax_dir) == "orbax"
    except ValueError as e:
        raise SystemExit(str(e))
    ckpt = Checkpointer(os.path.join(args.logdir, "ckpt_torch") if orbax
                        else jax_dir)
    start_step, jax_step = 0, None
    if args.resume and ckpt.latest_step() is not None:
        start_step = int(ckpt.latest_step())
    elif args.resume and orbax:
        start_step = jax_step = latest_orbax_step(jax_dir)
    if start_step >= steps:
        raise SystemExit(f"nothing to do: resumed at step {start_step} >= "
                         f"--steps {steps}")
    stream = _clip_stream(cfg, steps, start_step)

    state = create_train_state(cfg, seed=cfg.train.seed, device=args.device,
                               mesh=mesh)
    if jax_step is not None:
        load_jax_train_state(state, read_orbax_step(jax_dir, jax_step)["state"])
        log.info("resumed at step %d from train.py's orbax checkpoint %s",
                 state.step, jax_dir)
    elif start_step:
        ckpt.restore(state)
        log.info("resumed at step %d", state.step)
    log.info("config %s, steps %d..%d on %s%s", cfg.name, start_step, steps,
             state.model.device, "" if mesh is None else
             f", rank {mesh.rank} of {mesh.world}")

    if cfg.data.augment:
        stream = ({"__seed": i, **b}
                  for i, b in enumerate(stream, start=start_step))

        def load(b):
            seed = b.pop("__seed")
            return augment_batch(b, seed=seed)
    else:
        def load(b):
            return b

    staged = Prefetcher(stream, load, depth=cfg.data.prefetch_depth,
                        device=state.model.device, mesh=mesh)
    history = []

    def on_step(st, metrics):
        m = {k: float(v) for k, v in metrics.items()}   # waits for the step
        m["time"] = time.perf_counter()
        history.append(m)

    writer = MetricsWriter(args.logdir) if lead else None
    t0 = time.perf_counter()
    state = train_loop(cfg, state, staged, writer=writer, checkpointer=ckpt,
                       on_step=on_step, mesh=mesh)
    seconds = time.perf_counter() - t0
    path = ckpt.save(state) if lead else ckpt.path(state.step)
    if mesh is not None:
        mesh.barrier()
    if writer is not None:
        writer.close()
    log.info("done at step %d (%.1f s); checkpoint %s", state.step, seconds,
             path)
    return {"step": state.step, "history": history, "seconds": seconds,
            "checkpoint": path, "state": state}


def _rank_main(argv):
    """main on one rank started by ``launch``: its result without the
    TrainState, which does not pickle."""
    out = main(argv)
    out.pop("state")
    return out


if __name__ == "__main__":
    main()
