#!/usr/bin/env python3
"""Entry points of the PyTorch/CUDA port, the counterpart of the JAX
package's __graft_entry__.py.

entry():             one inference frame step on the flagship model
                     (ResNet-50 DMM-Net, multi-object DAVIS config p3) on
                     the card: B1 for the matcher, B2 for the labels.
dryrun_multichip(n): one data-parallel DMM train step and a sharded
                     run_stream_chunked over n ranks on tiny shapes, with
                     the fused matcher. The reference's only parallelism is
                     data-parallel, as in the JAX package.

    python3 graft_entry_torch.py 2     # dryrun_multichip(2) on the card
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch


def _flagship_config():
    from dmm_net_tpu_torch.config import preset
    return preset("p3_multi_object")


def entry(device="cuda", variables=None):
    """Return (fn, example_args): one inference frame step (backbone ->
    pool -> cost -> matching -> aggregation -> refinement decode -> overlap
    argmax) on the flagship model with the port's seeded weights, or
    ``variables`` ({"params", "batch_stats"} in the JAX package's layout)
    when given. ``fn(frame, prop_masks, prop_valid, tmpl_feats, tmpl_valid,
    state)`` returns (labels, assignment, new_state); new_state has the
    carried state's grid and dtype, so ``fn`` iterates as-is. The example
    arguments are __graft_entry__.entry's, drawn from the same
    ``np.random.RandomState(0)`` in the same order."""
    from dmm_net_tpu_torch import resolve_device
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.models.dmm import init_frame_state

    cfg = _flagship_config()
    dev = resolve_device(device)
    H, W = cfg.model.image_size
    B = 1
    M = cfg.matching.max_templates
    N = cfg.matching.max_proposals
    engine = InferenceEngine(cfg, variables=variables, device=dev, seed=0)

    rng = np.random.RandomState(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    frame = t(rng.rand(B, H, W, 3))
    prop_masks = t(rng.rand(B, N, H, W) > 0.8)
    prop_valid = torch.ones((B, N), dtype=torch.bool, device=dev)
    tmpl_feats = t(rng.randn(B, M, cfg.model.feature_dim))
    tmpl_valid = torch.ones((B, M), dtype=torch.bool, device=dev)
    state = init_frame_state(cfg, t(rng.rand(B, M, H, W) > 0.8))

    @torch.no_grad()
    def fn(frame, prop_masks, prop_valid, tmpl_feats, tmpl_valid, state):
        return engine._frame_step(frame, prop_masks, prop_valid, tmpl_feats,
                                  tmpl_valid, state)

    example_args = (frame, prop_masks, prop_valid, tmpl_feats, tmpl_valid,
                    state)
    return fn, example_args


def _dryrun_config(n: int):
    from dmm_net_tpu_torch.config import (Config, DataConfig, MatchingConfig,
                                          ModelConfig, TrainConfig)
    return Config(
        name="dryrun_multichip",
        model=ModelConfig(backbone="resnet18", backbone_dtype="float32",
                          feature_dim=16, decoder_dim=8, image_size=(64, 64)),
        matching=MatchingConfig(max_templates=4, max_proposals=8,
                                sinkhorn_iters=5, use_pallas=True),
        data=DataConfig(dataset="synthetic", batch_size=n, clip_length=2),
        train=TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10),
    )


def _dryrun_rank(device_type: str) -> dict:
    """One rank of dryrun_multichip: its train step on its rows of the
    global batch (the gradients summed over the ranks), then the sharded
    stream over the whole batch. Returns the loss, the gathered labels'
    shape and this rank's kernel launches."""
    import torch.distributed as dist

    from dmm_net_tpu_torch.data.synthetic import synthetic_clip_batch
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmm_net_tpu_torch.parallel import make_mesh, shard_batch
    from dmm_net_tpu_torch.train.loop import (batch_to, create_train_state,
                                              make_train_step)
    from dmm_net_tpu_torch.weights import to_flax_variables

    mesh = make_mesh(device_type=device_type)
    n = mesh.world
    cfg = _dryrun_config(n)
    batch = synthetic_clip_batch(
        seed=0, batch=n, T=2, H=64, W=64, num_objects=2,
        num_proposals=cfg.matching.max_proposals,
        pad_objects=cfg.matching.max_templates)
    reset_launch_counts()
    state = create_train_state(cfg, seed=0, mesh=mesh)
    step = make_train_step(cfg, mesh)
    loss = float(step(state, batch_to(shard_batch(batch, mesh), mesh.device))["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: non-finite loss {loss}")

    # sharded streaming inference too (each rank runs its rows of the
    # sequence batch on the trained weights; labels gathered to every rank)
    engine = InferenceEngine(cfg, variables=to_flax_variables(state.model),
                             update_templates=True, mesh=mesh)

    def stream(T=3):
        for t in range(T):
            yield {"frame": batch["frames"][:, t % batch["frames"].shape[1]],
                   "prop_masks": batch["prop_masks"][:, 0],
                   "prop_valid": batch["prop_valid"][:, 0]}

    res = engine.run_stream_chunked(stream(), batch["tmpl_masks"],
                                    batch["tmpl_valid"], batch["frames"][:, 0],
                                    chunk=2)
    if res["labels"].shape[1] != n:
        raise RuntimeError(f"dryrun_multichip: labels {res['labels'].shape}, "
                           f"expected {n} sequences")
    return {"rank": mesh.rank, "backend": dist.get_backend(), "loss": loss,
            "labels_shape": tuple(res["labels"].shape),
            "launches": launch_counts()}


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """One data-parallel train step and a sharded stream on ``n_devices``
    ranks (parallel.launch): with CUDA, NCCL when each rank has a card of
    its own and gloo when ranks share one; gloo on the CPU, where the
    kernels' plain versions run. Returns each rank's result."""
    from dmm_net_tpu_torch import resolve_device
    from dmm_net_tpu_torch.parallel import launch

    device_type = resolve_device(device).type
    results = launch(_dryrun_rank, n_devices, device_type, device_type)
    r = results[0]
    print(f"dryrun_multichip({n_devices}): OK, loss={r['loss']:.4f}, "
          f"{r['backend']} over {n_devices} ranks on {device_type}, "
          f"sharded-infer labels {r['labels_shape']}")
    return results


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
