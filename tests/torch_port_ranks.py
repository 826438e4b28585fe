"""Functions that run on the ranks the data-parallel tests spawn
(``dmm_net_tpu_torch.parallel.launch``, gloo on the CPU).

They live in this module, which imports only torch and the port, because
the ``spawn`` start method imports a spawned function's module afresh in
each rank: from the test modules, that would import JAX in every rank.
Each returns numpy arrays and plain values, which pickle back to the test.
"""

from __future__ import annotations

import importlib
import sys

import torch

from chip_smoke import KeepGrads
from dmm_net_tpu_torch.config import config_from_dict
from dmm_net_tpu_torch.parallel import (all_reduce_sum_, make_mesh,
                                        shard_batch)


def _mesh(device_type: str = "cpu"):
    torch.set_num_threads(2)
    return make_mesh(device_type=device_type)


def dmm_steps(cfg_dict: dict, variables, batch: dict, steps: int,
              device_type: str = "cpu") -> dict:
    """``steps`` DMM train steps on this rank's rows of ``batch``: each
    step's loss and grad_norm, the first step's reduced gradients (as
    ``{name: array}``) and BN running statistics, and the parameters after
    the last step; and, on the
    frozen-BN configurations, the unreduced local gradient and the loss a
    per-rank masked mean would give (each rank's own mean, averaged over
    the ranks), to show what the reduction and the global normalisation
    change. ``variables`` None: the seeded init (seed 0)."""
    from dmm_net_tpu_torch.train.loop import (_clip_forward, batch_to,
                                              create_train_state,
                                              make_train_step)
    from dmm_net_tpu_torch.train.losses import clip_loss

    mesh = _mesh(device_type)
    cfg = config_from_dict(cfg_dict)
    local = batch_to(shard_batch(batch, mesh), mesh.device)
    out = {"rank": mesh.rank, "valid_count": int(batch["tmpl_valid"][
        mesh.rows(batch["tmpl_valid"].shape[0])].sum())}
    if not cfg.model.train_bn:
        probe = create_train_state(cfg, variables=variables, mesh=mesh)
        loss, logits = _clip_forward(probe.model, local, cfg, mesh)
        names, params = zip(*probe.model.named_parameters())
        g_local = torch.autograd.grad(loss, params, allow_unused=True)
        g_local = [torch.zeros_like(p) if g is None else g
                   for g, p in zip(g_local, params)]
        g_sum = [g.clone() for g in g_local]
        all_reduce_sum_(g_sum, mesh)
        num = sum(float((a - b).square().sum()) for a, b in zip(g_local, g_sum))
        den = sum(float(b.square().sum()) for b in g_sum)
        out["local_vs_reduced_rel"] = (num / den) ** 0.5
        own = clip_loss(logits, local["gt_masks"],
                        local.get("gt_valid", local["tmpl_valid"]).bool(),
                        bce_weight=cfg.train.loss_bce_weight,
                        iou_weight=cfg.train.loss_iou_weight).detach()
        all_reduce_sum_([own], mesh)
        out["per_rank_mean_loss"] = float(own) / mesh.world
    state = create_train_state(cfg, variables=variables, mesh=mesh)
    step = make_train_step(cfg, mesh)
    grads = {}
    params = dict(state.model.named_parameters())

    def keep_first_grads(update):
        def wrapped(gs):
            if not grads:
                grads.update({n: g.detach().cpu().numpy().copy()
                              for n, g in zip(params, gs)})
            return update(gs)
        return wrapped

    state.optimizer.update = keep_first_grads(state.optimizer.update)
    out["loss"], out["grad_norm"] = [], []
    for i in range(steps):
        m = step(state, local)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            out["bn_stats_1"] = {
                k: v.detach().cpu().numpy().copy()
                for k, v in state.model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}
    out["grads"] = grads
    out["params"] = {n: p.detach().cpu().numpy().copy()
                     for n, p in params.items()}
    return out


def engine_run(cfg_dict: dict, variables, items: list, tmpl_masks,
               tmpl_valid, first_frame, chunk: int,
               device_type: str = "cpu", full_grid=None) -> dict:
    """InferenceEngine(mesh=...).run_stream_chunked on the whole batch
    (every rank passes all of it), and its refusal of a batch of 3, which
    does not divide over 2 ranks; with ``full_grid`` (frames, prop_masks,
    prop_valid, tmpl_masks, tmpl_valid, chunk), run_sequence_chunked on it
    too. ``variables`` None: the seeded init."""
    from dmm_net_tpu_torch.infer.engine import InferenceEngine

    mesh = _mesh(device_type)
    cfg = config_from_dict(cfg_dict)
    engine = InferenceEngine(cfg, variables=variables, mesh=mesh)
    out = {"stream": engine.run_stream_chunked(iter(items), tmpl_masks,
                                               tmpl_valid, first_frame,
                                               chunk=chunk)}
    try:
        engine.run_stream_chunked(iter(items), tmpl_masks[:3],
                                  tmpl_valid[:3], first_frame[:3], chunk=chunk)
    except ValueError as e:
        out["refusal"] = str(e)
    if full_grid is not None:
        *arrays, k = full_grid
        out["chunked"] = engine.run_sequence_chunked(*arrays, chunk=k)
    return out


def detector_grads(kwargs: dict, variables, batch: dict) -> dict:
    """The detector train step's loss, parts and reduced gradients (the
    port's parameter names) on this rank's rows of ``batch``."""
    from dmm_net_tpu_torch.models.proposal import MaskRCNN
    from dmm_net_tpu_torch.parallel import replicate_
    from dmm_net_tpu_torch.train.proposal_loop import (make_proposal_train_step,
                                                       proposal_batch_to)
    from dmm_net_tpu_torch.weights import load_flax_variables

    mesh = _mesh()
    model = MaskRCNN(**kwargs, device=mesh.device)
    load_flax_variables(model, variables)
    replicate_(model, mesh).trainable_()
    opt = KeepGrads(model.parameters())
    step = make_proposal_train_step(model, opt, mesh=mesh)
    m = step(proposal_batch_to(shard_batch(batch, mesh), mesh.device))
    names = [n for n, _ in model.named_parameters()]
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: g.numpy() for n, g in zip(names, opt.grads)}}


def cli_runs(root: str, script: str, runs: list, pil: bool = False) -> list:
    """``main(argv)`` of a top-level CLI script (infer_torch, train_torch,
    train_proposal_torch) for each argv of ``runs`` in turn, inside this
    rank's group; results without their models, and each rank's parameter
    checksum after each run where the CLI returns a model. ``pil``: the
    port's readers decode with PIL in this rank (a parent's pin does not
    reach a spawned rank)."""
    if root not in sys.path:
        sys.path.insert(0, root)
    torch.set_num_threads(2)
    if pil:
        from dmm_net_tpu_torch.data import native_loader
        native_loader._TRIED, native_loader._LIB = True, None
    cli = importlib.import_module(script)
    outs = []
    for argv in runs:
        r = cli.main(argv)
        if isinstance(r, dict):
            model = r.pop("model", None)
            state = r.pop("state", None)
            if state is not None:
                model = state.model
            if model is not None:
                r["checksum"] = float(sum(t.double().sum() for t in
                                          model.state_dict().values()))
        outs.append(r)
    return outs
