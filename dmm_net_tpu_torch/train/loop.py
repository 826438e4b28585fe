"""Clip-BPTT training step, optimizer and loop: the counterpart of the JAX
package's train/loop.py.

One train step is one optimizer update on a batch of clips: a Python loop
over the frame axis (the JAX package scans it), the loss on every frame,
and gradients through the matcher into the backbone. With
``matching.use_pallas`` each frame launches the fused matcher kernel (B1)
and its backward (B1') runs through autograd (kernels/matcher.py).

The optimizer is optax's ``chain(clip_by_global_norm(1.0), adamw(warmup
cosine schedule, weight_decay))``, wrapped in ``MultiSteps`` when
``train.grad_accum > 1``: optax's adamw in its own float32 order
(train/adamw.py) under a ``LambdaLR``, with optax's clip (no epsilon,
unlike ``clip_grad_norm_``) and the gradient mean written out.

On a data-parallel mesh (parallel/mesh.py) every rank holds the parameters,
replicated from rank 0, and its own rows of the global batch. The loss is
the rank's share of the global batch's (train/losses.py), train-mode
BatchNorm normalises with the global batch statistics (models/layers.py),
and the gradients are summed over the ranks with one flattened all-reduce
before the clip and the update, so every rank applies the global gradient,
as the JAX package's mesh step does. DistributedDataParallel is not used:
``torch.autograd.grad`` bypasses the hooks it reduces on.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from dmm_net_tpu_torch.config import Config
from dmm_net_tpu_torch.infer.engine import _grid_like
from dmm_net_tpu_torch.models.dmm import DMMNet, FrameState
from dmm_net_tpu_torch.models.layers import BatchNorm
from dmm_net_tpu_torch.ops.resize import resize
from dmm_net_tpu_torch.parallel.mesh import Mesh, all_reduce_sum_, replicate_
from dmm_net_tpu_torch.train.adamw import AdamW
from dmm_net_tpu_torch.train.losses import clip_loss
from dmm_net_tpu_torch.weights import convert_flax_variables, load_flax_variables


def warmup_cosine_lr(cfg: Config, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay) at ``count``
    updates already applied, in float32 as optax evaluates it."""
    t = cfg.train
    f32 = np.float32
    decay_steps = max(t.total_steps, t.warmup_steps + 1)
    if count < t.warmup_steps:
        frac = f32(1) - f32(count) / f32(t.warmup_steps)
        return float(f32(0.0 - t.lr) * frac + f32(t.lr))
    span = decay_steps - t.warmup_steps
    c = f32(min(count - t.warmup_steps, span))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(span), dtype=f32))
    return float(f32(t.lr) * cosine)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in tensors))


class Optimizer:
    """optax ``chain(clip_by_global_norm(1.0), adamw(schedule, wd))`` over
    ``params``: optax's adamw (train/adamw.py: b1 0.9, b2 0.999, eps 1e-8,
    decay on every parameter) with a ``LambdaLR`` giving
    ``warmup_cosine_lr`` at the count of updates applied (so the first
    update has lr 0 under a warmup), after optax's global-norm clip:
    ``g / |g|`` when ``|g| >= 1``, with no epsilon (unlike
    ``clip_grad_norm_``). ``train.grad_accum = k > 1`` makes it
    ``MultiSteps``: the running mean of k gradients, then one clip and one
    update (the calls in between change nothing)."""

    b1, b2, max_norm = 0.9, 0.999, 1.0

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: Config):
        self.params = list(params)
        self.k = max(cfg.train.grad_accum, 1)
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params] if self.k > 1
                    else None)
        self.adamw = AdamW(self.params, lr=1.0, betas=(self.b1, self.b2),
                           eps=1e-8, weight_decay=cfg.train.weight_decay)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda count: warmup_cosine_lr(cfg, count))

    @property
    def count(self) -> int:
        """Updates applied so far."""
        return self.schedule.last_epoch

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            if n < self.k - 1:
                self.mini_step += 1
                return
            grads = self.acc
        g_norm = global_norm(grads)
        keep = g_norm < self.max_norm
        for p, g in zip(self.params, grads):
            p.grad = torch.where(keep, g, g / g_norm * self.max_norm)
        self.adamw.step()
        self.schedule.step()
        self.adamw.zero_grad(set_to_none=True)
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
            self.mini_step = 0

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(),
                "schedule": self.schedule.state_dict(),
                "mini_step": self.mini_step, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        self.schedule.load_state_dict(sd["schedule"])
        self.mini_step = int(sd["mini_step"])
        for d, s in zip(self.acc or [], sd["acc"] or []):
            d.copy_(s)

    @torch.no_grad()
    def load_optax_state(self, opt_state, model: torch.nn.Module) -> None:
        """The state of the JAX package's make_optimizer
        (dmm_net_tpu/train/loop.py:47)
        over ``model``'s parameters, as read from an orbax checkpoint
        (utils/checkpoint.read_orbax_state): ``(clip's EmptyState,
        (ScaleByAdamState(count, mu, nu), add_decayed_weights' EmptyState,
        ScaleByScheduleState(count)))``, the NamedTuples as dicts and the
        empty states as None, inside ``MultiStepsState(mini_step,
        gradient_step, inner_opt_state, acc_grads, skip_state=())`` when
        ``train.grad_accum > 1``. Each moment and the accumulated gradient
        take their parameter's name and layout through the weight bridge;
        Adam's count sets AdamW's step and the LambdaLR's position. A tree
        of another layout is refused at its first differing path, as are
        counts that disagree."""
        params = dict(model.named_parameters())
        if [id(p) for p in params.values()] != [id(p) for p in self.params]:
            raise ValueError("load_optax_state: the model's parameters are "
                             "not this optimizer's")
        inner = opt_state
        if self.k > 1:
            _match_layout(opt_state, {
                "acc_grads": _ANY, "gradient_step": _SCALAR,
                "inner_opt_state": _ANY, "mini_step": _SCALAR, "skip_state": ()},
                "opt_state")
            inner = opt_state["inner_opt_state"]
        where = "opt_state" + ("/inner_opt_state" if self.k > 1 else "")
        _match_layout(inner, (None, ({"count": _SCALAR, "mu": _ANY, "nu": _ANY},
                                     None, {"count": _SCALAR})), where)
        adam, schedule = inner[1][0], inner[1][2]
        count = int(adam["count"])
        counts = {"the schedule's count": int(schedule["count"])}
        if self.k > 1:
            counts["MultiSteps' gradient_step"] = int(opt_state["gradient_step"])
        for name, c in counts.items():
            if c != count:
                raise ValueError(f"{where}: {name} {c} differs from Adam's "
                                 f"count {count}")

        def per_param(tree, name):
            try:
                sd = convert_flax_variables({"params": tree}, model)
            except (KeyError, ValueError) as e:
                raise ValueError(f"{name}: does not match the model's "
                                 f"parameters: {e}") from None
            return [sd[n] for n in params]

        mu = per_param(adam["mu"], f"{where}/1/0/mu")
        nu = per_param(adam["nu"], f"{where}/1/0/nu")
        sd = self.adamw.state_dict()
        sd["state"] = {i: {"step": torch.tensor(float(count)),
                           "exp_avg": m, "exp_avg_sq": v}
                       for i, (m, v) in enumerate(zip(mu, nu))}
        self.adamw.load_state_dict(sd)
        with warnings.catch_warnings():        # the LambdaLR to count (its lr)
            warnings.filterwarnings("ignore", "Detected call of `lr_scheduler")
            self.schedule.last_epoch = count - 1
            self.schedule.step()
        if self.k > 1:
            mini = int(opt_state["mini_step"])
            if not 0 <= mini < self.k:
                raise ValueError(f"opt_state/mini_step {mini} is outside "
                                 f"0..{self.k - 1}")
            self.mini_step = mini
            for a, g in zip(self.acc, per_param(opt_state["acc_grads"],
                                                "opt_state/acc_grads")):
                a.copy_(g)


_ANY = object()          # a layout's subtree checked elsewhere
_SCALAR = object()       # a 0-d tensor


def _match_layout(tree, layout, path: str) -> None:
    """Raise at the first path where ``tree`` differs from ``layout``: dicts
    by their keys, tuples by their length, None for an empty state,
    _SCALAR for a 0-d tensor, _ANY for any subtree."""
    if layout is _ANY:
        return
    if layout is _SCALAR or layout is None:
        ok = (tree is None if layout is None else
              isinstance(tree, torch.Tensor) and tree.ndim == 0)
        if not ok:
            raise ValueError(f"{path}: expected "
                             f"{'an empty state' if layout is None else 'a scalar'}"
                             f", found {type(tree).__name__}")
        return
    if type(tree) is not type(layout) or len(tree) != len(layout):
        raise ValueError(f"{path}: expected a {type(layout).__name__} of "
                         f"{len(layout)}, found {type(tree).__name__}"
                         + (f" of {len(tree)}" if hasattr(tree, "__len__")
                            else ""))
    if isinstance(layout, dict):
        if sorted(tree) != sorted(layout):
            raise ValueError(f"{path}: keys {sorted(tree)}, expected "
                             f"{sorted(layout)}")
        pairs = [(k, tree[k], layout[k]) for k in sorted(layout)]
    else:
        pairs = [(i, t, l) for i, (t, l) in enumerate(zip(tree, layout))]
    for k, t, l in pairs:
        _match_layout(t, l, f"{path}/{k}")


@dataclass
class TrainState:
    """The model (float32 master parameters, BN running statistics as
    buffers), its optimizer and the number of train steps taken."""

    model: DMMNet
    optimizer: Optimizer
    step: int = 0


def create_train_state(cfg: Config, seed: int = 0, variables=None,
                       device=None, mesh: Optional[Mesh] = None) -> TrainState:
    """A training model from ``seed``, or from JAX-package variables
    ({"params", "batch_stats"}) through the weight bridge. Runs on CUDA
    unless ``device`` says otherwise; with ``mesh``, on the rank's device,
    its parameters and buffers broadcast from rank 0 and its BatchNorms
    taking global batch statistics."""
    if mesh is not None:
        device = mesh.device
    model = DMMNet(cfg, device=device, seed=seed, train=True)
    if variables is not None:
        load_flax_variables(model, variables)
    if mesh is not None:
        replicate_(model, mesh)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mesh = mesh
    return TrainState(model=model, optimizer=Optimizer(model.parameters(), cfg))


def load_jax_train_state(state: TrainState, tree) -> TrainState:
    """A TrainState of the JAX package's train.py, as read from its orbax
    checkpoint directory (utils/checkpoint.read_orbax_step(...)["state"]:
    step, params, batch_stats, opt_state), into ``state`` in place: the
    parameters and BN statistics through the weight bridge, the optax
    state into the Optimizer (``Optimizer.load_optax_state``), the step."""
    load_flax_variables(state.model, {"params": tree["params"],
                                      "batch_stats": tree["batch_stats"]})
    state.optimizer.load_optax_state(tree["opt_state"], state.model)
    state.step = int(tree["step"])
    return state


def _discard_bn_batch_stats(model: DMMNet) -> None:
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.batch_stats = None


def _clip_forward(model: DMMNet, batch: Dict[str, torch.Tensor],
                  cfg: Config, mesh: Optional[Mesh] = None):
    """Forward a clip batch; returns (loss, logits (B, T, M, H, W)).

    batch: frames (B, T, H, W, 3), prop_masks (B, T, N, H, W), prop_valid
    (B, T, N), tmpl_masks (B, M, H, W), tmpl_valid (B, M), gt_masks
    (B, T, M, H, W); optional live_from (B, M) (each object's template frame
    in the clip; absent: all 0) and gt_valid (B, T, M) (the loss mask;
    absent: tmpl_valid over T).

    Each object's template features lock in at its live_from frame, pooled
    from the features that frame computes anyway; before it the object's
    row is invalid and, on a gated batch, its template mask is pinned to
    the ground-truth template. With ``cfg.model.train_bn`` on a training
    model, each frame's backbone normalises with its batch statistics and
    the running statistics take one momentum update per frame, applied
    after the frame's forward (not inside it, so that ``cfg.train.remat``'s
    recomputation in the backward cannot apply it twice). With ``mesh``,
    ``batch`` is this rank's rows and the loss its share of the global
    batch's."""
    frames = batch["frames"]
    B, T = frames.shape[:2]
    tmpl_masks = batch["tmpl_masks"]
    tmpl_valid = batch["tmpl_valid"].bool()
    gated = "live_from" in batch
    live_from = (batch["live_from"].long() if gated
                 else torch.zeros(tmpl_valid.shape, dtype=torch.long,
                                  device=frames.device))

    def frame_fn(frame, pmask, pvalid, t, tmpl_state, dec_state, tfeats):
        feats = model.extract_features(frame)
        pooled = model.pool_mask_features(feats, tmpl_masks)
        tfeats = torch.where((live_from == t)[..., None], pooled, tfeats)
        valid_t = tmpl_valid & (t >= live_from)
        out, new_st = model(frame, pmask, pvalid, tfeats, valid_t,
                            FrameState(tmpl_state, dec_state), feats)
        tm = new_st.template_masks
        if gated:
            tm = torch.where(valid_t[..., None, None], tm,
                             _grid_like(tmpl_masks, tm))
        return out.logits, tm, new_st.decoder_state, tfeats

    state = model.init_state(tmpl_masks)
    tm, dec = state.template_masks, state.decoder_state
    tfeats = torch.zeros(tmpl_valid.shape + (cfg.model.feature_dim,),
                         dtype=torch.float32, device=frames.device)
    logits = []
    for t in range(T):
        args = (frames[:, t], batch["prop_masks"][:, t],
                batch["prop_valid"][:, t].bool(), t, tm, dec, tfeats)
        if cfg.train.remat:
            lg, tm, dec, tfeats = torch.utils.checkpoint.checkpoint(
                frame_fn, *args, use_reentrant=False)
        else:
            lg, tm, dec, tfeats = frame_fn(*args)
        model.update_bn_stats()
        logits.append(lg)
    logits = torch.stack(logits, 1)                       # (B, T, M, h, w)
    if tuple(logits.shape[-2:]) != tuple(cfg.model.image_size):
        # mask-grid logits: upsample to the image so the loss is unchanged
        logits = resize(logits, cfg.model.image_size)
    loss_valid = batch.get("gt_valid", tmpl_valid)
    loss = clip_loss(logits, batch["gt_masks"], loss_valid.bool(),
                     bce_weight=cfg.train.loss_bce_weight,
                     iou_weight=cfg.train.loss_iou_weight, mesh=mesh)
    return loss, logits


def make_train_step(cfg: Config, mesh: Optional[Mesh] = None):
    """step(state, batch) -> {"loss", "grad_norm"} (0-d tensors; grad_norm
    is the global norm before clipping), updating ``state`` in place. With
    ``mesh``, ``batch`` is this rank's rows (``parallel.shard_batch``); the
    gradients and the loss shares are summed over the ranks in one
    all-reduce, so both metrics are the global batch's on every rank."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        loss, _ = _clip_forward(model, batch, cfg, mesh)
        params = state.optimizer.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        _discard_bn_batch_stats(model)        # left by remat's recompute
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        if mesh is not None:
            loss = loss.detach().reshape(1)
            all_reduce_sum_(grads + [loss], mesh)
            loss = loss[0]
        g_norm = global_norm(grads)
        state.optimizer.update(grads)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": g_norm.detach()}

    return train_step


def batch_to(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def train_loop(cfg: Config, state: TrainState, batches: Iterable[dict],
               log_every: int = 10, writer=None, checkpointer=None,
               on_step=None, mesh: Optional[Mesh] = None) -> TrainState:
    """Step over ``batches`` (already on the model's device, or numpy),
    logging every ``log_every`` steps to ``writer`` (jsonl) or stdout and
    checkpointing every ``cfg.train.checkpoint_every`` steps. ``on_step``,
    if given, is called with (state, metrics) after every step. With
    ``mesh``, each batch is this rank's rows (``data/pipeline.Prefetcher``
    with the mesh gives them); rank 0 alone logs and saves, and every rank
    waits at a barrier after each save."""
    step_fn = make_train_step(cfg, mesh)
    lead = mesh is None or mesh.rank == 0
    device = state.model.device
    t0 = time.time()
    for i, batch in enumerate(batches):
        metrics = step_fn(state, batch_to(batch, device))
        if on_step is not None:
            on_step(state, metrics)
        if lead and (i + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_sec"] = log_every / (time.time() - t0)
            t0 = time.time()
            if writer is not None:
                writer.write(state.step, m)
            else:
                print(f"step {state.step}: {m}", flush=True)
        if (checkpointer is not None
                and (i + 1) % cfg.train.checkpoint_every == 0):
            if lead:
                checkpointer.save(state)
            if mesh is not None:
                mesh.barrier()
    return state

