"""B1' (the backward of the fused pool + cost + Sinkhorn kernel), the
losses and the optimizer of the port's training path against the JAX
package on the same seeded inputs.

On the CPU the port's B1 forward is its plain version and its backward
autograd through that plain version; the JAX side runs
``fused_pool_cost_match`` in interpret mode, whose custom VJP
differentiates the jnp reference."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dmm_net_tpu.config import (Config, DataConfig, MatchingConfig,
                                ModelConfig, TrainConfig)
from dmm_net_tpu.data.synthetic import synthetic_clip_batch
from dmm_net_tpu.kernels.matcher import fused_pool_cost_match as jax_fpcm
from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
from dmm_net_tpu.models.dmm import init_frame_state as jax_init_state
from dmm_net_tpu.train import losses as jax_losses
from dmm_net_tpu.train.loop import make_optimizer
from dmm_net_tpu_torch.config import config_from_dict
from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
from dmm_net_tpu_torch.kernels.matcher import fused_pool_cost_match
from dmm_net_tpu_torch.models.dmm import DMMNet
from dmm_net_tpu_torch.train import losses
from dmm_net_tpu_torch.train.loop import Optimizer
from dmm_net_tpu_torch.weights import convert_flax_variables, load_flax_variables
from test_torch_port_engine import _randomize
from test_torch_port_train_step import few_threads  # noqa: F401


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


# ---------------------------------------------------------------------------
# B1': gradients of the fused matcher
# ---------------------------------------------------------------------------

def _problem(seed=0, B=2, M=4, N=16, P=64, D=32, Pc=256):
    """The shapes of tests/test_fused_pool_match.py, with soft cost masks so
    that every mask input has a nonzero gradient."""
    rng = np.random.RandomState(seed)
    emb = rng.randn(B, P, D).astype(np.float32)
    pm_pool = (rng.rand(B, N, P) > 0.6).astype(np.float32)
    tm_cost = rng.rand(B, M, Pc).astype(np.float32)
    pm_cost = rng.rand(B, N, Pc).astype(np.float32)
    tf = rng.randn(B, M, D).astype(np.float32)
    rm = np.zeros((B, M), bool)
    rm[:, :3] = True
    cm = np.zeros((B, N), bool)
    cm[:, :10] = True
    W = rng.randn(B, M, N).astype(np.float32)
    return (emb, pm_pool, tm_cost, pm_cost, tf, rm, cm), W


@pytest.mark.parametrize("epsilon,eps_init", [(0.1, None), (0.03, 0.2)])
def test_b1_backward_matches_jax_fused_grads(epsilon, eps_init):
    (emb, ppool, tm, pm, tf, rm, cm), W = _problem()

    def jax_loss(*floats):
        X = jax_fpcm(*floats, jnp.asarray(rm), jnp.asarray(cm),
                     epsilon=epsilon, iters=30, epsilon_init=eps_init,
                     interpret=True)
        return jnp.sum(X * W)

    floats = (emb, ppool, tm, pm, tf)
    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, floats))

    xs = [torch.from_numpy(a).requires_grad_(True) for a in floats]
    reset_launch_counts()
    X = fused_pool_cost_match(*xs, torch.from_numpy(rm), torch.from_numpy(cm),
                              epsilon=epsilon, iters=30, epsilon_init=eps_init)
    assert X.grad_fn is not None
    (X * torch.from_numpy(W)).sum().backward()
    # on the CPU the plain version runs: no kernel launch is counted
    assert launch_counts().get("fused_pool_cost_match", 0) == 0
    for name, x, w in zip(("emb", "prop_masks_pool", "tmpl_masks_cost",
                           "prop_masks_cost", "tmpl_feats"), xs, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(x.grad.numpy(), w, atol=1e-5, err_msg=name)


def test_b1_forward_without_grad_has_no_graph():
    (emb, ppool, tm, pm, tf, rm, cm), _ = _problem(1)
    X = fused_pool_cost_match(*map(torch.from_numpy,
                                   (emb, ppool, tm, pm, tf, rm, cm)))
    assert X.grad_fn is None and not X.requires_grad


def _frame_inputs(cfg):
    b = synthetic_clip_batch(seed=0, batch=1, T=1, H=64, W=64, num_objects=2,
                             num_proposals=8, pad_objects=4)
    tf = np.random.RandomState(3).randn(1, 4, 16).astype(np.float32)
    return (b["frames"][:, 0], b["prop_masks"][:, 0], b["prop_valid"][:, 0],
            tf, b["tmpl_valid"], b["tmpl_masks"])


def _tiny_cfg(implicit):
    return Config(
        model=ModelConfig(backbone="resnet18", backbone_dtype="float32",
                          feature_dim=16, decoder_dim=8, image_size=(64, 64)),
        matching=MatchingConfig(max_templates=4, max_proposals=8,
                                sinkhorn_iters=10, use_pallas=True,
                                implicit_grad=implicit))


@pytest.fixture(scope="module")
def fused_frame_grads():
    """JAX grads of sum(X * W) for one fused frame step w.r.t. every
    parameter, with matching.implicit_grad False and True."""
    cfg0 = _tiny_cfg(False)
    frame, pmask, pvalid, tf, tvalid, tmasks = _frame_inputs(cfg0)
    args = (jnp.asarray(frame), jnp.asarray(pmask), jnp.asarray(pvalid),
            jnp.asarray(tf), jnp.asarray(tvalid),
            jax_init_state(cfg0, jnp.asarray(tmasks)))
    shapes = jax.eval_shape(JaxDMMNet(cfg0).init, jax.random.PRNGKey(0), *args)
    variables = _randomize(shapes, 5)
    W = np.random.RandomState(4).randn(1, 4, 8).astype(np.float32)
    out = {}
    for implicit in (False, True):
        model = JaxDMMNet(_tiny_cfg(implicit))

        def loss(params):
            o, _ = model.apply({**variables, "params": params}, *args)
            return jnp.sum(o.assignment * W)

        out[implicit] = jax.jit(jax.grad(loss))(variables["params"])
    return variables, W, out


@pytest.mark.parametrize("implicit", [False, True])
def test_fused_frame_step_ignores_implicit_grad(fused_frame_grads, implicit):
    """The fused path takes no implicit_grad in either package: the JAX
    grads are the same both ways, and the port's equal them both ways."""
    variables, W, jax_grads = fused_frame_grads
    want = convert_flax_variables({"params": jax.device_get(jax_grads[implicit])})
    other = convert_flax_variables(
        {"params": jax.device_get(jax_grads[not implicit])})
    for k in want:
        np.testing.assert_array_equal(want[k].numpy(), other[k].numpy())

    cfg = config_from_dict(_tiny_cfg(implicit).to_dict())
    model = DMMNet(cfg, device="cpu", train=True)
    load_flax_variables(model, variables)
    frame, pmask, pvalid, tf, tvalid, tmasks = map(torch.from_numpy,
                                                   _frame_inputs(cfg))
    out, _ = model(frame, pmask, pvalid, tf, tvalid, model.init_state(tmasks))
    loss = (out.assignment * torch.from_numpy(W)).sum()
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        assert np.abs(g - w).max() <= 1e-4 * (np.abs(w).max() + 1e-12), name
    assert np.abs(want["feat_proj.weight"].numpy()).max() > 0


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(valid_3d):
    rng = np.random.RandomState(7)
    B, T, M, H, W = 2, 3, 4, 12, 10
    logits = (rng.randn(B, T, M, H, W) * 4).astype(np.float32)
    gt = (rng.rand(B, T, M, H, W) > 0.7).astype(np.float32)
    gt[0, 1, 0] = 0.0                     # an empty ground truth
    gt[:, :, 3] = 0.0                     # a padded object's (empty) GT
    valid = np.ones((B, M), bool)
    valid[:, 3] = False                   # padded object
    if valid_3d:                          # an object live from frame 1 on
        valid = np.repeat(valid[:, None], T, 1)
        valid[1, 0, 2] = False
    return logits, gt, valid


@pytest.mark.parametrize("valid_3d", [False, True])
@pytest.mark.parametrize("which", ["bce", "iou", "clip"])
def test_losses_match_jax(which, valid_3d):
    logits, gt, valid = _loss_inputs(valid_3d)
    v4 = valid if valid_3d else np.broadcast_to(valid[:, None], logits.shape[:3])
    fns = {"bce": (jax_losses.mask_bce_loss, losses.mask_bce_loss, v4),
           "iou": (jax_losses.soft_iou_loss, losses.soft_iou_loss, v4),
           "clip": (jax_losses.clip_loss, losses.clip_loss, valid)}
    jfn, pfn, v = fns[which]
    want, gwant = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(gt),
                                          jnp.asarray(v))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = pfn(x, torch.from_numpy(gt), torch.from_numpy(np.ascontiguousarray(v)))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    assert _rel(x.grad.numpy(), gwant) <= 1e-6
    # padded objects take no gradient
    assert (x.grad.numpy()[:, :, 3] == 0).all()


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------

def _opt_cfg(warmup, accum):
    return Config(train=TrainConfig(lr=1e-2, weight_decay=1e-2,
                                    warmup_steps=warmup, total_steps=8,
                                    grad_accum=accum),
                  data=DataConfig(), matching=MatchingConfig())


@pytest.mark.parametrize("warmup,accum,gscale", [
    (2, 1, 0.05),      # warmup (first update has lr 0), norm below 1
    (0, 1, 3.0),       # no warmup, norm above 1: clipped
    (0, 2, 3.0),       # MultiSteps: the mean of 2 gradients per update
])
def test_optimizer_matches_optax(warmup, accum, gscale):
    cfg = _opt_cfg(warmup, accum)
    rng = np.random.RandomState(9)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * gscale).astype(np.float32)
              for k, v in params.items()} for _ in range(5 * accum)]

    tx = make_optimizer(cfg)
    jp, opt_state = {k: jnp.asarray(v) for k, v in params.items()}, None
    opt_state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = Optimizer(list(tp.values()),
                    config_from_dict(cfg.to_dict()))
    for i, g in enumerate(grads):
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        before = {k: v.clone() for k, v in tp.items()}
        opt.update([torch.from_numpy(g[k]) for k in tp])
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{k}@{i}")
        if warmup and i == 0:                # lr(0) = 0 under a warmup
            assert all(torch.equal(tp[k], before[k]) for k in tp)
    assert opt.count == 5


def test_optimizer_state_round_trips():
    cfg = config_from_dict(_opt_cfg(0, 2).to_dict())
    p = [torch.randn(3, generator=torch.Generator().manual_seed(0))]
    opt = Optimizer(p, cfg)
    opt.update([torch.ones(3)])
    q = [p[0].clone()]
    opt2 = Optimizer(q, dataclasses.replace(cfg))
    opt2.load_state_dict(opt.state_dict())
    for o in (opt, opt2):
        o.update([torch.full((3,), 2.0)])
    assert torch.equal(p[0], q[0]) and opt2.count == opt.count == 1
