"""The port's clip-BPTT train step against the JAX package's on the same
variables and batches: the loss, every gradient leaf (through the weight
bridge's name map), the BN running statistics and the parameters after two
optimizer steps. tests/test_model.py's tiny configuration: R-18, float32,
64x64, M=4, N=8, B=2, T=3.

Variants (``jax_reference``; "b" and "c" run in
tests/test_torch_port_train_fused.py):
  a: the unfused matcher, frozen BN, ``synthetic_clip_batch(seed=0)``;
  b: the fused matcher (B1 forward, B1' backward), remat and train-mode BN
     on a gated YouTube-VOS batch (``live_from``, ``gt_valid``);
  c: as b with frozen BN.

The JAX side runs its ResNet with ``s2d_stem=False``: the plain 7x7/s2
stem conv that the port implements. The default space-to-depth stem is the
same function, but its different rounding breaks exact ties inside the
max-pool windows that follow it differently: the synthetic frames have flat
object colours, so tied maxima are common, and the pool's gradient then
goes to a different pixel of the tie. That moves the stem's and the first
blocks' gradients by up to ~1.6e-3 of a leaf's largest entry (JAX's two
stems differ from each other by the same amount), while with the plain
stem every leaf agrees to ~2e-6."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmm_net_tpu.config import (Config, DataConfig, MatchingConfig,
                                ModelConfig, TrainConfig)
import dmm_net_tpu.models.dmm as jax_dmm
from dmm_net_tpu.data.synthetic import synthetic_clip_batch
from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
from dmm_net_tpu.models.dmm import init_frame_state as jax_init_state
from dmm_net_tpu.train.loop import TrainState as JaxTrainState
from dmm_net_tpu.train.loop import _clip_forward as jax_clip_forward
from dmm_net_tpu.train.loop import make_optimizer
from dmm_net_tpu_torch.config import config_from_dict
from dmm_net_tpu_torch.data.ytvos import YTVOSDataset
from torch_port_native import pin_port_to_pil
from dmm_net_tpu_torch.train.loop import (_clip_forward, batch_to,
                                          create_train_state, make_train_step)
from dmm_net_tpu_torch.weights import convert_flax_variables
from test_torch_port_engine import _randomize
from test_ytvos_train import _fake_ytvos_train


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module's tests run: the test runner
    puts several workers on the machine's cores, and PyTorch's default of
    one thread per core then oversubscribes them many times over (a train
    step of the tiny model ran ~60x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_config(**model_kw) -> Config:
    """tests/test_model.py's tiny_config with warmup_steps=0, so that the
    first update moves the parameters."""
    return Config(
        name="test_tiny",
        model=ModelConfig(backbone="resnet18", backbone_dtype="float32",
                          feature_dim=32, decoder_dim=16,
                          image_size=(64, 64), **model_kw),
        matching=MatchingConfig(max_templates=4, max_proposals=8,
                                sinkhorn_iters=10),
        data=DataConfig(dataset="synthetic", batch_size=2, clip_length=3),
        train=TrainConfig(lr=1e-3, warmup_steps=0, total_steps=50,
                          loss_iou_weight=0.5))


def _variant_cfg(variant):
    cfg = tiny_config(train_bn=variant == "b")
    if variant in ("b", "c"):
        cfg = cfg.override(**{"matching.use_pallas": True,
                               "train.remat": True})
    return cfg


def _batch(variant, tmp_path_factory):
    if variant == "a":
        return synthetic_clip_batch(seed=0, batch=2, T=3, H=64, W=64,
                                    num_objects=2, num_proposals=8,
                                    pad_objects=4)
    root, _ = _fake_ytvos_train(tmp_path_factory.mktemp("ytvos"))
    # read with PIL, as when these references were set: natively decoded
    # frames move the stem's max-pool ties (ROADMAP.md §C), which puts the
    # early backbone's gradients ~2.7e-4 of their scale from JAX's with
    # the loss still bit-equal
    with pytest.MonkeyPatch.context() as mp:
        pin_port_to_pil(mp)
        ds = YTVOSDataset(root, split="train", image_size=(64, 64),
                          max_objects=4, max_proposals=8)
        b = next(ds.clip_batches(2, 3, seed=0))
    assert b["live_from"].max() > 0 and not b["gt_valid"].all()
    return b


def _stats(tree_or_model):
    if isinstance(tree_or_model, torch.nn.Module):
        return {k: v.clone() for k, v in tree_or_model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}
    return convert_flax_variables({"batch_stats": jax.device_get(tree_or_model)})


def jax_train_reference(variant, tmp_path_factory, backbone_f64=False):
    """One JAX value_and_grad compile per variant: step-1 loss, grads and BN
    stats, and the parameters after two TrainState updates. With
    ``backbone_f64`` the JAX backbone computes in float64 (x64 on; its
    parameters stay float32) and the rest of the model as configured."""
    kw = {"s2d_stem": False}
    with contextlib.ExitStack() as stack:
        if backbone_f64:
            stack.enter_context(jax.enable_x64(True))
            kw["dtype"] = jnp.float64
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        plain_stem = jax_dmm.backbone_by_name
        mp.setattr(jax_dmm, "backbone_by_name",
                   lambda *a, **k: plain_stem(*a, **{**k, **kw}))
        return _jax_reference(variant, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    return jax_train_reference("a", tmp_path_factory)


def _jax_reference(variant, tmp_path_factory):
    cfg = _variant_cfg(variant)
    batch = _batch(variant, tmp_path_factory)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxDMMNet(cfg, train=True)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jb["frames"][:, 0],
        jb["prop_masks"][:, 0], jb["prop_valid"][:, 0],
        jnp.zeros((2, 4, cfg.model.feature_dim)), jb["tmpl_valid"],
        jax_init_state(cfg, jb["tmpl_masks"]))
    variables = _randomize(shapes, 11)
    if jax.config.jax_enable_x64:     # a float64 backbone keeps float64 stats
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), variables["batch_stats"])

    def loss_fn(params, bs):
        loss, _, new_bs = jax_clip_forward(
            model, {"params": params, "batch_stats": bs}, jb, cfg)
        return loss, new_bs

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, new_bs), grads = vg(variables["params"], variables["batch_stats"])
    tx = make_optimizer(cfg)
    st = JaxTrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx,
                       apply_fn=model.apply)
    st = st.apply_gradients(grads).replace(batch_stats=new_bs)
    (loss2, bs2), grads2 = vg(st.params, st.batch_stats)
    st = st.apply_gradients(grads2).replace(batch_stats=bs2)
    return dict(variant=variant, cfg=cfg, batch=batch, variables=variables,
                loss=float(loss), grads=jax.device_get(grads), bs=new_bs,
                loss2=float(loss2), params2=jax.device_get(st.params))


def _port(ref):
    cfg = config_from_dict(ref["cfg"].to_dict())
    state = create_train_state(cfg, variables=ref["variables"], device="cpu")
    return cfg, state, batch_to(ref["batch"], "cpu")


def test_train_step_loss_and_grads_match_jax(jax_reference):
    check_loss_and_grads(jax_reference)


def check_loss_and_grads(ref):
    """Loss to 1e-5 relative, every gradient leaf to 1e-4 of that leaf's
    largest entry, and (train-mode BN) the running statistics after the
    step to 1e-5 (absolute plus relative)."""
    cfg, state, batch = _port(ref)
    loss, _ = _clip_forward(state.model, batch, cfg)
    assert abs(loss.item() - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    names, params = zip(*state.model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    want = convert_flax_variables({"params": ref["grads"]})
    assert set(want) == set(names)
    moved = 0
    for name, g in zip(names, grads):
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-4 * scale + 1e-12, name
        moved += scale > 0
    assert moved > 0.9 * len(names)
    if ref["variant"] == "b":          # train-mode BN: one update per frame
        got = _stats(state.model)
        for k, w in _stats(ref["bs"]).items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_two_optimizer_steps_match_jax(jax_reference):
    check_two_steps(jax_reference)


def check_two_steps(ref):
    """Both steps' losses to 1e-5 relative and every parameter leaf after
    the second update to 1e-4 in norm, ||p - p_jax|| / ||p_jax||: Adam
    divides each gradient entry by its own running scale, so an entry whose
    gradient is at rounding level (~1e-9) still moves by up to lr, and an
    elementwise bound would measure that rounding, not the port."""
    cfg, state, batch = _port(ref)
    step = make_train_step(cfg)
    m1, m2 = step(state, batch), step(state, batch)
    assert abs(float(m1["loss"]) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert abs(float(m2["loss"]) - ref["loss2"]) <= 1e-5 * abs(ref["loss2"])
    want = convert_flax_variables({"params": ref["params2"]})
    got = dict(state.model.named_parameters())
    for name, w in want.items():
        w, g = w.numpy(), got[name].detach().numpy()
        assert np.linalg.norm(g - w) <= 1e-4 * (np.linalg.norm(w) + 1e-12), name
    assert state.step == 2 and state.optimizer.count == 2


def test_remat_changes_nothing_and_bn_updates_once_per_frame(tmp_path_factory):
    """Remat recomputes each frame's forward in the backward; the loss, the
    gradients and the BN running statistics must not see it."""
    cfg = config_from_dict(_variant_cfg("b").to_dict())
    batch = batch_to(_batch("b", tmp_path_factory), "cpu")
    out = {}
    for remat in (True, False):
        c = cfg.override(**{"train.remat": remat})
        state = create_train_state(c, seed=3, device="cpu")
        before = _stats(state.model)
        loss, _ = _clip_forward(state.model, batch, c)
        params = list(state.model.parameters())
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(loss, params, allow_unused=True))]
        out[remat] = (loss.detach(), grads, before, _stats(state.model))
    (l1, g1, b1, s1), (l0, g0, b0, s0) = out[True], out[False]
    assert abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0))
    for a, b in zip(g1, g0):
        assert (a - b).abs().max() <= 1e-6 * (b.abs().max() + 1e-12)
    for k in s0:         # (variant b holds their values against JAX's)
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=1e-6)
        assert not torch.equal(s0[k], b0[k]), k       # they did move


def test_frozen_bn_stats_stay_bit_identical():
    cfg = config_from_dict(tiny_config().to_dict())
    state = create_train_state(cfg, seed=0, device="cpu")
    before = _stats(state.model)
    batch = batch_to(synthetic_clip_batch(seed=1, batch=2, T=3, H=64, W=64,
                                          num_objects=2, num_proposals=8,
                                          pad_objects=4), "cpu")
    metrics = make_train_step(cfg)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    after = _stats(state.model)
    assert all(torch.equal(after[k], before[k]) for k in before)
    # the parameters did move
    assert state.optimizer.count == 1


def test_serving_model_is_frozen():
    """DMMNet(train=False) keeps eval mode, no gradients and parameters in
    their compute dtype (bf16 backbone), as before training existed."""
    from dmm_net_tpu_torch.models.dmm import DMMNet
    cfg = config_from_dict(dataclasses.replace(
        tiny_config(train_bn=True),
        model=dataclasses.replace(tiny_config().model,
                                  backbone_dtype="bfloat16",
                                  train_bn=True)).to_dict())
    serve = DMMNet(cfg, device="cpu")
    train = DMMNet(cfg, device="cpu", train=True)
    assert not serve.training and train.training
    assert not any(p.requires_grad for p in serve.parameters())
    assert serve.backbone.conv_init.weight.dtype == torch.bfloat16
    assert train.backbone.conv_init.weight.dtype == torch.float32
    assert all(p.requires_grad for p in train.parameters())
    assert not serve.backbone.bn_init.train_stats
    assert train.backbone.bn_init.train_stats
