"""The port's train step on the fused matcher (B1 forward on the kernel's
plain version here, B1' backward), with remat, on a gated YouTube-VOS batch,
against the JAX package's; variants and helpers in
tests/test_torch_port_train_step.py.

With train-mode BN (variant b) the JAX package's float32 gradients of the
backbone are not a reference at 1e-4: its batch statistics E[x^2] - E[x]^2
cancel (mean/std ~3.6 at the stem on [0, 1] frames) after reductions less
exact than PyTorch's (the stem's batch variance is ~1.6e-5 off in relative
terms), and the gradient through the normalisation multiplies that, so
JAX's own backbone gradients sit up to ~11% from the float64 value while
the port's sit within ~2e-5. So variant b's reference is JAX's train step
with its backbone computing in float64 (x64 on, float32 parameters) and
the rest of the model in float32: every leaf, the loss and the running
statistics are held against it, the backbone's leaves at the gradient that
the matcher, B1' and the decoder send into it. A ResNet-18 alone is also
held against JAX's in float64 under a random cotangent. Variant c (frozen
BN) holds every leaf and two optimizer steps against JAX's float32 step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmm_net_tpu.models.resnet import backbone_by_name as jax_backbone
from dmm_net_tpu_torch.models.resnet import backbone_by_name
from dmm_net_tpu_torch.weights import convert_flax_variables
from test_torch_port_engine import _randomize
from test_torch_port_train_step import few_threads  # noqa: F401
from test_torch_port_train_step import (check_loss_and_grads, check_two_steps,
                                        jax_train_reference)


@pytest.fixture(scope="module")
def train_bn_reference(tmp_path_factory):
    return jax_train_reference("b", tmp_path_factory, backbone_f64=True)


@pytest.fixture(scope="module")
def frozen_bn_reference(tmp_path_factory):
    return jax_train_reference("c", tmp_path_factory)


def test_fused_train_bn_step_matches_jax(train_bn_reference):
    check_loss_and_grads(train_bn_reference)


def test_fused_frozen_bn_step_matches_jax(frozen_bn_reference):
    check_loss_and_grads(frozen_bn_reference)


def test_fused_two_optimizer_steps_match_jax(frozen_bn_reference):
    check_two_steps(frozen_bn_reference)


def test_train_bn_backbone_grads_match_jax_float64():
    """ResNet-18 with train-mode BN (plain stem), B=2 at 64x64: the port in
    float32 against the JAX package's module run in float64, every
    parameter's gradient to 1e-4 of its largest entry."""
    rng = np.random.RandomState(0)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    levels = ("c2", "c3", "c4", "c5")
    with jax.enable_x64(True):
        jm = jax_backbone("resnet18", dtype=jnp.float64, train_bn=True,
                          s2d_stem=False)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.asarray(x, jnp.float64))
        variables = _randomize(shapes, 11)
        feats = jax.eval_shape(
            lambda: jm.apply(variables, jnp.asarray(x, jnp.float64),
                             mutable=["batch_stats"])[0])
        G = {k: rng.randn(*feats[k].shape) for k in levels}
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)

        def f(params):
            out, _ = jm.apply({"params": params,
                               "batch_stats": v64["batch_stats"]},
                              jnp.asarray(x, jnp.float64),
                              mutable=["batch_stats"])
            return sum(jnp.sum(out[k] * G[k]) for k in levels)

        grads = jax.device_get(jax.jit(jax.grad(f))(v64["params"]))
    want = convert_flax_variables({"params": grads})

    model = backbone_by_name("resnet18", dtype=torch.float32, train_bn=True)
    model.load_state_dict(convert_flax_variables(variables))
    model.train()
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    loss = sum((out[k] * torch.from_numpy(G[k]).float().permute(0, 3, 1, 2))
               .sum() for k in levels)
    names, params = zip(*model.named_parameters())
    for name, g in zip(names, torch.autograd.grad(loss, params)):
        w = want[name].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name

