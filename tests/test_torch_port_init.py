"""The port's seeded init (models/layers.init_random) draws each kernel from
the distribution the JAX package's flax modules draw it from: a normal cut
at 2 sigma and rescaled to variance scale / fan_in (``lecun_normal``,
flax's default, scale 1; ``he_normal`` for DCNv2's main kernel, scale 2),
with fan_in taken as flax takes it (input channels x kernel area; for the
transposed conv its inputs, not its outputs)."""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from dmm_net_tpu_torch.config import Config, MatchingConfig, ModelConfig
from dmm_net_tpu_torch.models.dmm import DMMNet
from dmm_net_tpu_torch.models.layers import Conv, ConvTranspose, init_random
from dmm_net_tpu_torch.models.proposal import MaskRCNN
from dmm_net_tpu_torch.ops.deform_conv import DeformConv
from dmm_net_tpu_torch.weights import to_flax_variables
from test_torch_port_train_step import few_threads  # noqa: F401

TRUNC_STD = 0.87962566103423978     # std of a unit normal cut at +-2


def _port(module):
    init_random(module, torch.Generator().manual_seed(0))
    return to_flax_variables(module)["params"]["kernel"].ravel()


def _jax(init, shape):
    return np.asarray(init(jax.random.PRNGKey(0), shape, np.float32)).ravel()


@pytest.mark.parametrize("case", ["conv", "dcn", "conv_transpose"])
def test_kernel_draws_as_flax(case):
    """One kernel against jax.nn.initializers on the same flax shape: std
    within 2%, every value inside the cut (2 sigma of the underlying
    normal, 2 std / 0.8796), and a two-sample KS test that cannot tell them
    apart but does tell the port's draw from an untruncated normal of the
    same std (what init_random drew before)."""
    if case == "conv":
        module = Conv(256, 256, 3)
        shape, init, scale = (3, 3, 256, 256), jax.nn.initializers.lecun_normal(), 1.0
    elif case == "dcn":
        module = DeformConv(256, 256, 3)
        shape, init, scale = (3, 3, 256, 256), jax.nn.initializers.he_normal(), 2.0
    else:
        # flax nn.ConvTranspose's kernel is (kh, kw, in, out): fan_in = 2*2*256
        module = ConvTranspose(256, 128, 2)
        shape, init, scale = (2, 2, 256, 128), jax.nn.initializers.lecun_normal(), 1.0
    got, want = _port(module), _jax(init, shape)
    assert got.size == want.size
    std = np.sqrt(scale / np.prod(shape[:-1]))
    assert abs(got.std() / want.std() - 1) < 0.02, (got.std(), want.std())
    assert abs(got.std() / std - 1) < 0.02
    cut = 2 * std / TRUNC_STD
    assert np.abs(got).max() <= cut * (1 + 1e-6) and np.abs(want).max() <= cut * (1 + 1e-6)
    assert stats.ks_2samp(got, want).pvalue > 1e-3
    plain = np.random.RandomState(0).randn(got.size) * std
    assert stats.ks_2samp(got, plain).pvalue < 1e-6


def _kernels(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _kernels(v, path + (k,))
        elif k == "kernel":
            # a DCNv2 layer holds its offset predictor beside its main kernel
            yield "/".join(path), v, 2.0 if "offset_conv" in tree else 1.0


@pytest.mark.parametrize("model", ["dmm", "detector_dcn"])
def test_every_kernel_of_a_model_is_cut_and_scaled(model, few_threads):  # noqa: F811
    """Every kernel of a seeded DMMNet and of a seeded DCN detector, in the
    JAX package's layout (to_flax_variables): inside its cut, and with the
    std flax gives its shape (within 5% where it has >= 2048 values; the
    DCN offset predictors stay 0). DMMNet covers convs, the decoder's
    convs and dense layers; the detector the transposed conv, the box
    head's dense layers and DCNv2's he_normal kernels."""
    if model == "dmm":
        cfg = Config(model=ModelConfig(backbone="resnet18", backbone_dtype="float32",
                                       feature_dim=32, decoder_dim=16,
                                       image_size=(64, 64)),
                     matching=MatchingConfig(max_templates=4, max_proposals=8))
        params = to_flax_variables(DMMNet(cfg, device="cpu", seed=3))["params"]
    else:
        params = to_flax_variables(MaskRCNN(
            image_size=(64, 128), backbone_name="resnet18", num_classes=8,
            deform_stages=("c4", "c5"), device="cpu", seed=3))["params"]
    checked, scales = 0, set()
    for name, k, scale in _kernels(params):
        if name.endswith("offset_conv"):
            assert not k.any(), name
            continue
        std = np.sqrt(scale / np.prod(k.shape[:-1]))
        assert np.abs(k).max() <= 2 * std / TRUNC_STD * (1 + 1e-6), name
        if k.size >= 2048:
            assert abs(k.std() / std - 1) < 0.05, (name, k.std(), std)
            checked += 1
        scales.add(scale)
    assert checked > 10
    assert scales == ({1.0, 2.0} if model == "detector_dcn" else {1.0})
