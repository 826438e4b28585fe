"""The port's ops and model modules (dmm_net_tpu_torch) against the JAX
package on the same inputs and weights, in float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmm_net_tpu.config import Config, ModelConfig
from dmm_net_tpu.models.decoder import SharedFPNDecoder as JaxDecoder
from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
from dmm_net_tpu.models.proposal.maskrcnn import paste_masks as jax_paste
from dmm_net_tpu.ops.cost import cost_matrix as jax_cost_matrix
from dmm_net_tpu.ops.matching import hard_assignment as jax_hard
from dmm_net_tpu.ops.matching import sinkhorn_match as jax_sinkhorn
from dmm_net_tpu.ops.roi_pool import mask_avg_pool as jax_pool
from dmm_net_tpu_torch.config import config_from_dict
from dmm_net_tpu_torch.models.decoder import SharedFPNDecoder
from dmm_net_tpu_torch.models.dmm import DMMNet
from dmm_net_tpu_torch.models.proposal.maskrcnn import paste_masks
from dmm_net_tpu_torch.ops.cost import cost_matrix
from dmm_net_tpu_torch.ops.matching import hard_assignment, sinkhorn_match
from dmm_net_tpu_torch.ops.resize import resize
from dmm_net_tpu_torch.ops.roi_pool import mask_avg_pool
from dmm_net_tpu_torch.weights import convert_flax_variables


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _randomize(variables, seed):
    """Replace every leaf with nontrivial values (BN scales and stats
    included, so a layout or epsilon slip cannot hide behind identity)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(leaf, _np_tree(variables))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_hw", [(16, 24), (80, 112), (64, 20), (37, 53)])
def test_resize_matches_jax_image_resize(out_hw):
    x = np.random.RandomState(0).rand(2, 3, 37, 53).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + out_hw,
                                       method="bilinear"))
    got = resize(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_resize_keeps_bf16_and_casts_back():
    x = torch.rand(1, 2, 16, 28).to(torch.bfloat16)
    y = resize(x, (8, 14))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 2, 8, 14)


def _cost_inputs(seed=0, B=2, M=5, N=9, P=70, D=12):
    rng = np.random.RandomState(seed)
    tm = rng.rand(B, M, P).astype(np.float32)
    pm = (rng.rand(B, N, P) > 0.5).astype(np.float32)
    tf = rng.randn(B, M, D).astype(np.float32)
    pf = rng.randn(B, N, D).astype(np.float32)
    pf[:, -1] = 0.0                          # an all-zero (padded) feature row
    rm = np.ones((B, M), bool)
    rm[:, 3:] = False
    cm = np.ones((B, N), bool)
    cm[:, 7:] = False
    return tm, pm, tf, pf, rm, cm


def test_cost_matrix_matches_jax():
    arrs = _cost_inputs()
    want = np.asarray(jax_cost_matrix(*map(jnp.asarray, arrs), iou_weight=0.3))
    got = cost_matrix(*map(torch.from_numpy, arrs), iou_weight=0.3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("eps_init,implicit", [(None, False), (0.5, False),
                                               (None, True)])
def test_sinkhorn_match_matches_jax(eps_init, implicit):
    tm, pm, tf, pf, rm, cm = _cost_inputs(1)
    C = np.array(jax_cost_matrix(*map(jnp.asarray, (tm, pm, tf, pf, rm, cm))))
    want = np.asarray(jax_sinkhorn(jnp.asarray(C), jnp.asarray(rm),
                                   jnp.asarray(cm), epsilon=0.05, iters=30,
                                   implicit_grad=implicit,
                                   epsilon_init=eps_init))
    got = sinkhorn_match(torch.from_numpy(C), torch.from_numpy(rm),
                         torch.from_numpy(cm), epsilon=0.05, iters=30,
                         implicit_grad=implicit, epsilon_init=eps_init).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert (got[:, 3:] == 0).all() and (got[:, :, 7:] == 0).all()
    idx = hard_assignment(torch.from_numpy(got), torch.from_numpy(rm),
                          torch.from_numpy(cm)).numpy()
    np.testing.assert_array_equal(
        idx, np.asarray(jax_hard(jnp.asarray(got), jnp.asarray(rm),
                                 jnp.asarray(cm))))


def test_mask_avg_pool_matches_jax():
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 5, 7, 16).astype(np.float32)
    masks = rng.rand(2, 4, 20, 28).astype(np.float32)
    masks[:, -1] = 0.0                       # empty mask -> zero vector
    want = np.asarray(jax_pool(jnp.asarray(feats), jnp.asarray(masks)))
    got = mask_avg_pool(torch.from_numpy(feats), torch.from_numpy(masks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[:, -1] == 0).all()


def test_paste_masks_matches_jax():
    rng = np.random.RandomState(3)
    D, H, W = 12, 40, 56
    m28 = rng.rand(D, 28, 28).astype(np.float32)
    xy = rng.rand(D, 2) * np.array([W, H]) - 5
    wh = 3 + rng.rand(D, 2) * np.array([W, H]) * 0.6
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    valid = rng.rand(D) > 0.2
    want = np.asarray(jax_paste(jnp.asarray(m28), jnp.asarray(boxes),
                                jnp.asarray(valid), (H, W)))
    got = paste_masks(torch.from_numpy(m28), torch.from_numpy(boxes),
                      torch.from_numpy(valid), (H, W)).numpy()
    assert got.shape == want.shape == (D, H, W)
    # binary output: only values within float noise of 0.5 may flip
    assert (got != want).mean() < 1e-3
    assert (got[~valid] == 0).all() and got.sum() > 0


# ---------------------------------------------------------------------------
# backbone + embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone,input_norm", [("resnet18", "raw01"),
                                                 ("resnet18", "imagenet"),
                                                 ("resnet50", "raw01")])
def test_extract_features_matches_jax(backbone, input_norm):
    cfg = Config(model=ModelConfig(backbone=backbone, backbone_dtype="float32",
                                   feature_dim=16, input_norm=input_norm,
                                   image_size=(64, 64)))
    frames = np.random.RandomState(4).randint(0, 256, (2, 64, 64, 3)) \
        .astype(np.uint8)
    jmodel = JaxDMMNet(cfg)
    variables = _randomize(jmodel.init(jax.random.PRNGKey(0),
                                       jnp.asarray(frames),
                                       method=JaxDMMNet.extract_features), 5)
    want = jmodel.apply(variables, jnp.asarray(frames),
                        method=JaxDMMNet.extract_features)

    port = DMMNet(config_from_dict(cfg.to_dict()), device="cpu")
    missing, unexpected = port.load_state_dict(
        convert_flax_variables(variables), strict=False)
    assert not unexpected
    assert missing and all(k.startswith("decoder.") for k in missing)
    got = port.extract_features(torch.from_numpy(frames))
    for lvl in ("c1", "c2", "c3", "c4", "c5", "emb"):
        r = _rel(got[lvl].permute(0, 2, 3, 1).numpy(), want[lvl])
        assert r < 1e-4, f"{backbone} {lvl}: rel err {r:.2e}"


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

_CH = {"c2": 8, "c3": 12, "c4": 16, "c5": 20}
_SHIPPED = dict(obj_fuse="conv1", obj_features_fine=4, obj_merge_fine_k=3,
                obj_fine_level="c3", detail_dim=4, detail_basis_k=1)
_LEGACY = dict(obj_fuse="conv3", obj_features_fine=0, obj_merge_fine_k=3,
               obj_fine_level="", detail_dim=4, detail_basis_k=3)


@pytest.mark.parametrize("knobs,out_hw", [(_SHIPPED, (16, 24)),
                                          (_LEGACY, (64, 96)),
                                          (dict(_SHIPPED, obj_fuse="none",
                                                features_fine=12), (16, 24))])
def test_shared_fpn_decoder_matches_jax(knobs, out_hw):
    rng = np.random.RandomState(6)
    B, M = 2, 3
    sizes = {"c2": (16, 24), "c3": (8, 12), "c4": (4, 6), "c5": (2, 3)}
    feats = {k: rng.randn(B, *sizes[k], _CH[k]).astype(np.float32)
             for k in _CH}
    agg = rng.rand(B, M, 16, 24).astype(np.float32)
    state = (rng.randn(B, M, 2, 3, 8) * 0.5).astype(np.float32)
    jdec = JaxDecoder(features=16, obj_features=8, dtype=jnp.float32,
                      fine_level="c2", **knobs)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = _randomize(jdec.init(jax.random.PRNGKey(1), jfeats,
                                     jnp.asarray(agg), jnp.asarray(state),
                                     out_hw=out_hw), 7)
    want_logits, want_state = jdec.apply(variables, jfeats, jnp.asarray(agg),
                                         jnp.asarray(state), out_hw=out_hw)

    port = SharedFPNDecoder(_CH, features=16, obj_features=8,
                            dtype=torch.float32, fine_level="c2", **knobs)
    port.load_state_dict(convert_flax_variables(variables, port))
    tfeats = {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}
    with torch.no_grad():
        logits, new_state = port(tfeats, torch.from_numpy(agg),
                                 torch.from_numpy(state), out_hw=out_hw)
    assert logits.shape == (B, M) + out_hw
    assert _rel(logits.numpy(), want_logits) < 1e-4
    assert _rel(new_state.numpy(), want_state) < 1e-4


@pytest.mark.parametrize("obj_fine_level,has_detail", [("", False),
                                                       ("c2", False),
                                                       ("c3", True)])
def test_detail_head_gate_follows_reference(obj_fine_level, has_detail):
    """The reference gates the detail head on tuple identity; a full-range
    slice of a tuple is the same object, so obj_fine_level equal to the
    finest level builds no head. The port's parameter tree must match."""
    B, M = 1, 2
    sizes = {"c2": (8, 8), "c3": (4, 4), "c4": (2, 2), "c5": (1, 1)}
    feats = {k: jnp.zeros((B, *sizes[k], _CH[k])) for k in _CH}
    jdec = JaxDecoder(features=8, obj_features=4, obj_fine_level=obj_fine_level,
                      detail_dim=4)
    params = jdec.init(jax.random.PRNGKey(0), feats, jnp.zeros((B, M, 8, 8)),
                       None)["params"]
    assert ("detail_basis" in params) == has_detail
    port = SharedFPNDecoder(_CH, features=8, obj_features=4,
                            obj_fine_level=obj_fine_level, detail_dim=4)
    assert port.detail == has_detail
    convert_flax_variables({"params": _np_tree(params)}, port)   # strict
