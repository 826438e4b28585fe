"""The weight bridge (dmm_net_tpu_torch.weights) on the git-tracked fallback
artifact, and the port's engine against the JAX engine on those weights at
the artifact's own config (R-18 at 128x224, unfused matcher, full-res
logits, aggregation template update, the legacy decoder knobs)."""

from pathlib import Path

import numpy as np
import pytest

import jax
from flax import serialization

from dmm_net_tpu.config import config_from_dict as jax_config_from_dict
from dmm_net_tpu.config import preset as jax_preset
from dmm_net_tpu.data.synthetic import synthetic_sequence
from dmm_net_tpu.infer.engine import InferenceEngine as JaxEngine
from dmm_net_tpu_torch.config import config_from_dict, preset
from dmm_net_tpu_torch.infer.engine import InferenceEngine
from dmm_net_tpu_torch.models.dmm import DMMNet
from dmm_net_tpu_torch.weights import convert_flax_variables, load_flax_variables

_ARTIFACT = Path(__file__).resolve().parent.parent / "artifacts" / \
    "dmm128_fallback.msgpack"


@pytest.fixture(scope="module")
def blob():
    with open(_ARTIFACT, "rb") as f:
        b = serialization.msgpack_restore(f.read())
    return b["config"], jax.tree_util.tree_map(np.asarray, b["variables"])


def _leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_artifact_maps_with_nothing_left_over(blob):
    cfg_dict, variables = blob
    cfg = config_from_dict(cfg_dict)
    assert cfg.model.decoder_obj_fine_level == "" and not cfg.matching.use_pallas
    model = DMMNet(cfg, device="cpu")
    sd = convert_flax_variables(variables, model)      # strict both ways
    assert len(sd) == _leaves(variables) == len(model.state_dict())
    n_values = sum(int(np.prod(v.shape)) for v in sd.values())
    assert n_values == sum(int(np.prod(x.shape))
                           for x in jax.tree_util.tree_leaves(variables))
    load_flax_variables(model, variables)
    k = variables["params"]["backbone"]["conv_init"]["kernel"]      # HWIO
    np.testing.assert_array_equal(
        model.backbone.conv_init.weight.numpy(), k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("break_tree", ["extra_leaf", "missing_leaf",
                                        "unknown_leaf", "wrong_shape"])
def test_bridge_is_strict(blob, break_tree):
    cfg_dict, variables = blob
    model = DMMNet(config_from_dict(cfg_dict), device="cpu")
    bad = jax.tree_util.tree_map(lambda x: x, variables)       # copy
    dec = bad["params"]["decoder"]
    if break_tree == "extra_leaf":
        dec["obj_extra"] = {"kernel": np.zeros((1, 1, 4, 4), np.float32)}
    elif break_tree == "missing_leaf":
        del dec["out"]
    elif break_tree == "unknown_leaf":
        dec["out"]["gamma"] = np.zeros((1,), np.float32)
    else:
        dec["out"]["kernel"] = np.zeros((3, 3, 8, 1), np.float32)
    with pytest.raises((KeyError, ValueError)):
        convert_flax_variables(bad, model)


def test_port_engine_matches_jax_engine_on_artifact(blob):
    cfg_dict, variables = blob
    jcfg = jax_config_from_dict(cfg_dict)
    H, W = jcfg.model.image_size
    M, N = jcfg.matching.max_templates, jcfg.matching.max_proposals
    seq = synthetic_sequence(seed=3, T=3, H=H, W=W, num_objects=2,
                             num_proposals=N)
    pad = lambda x: np.pad(x, [(0, M - x.shape[0])] + [(0, 0)] * (x.ndim - 1))  # noqa: E731
    tmpl_masks = pad(seq["tmpl_masks"])[None]
    tmpl_valid = pad(seq["tmpl_valid"])[None]
    items = [{"frame": seq["frames"][t][None],
              "prop_masks": seq["prop_masks"][t][None],
              "prop_valid": seq["prop_valid"][t][None]} for t in range(3)]

    want = JaxEngine(jcfg, variables=variables).run_stream_chunked(
        iter(items), tmpl_masks, tmpl_valid, seq["frames"][0][None], chunk=2)
    port = InferenceEngine(config_from_dict(cfg_dict), variables=variables,
                           device="cpu")
    got = port.run_stream_chunked(iter(items), tmpl_masks, tmpl_valid,
                                  seq["frames"][0][None], chunk=2)
    assert got["labels"].shape == want["labels"].shape == (3, 1, H, W)
    assert set(np.unique(want["labels"])) >= {0, 1, 2}    # trained: finds objects
    assert (got["labels"] != want["labels"]).mean() < 1e-3
    np.testing.assert_allclose(got["assignments"], want["assignments"],
                               atol=2e-3)
    assert np.isfinite(got["assignments"]).all()


@pytest.mark.parametrize("name", ["p1_matcher_only", "p2_single_object",
                                  "p3_multi_object", "p3_480p",
                                  "p4_ytvos_stream", "p5_train"])
def test_config_copy_matches_jax_config(name):
    """The port keeps its own copy of the config: every preset, the
    defaults, and the legacy-field fill of old checkpoints must agree."""
    assert preset(name).to_dict() == jax_preset(name).to_dict()
    old = jax_preset(name).to_dict()
    for field in ("decoder_obj_fine_level", "decoder_detail_basis_k"):
        del old["model"][field]          # a blob saved before these fields
    assert config_from_dict(old).to_dict() == \
        jax_config_from_dict(old).to_dict()
