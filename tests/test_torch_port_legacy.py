"""The port's legacy decoder (``RefinementDecoder``, decoder_variant="legacy")
against the JAX package: the decoder alone, the DMM frame step, and
``run_sequence_chunked`` at p3 geometry cut to a small size."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmm_net_tpu.infer.engine import InferenceEngine as JaxEngine
from dmm_net_tpu.models.decoder import RefinementDecoder as JaxDecoder
from dmm_net_tpu.models.dmm import init_frame_state as jax_init_state
from dmm_net_tpu_torch.config import config_from_dict
from dmm_net_tpu_torch.infer.engine import InferenceEngine
from dmm_net_tpu_torch.models.decoder import RefinementDecoder
from dmm_net_tpu_torch.models.dmm import DMMNet
from dmm_net_tpu_torch.weights import convert_flax_variables, load_flax_variables
from tests.test_torch_port_engine import _jax_variables, _randomize, _slice_cfg

_CH = {"c2": 8, "c3": 12, "c4": 16, "c5": 20}
_SIZES = {"c2": (16, 24), "c3": (8, 12), "c4": (4, 6), "c5": (2, 3)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


# f32: the two packages differ by float summation order only (the 1e-4
# relative bound of tests/test_torch_parity.py). bf16: every conv rounds to
# bf16 (~4e-3 relative per rounding) and the resizes round once here, twice
# in JAX; these cases differ by 4e-3 to 8e-3, so 2e-2 leaves a 2.5x margin.
_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("fine_level,recurrent,out_hw,dtype", [
    ("c2", True, (64, 96), "float32"),      # full-resolution logits
    ("c2", True, (16, 24), "float32"),      # mask grid: the resize is identity
    ("c3", False, (16, 24), "float32"),
    ("c3", True, (64, 96), "float32"),
    ("c2", False, (64, 96), "bfloat16"),
    ("c3", True, (16, 24), "bfloat16"),
])
def test_refinement_decoder_matches_jax(fine_level, recurrent, out_hw, dtype):
    rng = np.random.RandomState(6)
    B, M, F = 2, 3, 8
    feats = {k: rng.randn(B, *_SIZES[k], _CH[k]).astype(np.float32)
             for k in _CH}
    agg = rng.rand(B, M, 16, 24).astype(np.float32)
    state = (rng.randn(B, M, 2, 3, F) * 0.5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jdec = JaxDecoder(features=F, recurrent=recurrent, dtype=jdt,
                      fine_level=fine_level)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = _randomize(jdec.init(jax.random.PRNGKey(1), jfeats,
                                     jnp.asarray(agg), jnp.asarray(state),
                                     out_hw=out_hw), 7)
    want_logits, want_state = jdec.apply(variables, jfeats, jnp.asarray(agg),
                                         jnp.asarray(state), out_hw=out_hw)

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    port = RefinementDecoder(_CH, features=F, recurrent=recurrent, dtype=tdt,
                             fine_level=fine_level)
    port.load_state_dict(convert_flax_variables(variables, port))
    tfeats = {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}
    with torch.no_grad():
        logits, new_state = port(tfeats, torch.from_numpy(agg),
                                 torch.from_numpy(state), out_hw=out_hw)
    assert logits.shape == (B, M) + out_hw and logits.dtype == torch.float32
    assert new_state.dtype == torch.float32 and new_state.shape == state.shape
    assert _rel(logits.numpy(), want_logits) < _TOL[dtype]
    if recurrent:
        assert _rel(new_state.numpy(), want_state) < _TOL[dtype]
    else:
        assert not new_state.any()


def _legacy_cfg():
    return _slice_cfg("float32").override(**{"model.decoder_variant": "legacy"})


def test_legacy_bridge_is_strict_both_ways():
    cfg = _legacy_cfg()
    _, variables = _jax_variables(cfg, *_small_inputs())
    model = DMMNet(config_from_dict(cfg.to_dict()), device="cpu")
    sd = convert_flax_variables(variables, model)
    assert set(sd) == set(model.state_dict())
    assert any(k.startswith("decoder.up_c2.lateral") for k in sd)
    dec = variables["params"]["decoder"]
    extra = {**variables, "params": {**variables["params"], "decoder": {
        **dec, "up_c1": dec["up_c2"]}}}
    with pytest.raises(KeyError):
        convert_flax_variables(extra, model)
    missing = {**variables, "params": {**variables["params"], "decoder": {
        k: v for k, v in dec.items() if k != "head"}}}
    with pytest.raises(KeyError):
        convert_flax_variables(missing, model)


def _small_inputs(seed=0, T=5, B=2, N=8, M=4, H=64, W=96):
    """Full-grid binary proposals (T, B, N, H, W) as uint8, which both
    packages accept unchanged and which keeps 0/1 exact."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (T, B, H, W, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:H, :W]
    tmpl = np.zeros((B, M, H, W), np.float32)
    valid = np.zeros((B, M), bool)
    valid[0, :3] = True
    valid[1, :2] = True
    props = np.zeros((T, B, N, H, W), np.uint8)
    for b in range(B):
        for m in range(3):
            cy, cx = rng.randint(10, H - 10), rng.randint(10, W - 10)
            tmpl[b, m] = ((yy - cy) ** 2 + (xx - cx) ** 2) < rng.randint(60, 300)
        for t in range(T):
            for n in range(N):
                cy, cx = rng.randint(8, H - 8), rng.randint(8, W - 8)
                props[t, b, n] = ((yy - cy) ** 2 + (xx - cx) ** 2) < \
                    rng.randint(40, 400)
    pvalid = rng.rand(T, B, N) > 0.2
    items = [{"frame": frames[t], "prop_masks": props[t],
              "prop_valid": pvalid[t]} for t in range(T)]
    return frames, tmpl, valid, items


def test_legacy_frame_step_matches_jax():
    cfg = _legacy_cfg()
    frames, tmpl, valid, items = _small_inputs(1)
    jmodel, variables = _jax_variables(cfg, frames, tmpl, valid, items)
    jeng = JaxEngine(cfg, model=jmodel, variables=variables)
    tf = jeng._init_feats(variables, jnp.asarray(frames[0]), jnp.asarray(tmpl))
    st = jax_init_state(cfg, jnp.asarray(tmpl))
    it = items[1]
    out, new_st = jmodel.apply(variables, jnp.asarray(it["frame"]),
                               jnp.asarray(it["prop_masks"]),
                               jnp.asarray(it["prop_valid"]), tf,
                               jnp.asarray(valid), st)

    port = DMMNet(config_from_dict(cfg.to_dict()), device="cpu")
    load_flax_variables(port, variables)
    with torch.no_grad():
        ttf = torch.from_numpy(np.array(tf))
        pout, pst = port(torch.from_numpy(it["frame"]),
                         torch.from_numpy(it["prop_masks"]),
                         torch.from_numpy(it["prop_valid"]), ttf,
                         torch.from_numpy(valid),
                         port.init_state(torch.from_numpy(tmpl)))
    assert pout.logits.shape == out.logits.shape == (2, 4, 16, 24)  # mask grid
    np.testing.assert_allclose(pout.assignment.numpy(), out.assignment,
                               atol=2e-4)
    assert _rel(pout.logits.numpy()[valid], np.asarray(out.logits)[valid]) < 1e-4
    assert _rel(pst.decoder_state.numpy(), new_st.decoder_state) < 1e-4


def test_legacy_run_sequence_chunked_matches_jax():
    """T=5 in chunks of 2: the last chunk is partial."""
    cfg = _legacy_cfg()
    frames, tmpl, valid, items = _small_inputs(2)
    jmodel, variables = _jax_variables(cfg, frames, tmpl, valid, items)
    props = np.stack([it["prop_masks"] for it in items])
    pvalid = np.stack([it["prop_valid"] for it in items])
    want = JaxEngine(cfg, model=jmodel, variables=variables) \
        .run_sequence_chunked(frames, props, pvalid, tmpl, valid, chunk=2)
    port = InferenceEngine(config_from_dict(cfg.to_dict()), variables=variables,
                           device="cpu")
    got = port.run_sequence_chunked(frames, props, pvalid, tmpl, valid, chunk=2)
    assert got["labels"].shape == want["labels"].shape == (5, 2, 64, 96)
    assert got["labels"].dtype == np.uint8
    assert len(np.unique(want["labels"])) > 1
    assert (got["labels"] != want["labels"]).mean() < 1e-3
    np.testing.assert_allclose(got["assignments"], want["assignments"],
                               atol=2e-4)
    assert (got["assignments"][:, ~valid] == 0).all()
