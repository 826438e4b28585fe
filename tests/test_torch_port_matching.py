"""The port's PGD path (ops/projections.py, ``pgd_match``) and Hungarian
decode (``hard_assignment_hungarian``, the engine's two-phase step) against
the JAX package, plus ``run_sequence_chunked`` on the PGD solver."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmm_net_tpu.infer.engine import InferenceEngine as JaxEngine
from dmm_net_tpu.ops import projections as jproj
from dmm_net_tpu.ops.matching import hard_assignment_hungarian as jax_hungarian
from dmm_net_tpu.ops.matching import match as jax_match
from dmm_net_tpu_torch.config import config_from_dict
from dmm_net_tpu_torch.infer.engine import InferenceEngine
from dmm_net_tpu_torch.ops import projections as proj
from dmm_net_tpu_torch.ops.matching import hard_assignment_hungarian, match
from tests.test_torch_port_engine import _jax_variables, _slice_cfg
from tests.test_torch_port_legacy import _small_inputs


def _padded(seed, B=3, M=8, N=64, scale=1.0):
    """A padded batch: element 0 full, element 1 with padded rows and
    columns, element 2 with no valid row."""
    rng = np.random.RandomState(seed)
    X = (rng.randn(B, M, N) * scale).astype(np.float32)
    rm = np.ones((B, M), bool)
    cm = np.ones((B, N), bool)
    rm[1, 5:] = False
    cm[1, 40:] = False
    cm[1, 3] = False
    rm[2] = False
    return X, rm, cm


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


@pytest.mark.parametrize("name", ["simplex", "simplex_radius", "capped",
                                  "rows", "cols", "dykstra"])
def test_projections_match_jax(name):
    X, rm, cm = _padded(0, scale=0.5)
    if name in ("simplex", "simplex_radius", "capped"):
        mask = rm[..., :, None] & cm[..., None, :]
        kw = {"radius": 2.5} if name == "simplex_radius" else {}
        fj = {"capped": jproj.project_capped_simplex}.get(name, jproj.project_simplex)
        ft = {"capped": proj.project_capped_simplex}.get(name, proj.project_simplex)
        want = fj(*_j(X, mask), **kw)
        got = ft(*_t(X, mask), **kw)
    else:
        fj, ft = {"rows": (jproj.project_rows_simplex, proj.project_rows_simplex),
                  "cols": (jproj.project_cols_capped, proj.project_cols_capped),
                  "dykstra": (jproj.dykstra_project, proj.dykstra_project)}[name]
        want = fj(*_j(X, rm, cm))
        got = ft(*_t(X, rm, cm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("solver", ["pgd", "sinkhorn"])
def test_match_matches_jax_at_p1_shapes(solver):
    """p1_matcher_only: M=8, N=64, padded; PGD at its defaults."""
    C, rm, cm = _padded(1)
    C = np.abs(C) / 3.0
    want = np.asarray(jax_match(*_j(C, rm, cm), solver=solver))
    got = match(*_t(C, rm, cm), solver=solver).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[~rm] == 0).all() and (got.transpose(0, 2, 1)[~cm] == 0).all()
    if solver == "pgd":
        np.testing.assert_allclose(got.sum(-1)[rm], 1.0, atol=1e-5)
        assert got.sum(-2)[cm].max() <= 1.0 + 1e-4


def test_hungarian_indices_equal_jax():
    X, rm, cm = _padded(2, M=6, N=9)
    X = np.abs(X)
    want3 = jax_hungarian(X, rm, cm)
    got3 = hard_assignment_hungarian(X, rm, cm)
    np.testing.assert_array_equal(got3, want3)
    assert got3.dtype == np.int32 and (got3[2] == -1).all()
    for b in range(2):
        used = got3[b][got3[b] >= 0]
        assert len(set(used.tolist())) == len(used)      # one-to-one
    np.testing.assert_array_equal(hard_assignment_hungarian(X[1], rm[1], cm[1]),
                                  jax_hungarian(X[1], rm[1], cm[1]))


def test_hungarian_run_sequence_matches_jax():
    """The unfused matcher keeps the JAX side's compile short; the card runs
    the fused kernels on this path (tests/test_torch_port_cuda.py)."""
    cfg = _slice_cfg("float32").override(**{"matching.decode": "hungarian",
                                            "matching.use_pallas": False})
    frames, tmpl, valid, items = _small_inputs(3, T=3)
    jmodel, variables = _jax_variables(cfg, frames, tmpl, valid, items)
    want = JaxEngine(cfg, model=jmodel, variables=variables).run_sequence(
        iter(items), tmpl, valid, frames[0])
    port = InferenceEngine(config_from_dict(cfg.to_dict()), variables=variables,
                           device="cpu")
    got = port.run_sequence(iter(items), tmpl, valid, frames[0])
    X = got["assignments"]
    np.testing.assert_array_equal(X, want["assignments"])
    assert set(np.unique(X)) <= {0.0, 1.0}
    np.testing.assert_array_equal(X.sum(-1)[:, valid], 1.0)
    assert X.sum(-2).max() <= 1.0                   # no proposal used twice
    assert (got["labels"] != want["labels"]).mean() < 1e-3
    assert port.hungarian_host_s > 0                # scipy ran on the host
    with pytest.raises(ValueError, match="full-mask"):
        compact = [{"frame": items[0]["frame"],
                    "prop_boxes": np.zeros((2, 8, 4), np.float32),
                    "prop_masks28": np.zeros((2, 8, 28, 28), np.float32),
                    "prop_valid": items[0]["prop_valid"]}]
        port.run_sequence(iter(compact), tmpl, valid, frames[0])


def test_hungarian_rejected_by_chunked_paths():
    cfg = _slice_cfg("float32").override(**{"matching.decode": "hungarian"})
    frames, tmpl, valid, items = _small_inputs(4, T=2)
    props = np.stack([it["prop_masks"] for it in items])
    pvalid = np.stack([it["prop_valid"] for it in items])
    port = InferenceEngine(config_from_dict(cfg.to_dict()), device="cpu")
    jeng = JaxEngine(cfg)
    for where, call in [
            ("run_sequence_chunked", lambda e: e.run_sequence_chunked(
                frames, props, pvalid, tmpl, valid, chunk=2)),
            ("run_stream_chunked", lambda e: e.run_stream_chunked(
                iter(items), tmpl, valid, frames[0], chunk=2))]:
        with pytest.raises(ValueError) as jerr:
            call(jeng)
        with pytest.raises(ValueError) as perr:
            call(port)
        assert str(perr.value) == str(jerr.value)
        assert where in str(perr.value)


def test_pgd_run_sequence_chunked_matches_jax():
    """The PGD solver end to end (unfused matcher), T=5 in chunks of 2."""
    cfg = _slice_cfg("float32").override(**{
        "matching.solver": "pgd", "matching.use_pallas": False,
        "matching.pgd_iters": 4, "matching.dykstra_iters": 4})
    frames, tmpl, valid, items = _small_inputs(5)
    jmodel, variables = _jax_variables(cfg, frames, tmpl, valid, items)
    props = np.stack([it["prop_masks"] for it in items])
    pvalid = np.stack([it["prop_valid"] for it in items])
    want = JaxEngine(cfg, model=jmodel, variables=variables) \
        .run_sequence_chunked(frames, props, pvalid, tmpl, valid, chunk=2)
    port = InferenceEngine(config_from_dict(cfg.to_dict()), variables=variables,
                           device="cpu")
    got = port.run_sequence_chunked(frames, props, pvalid, tmpl, valid, chunk=2)
    assert got["labels"].shape == (5, 2, 64, 96)
    assert (got["labels"] != want["labels"]).mean() < 1e-3
    np.testing.assert_allclose(got["assignments"], want["assignments"],
                               atol=2e-4)
    X = got["assignments"]
    np.testing.assert_allclose(X.sum(-1)[:, valid], 1.0, atol=1e-4)
    assert X.sum(-2).max() <= 1.0 + 1e-4 and (X[:, ~valid] == 0).all()
