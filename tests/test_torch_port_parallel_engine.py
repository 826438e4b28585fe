"""The port's streaming engine on a data-parallel mesh (two gloo ranks
spawned on the CPU) against its single-device engine and against the JAX
package's engine on the 8-fake-device mesh of tests/conftest.py (a data
axis of 2); then infer_torch.py --data-parallel inside spawned ranks
against infer.py --data-parallel on a DAVIS-layout tree.

Labels may differ only where logits tie exactly (tests/test_parallel.py's
rule: a label mismatch below 1e-4 between partitionings; 1e-3 against the
JAX package, tests/test_torch_port_engine.py's float32 bound)."""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from dmm_net_tpu.infer.engine import InferenceEngine as JaxEngine
from dmm_net_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dmm_net_tpu_torch.config import config_from_dict
from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
from dmm_net_tpu_torch.infer.engine import InferenceEngine
from dmm_net_tpu_torch.parallel import launch
from test_torch_port_cli import _ARTIFACT, _davis_tree
from test_torch_port_cli import jax_reads_with_pil  # noqa: F401
from test_torch_port_engine import _jax_variables, _slice_cfg, _stream
from test_torch_port_train_step import few_threads  # noqa: F401

import chip_smoke as cs
import infer as jax_infer
import torch_port_ranks as ranks


@pytest.fixture(scope="module")
def engines():
    """p3's compact stream cut to R-18 at 64x96 (B1 and B2 as their plain
    versions), B=4 sequences of 4 frames, chunk 2. The first two sequences
    (rank 0's) track one object, the last two three: the object bucket
    must be the whole batch's on every rank, or the ranks' assignments
    would not even gather."""
    cfg = _slice_cfg("float32")
    frames, tmpl, valid, items = _stream(3, B=4)
    valid[:2, 1:] = False
    model, variables = _jax_variables(cfg, frames, tmpl, valid, items)
    seqs = [synthetic_sequence(seed=100 + b, T=3, H=64, W=96, num_objects=2,
                               num_proposals=8) for b in range(4)]
    full_grid = (np.stack([s["frames"] for s in seqs], 1),
                 np.stack([s["prop_masks"] for s in seqs], 1),
                 np.stack([s["prop_valid"] for s in seqs], 1),
                 np.stack([np.pad(s["tmpl_masks"], ((0, 2), (0, 0), (0, 0)))
                           for s in seqs]),
                 np.stack([np.pad(s["tmpl_valid"], (0, 2)) for s in seqs]), 2)
    jax_mesh = JaxEngine(cfg, model=model, variables=variables,
                         mesh=jax_make_mesh(data=2)).run_stream_chunked(
        iter(items), tmpl, valid, frames[0], chunk=2)
    port_cfg = config_from_dict(cfg.to_dict())
    engine = InferenceEngine(port_cfg, variables=variables, device="cpu")
    single = engine.run_stream_chunked(iter(items), tmpl, valid, frames[0],
                                       chunk=2)
    *arrays, k = full_grid
    single["chunked"] = engine.run_sequence_chunked(*arrays, chunk=k)
    dp = launch(ranks.engine_run, 2, "cpu", port_cfg.to_dict(), variables,
                items, tmpl, valid, frames[0], 2, "cpu", full_grid)
    return valid, jax_mesh, single, dp


def test_two_rank_engine_matches_single_device_and_jax_mesh(engines):
    valid, jax_mesh, single, dp = engines
    for r in dp:
        got = r["stream"]
        assert got["labels"].shape == single["labels"].shape == (4, 4, 64, 96)
        assert got["assignments"].shape == (4, 4, 4, 8)
        assert (got["labels"] != single["labels"]).mean() < 1e-4
        np.testing.assert_allclose(got["assignments"], single["assignments"],
                                   rtol=1e-5, atol=1e-5)
        assert (got["labels"] != jax_mesh["labels"]).mean() < 1e-3
        np.testing.assert_allclose(got["assignments"], jax_mesh["assignments"],
                                   atol=2e-3)
    assert len(np.unique(single["labels"])) > 1
    np.testing.assert_array_equal(dp[0]["stream"]["labels"],
                                  dp[1]["stream"]["labels"])
    assert not dp[0]["stream"]["assignments"][:, :2, 1:].any()


def test_two_rank_sequence_chunked_matches_single_device(engines):
    """run_sequence_chunked (full-grid proposals, no bucketing) on two
    ranks: the single-device engine's labels and assignments, T=3 in
    chunks of 2."""
    _, _, single, dp = engines
    want = single["chunked"]
    for r in dp:
        got = r["chunked"]
        assert got["labels"].shape == want["labels"].shape == (3, 4, 64, 96)
        assert (got["labels"] != want["labels"]).mean() < 1e-4
        np.testing.assert_allclose(got["assignments"], want["assignments"],
                                   rtol=1e-5, atol=1e-5)


def test_two_rank_engine_refuses_a_batch_that_does_not_divide(engines):
    _, _, _, dp = engines
    for r in dp:
        assert r["refusal"] == "sequence batch 3 not divisible by mesh data axis 2"


def _pngs(out, name, T):
    return np.stack([np.asarray(Image.open(os.path.join(out, name,
                                                        f"{t:05d}.png")))
                     for t in range(T)])


def test_infer_cli_data_parallel_matches_jax_cli(tmp_path, monkeypatch,
                                                 jax_reads_with_pil):  # noqa: F811
    """Three sequences on two ranks (the last group padded with a
    duplicate) against infer.py --data-parallel on the fake mesh (one group
    of eight): the same PNGs within tests/test_torch_port_cli.py's label
    mismatch, every sequence's J&F, and results.json's data_parallel."""
    root = str(tmp_path / "DAVIS")
    names = _davis_tree(root, seeds=(7003, 7004, 7005), T=3)
    common = ["--ckpt", str(_ARTIFACT), "--davis-root", root, "--chunk", "2",
              "--data-parallel"]
    monkeypatch.setattr(sys, "argv", ["infer.py", *common,
                                      "--out", str(tmp_path / "jax")])
    jax_infer.main()
    out = str(tmp_path / "port")
    r0, r1 = launch(ranks.cli_runs, 2, "cpu", str(cs.ROOT), "infer_torch",
                    [[*common, "--out", out, "--device", "cpu"]], True)
    assert r1 == [None]
    got = r0[0]
    with open(tmp_path / "jax" / "results.json") as f:
        want = json.load(f)
    with open(os.path.join(out, "results.json")) as f:
        assert json.load(f) == got
    assert got["data_parallel"] == 2 and want["data_parallel"] == 8
    assert got["frames"] == want["frames"] == 9
    for name in names:
        a = _pngs(out, name, 3)
        b = _pngs(str(tmp_path / "jax"), name, 3)
        assert (a != b).mean() < 1e-3, name
        assert abs(got["sequences"][name]["J&F"]
                   - want["sequences"][name]["J&F"]) <= 1e-3, name
    assert got["J&F"] > 0.85
