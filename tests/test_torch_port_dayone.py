"""The day-one drill of the port (docs/DAYONE_torch.md), the counterpart of
tests/test_dayone_cli.py: the runbook's commands run in-process on a
synthetic DAVIS-layout tree at the native 854x480
(``data/synthetic.write_native_davis_tree``), decoded by the port's C++
loader.

- the fallback drill: ``infer_torch.py`` with the git-tracked
  ``artifacts/dmm128_fallback.msgpack``, J&F > 0.85 and within 0.01 of the
  JAX package's on the same tree (``chip_smoke.JAX_DAYONE_FALLBACK_JF``,
  recomputed by the ``slow`` reference test with the JAX package's own
  native decode);
- the flagship drill on ``runs/torch/``'s artifacts
  (tools/regen_artifacts_torch.sh): skips while they are missing, fails
  then under ``REQUIRE_ARTIFACTS=1``; its gate is J&F > 0.90, as the JAX
  drill's (``chip_smoke.flagship_drill`` runs its commands);
- the example's ``--save`` blob, read by the JAX package.

Runs on the card too (tools/regen_artifacts_torch.sh ends with this file),
where JAX is absent: only the tests that compare with the JAX package
import it, and they skip there.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
import infer_torch
from dmm_net_tpu_torch.data.synthetic import write_native_davis_tree

_ROOT = Path(__file__).resolve().parent.parent
DMM_CKPT = _ROOT / "runs" / "torch" / "dmm448" / "dmm.msgpack"
MRCNN_CKPT = _ROOT / "runs" / "torch" / "proposal_video448" / "mrcnn.msgpack"
FALLBACK_CKPT = _ROOT / cs.CKPT
DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module's tests run: the test runner
    puts several workers on the machine's cores, and PyTorch's default of
    one thread per core then oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def fallback_drill(tmp_path, device=DEVICE, run="as_saved"):
    """infer_torch.py with the fallback checkpoint on the drill's tree
    (seed 7003, T=4, --chunk 4), as saved or on the kernels
    (``chip_smoke.ckpt_sets``): its results.json."""
    root = write_native_davis_tree(str(tmp_path / "DAVIS"), **cs.DAYONE_TREE)
    return infer_torch.main(["--ckpt", str(FALLBACK_CKPT), "--davis-root", root,
                             "--out", str(tmp_path / "results"), "--chunk", "4",
                             "--device", device, "--set", *cs.ckpt_sets(run)])


@pytest.mark.parametrize("run", ["as_saved", "kernels"])
def test_dayone_fallback_artifact_always_runs(tmp_path, run):
    """The git-tracked checkpoint through one infer_torch.py command on the
    native 854x480 tree, scored at native resolution: J&F > 0.85 (the JAX
    drill's gate) and within 0.01 of the JAX package's. Decoded natively
    wherever libjpeg's and libpng's headers are present."""
    assert FALLBACK_CKPT.exists(), "the tracked fallback checkpoint is missing"
    from dmm_net_tpu_torch.data import native_loader
    from dmm_net_tpu_torch.kernels import _build
    if not _build.host_headers_missing("imgloader"):
        assert native_loader.decoder() == "native", native_loader.reason()
    summary = fallback_drill(tmp_path, run=run)
    assert summary["dispatch"] == "chunked_scan" and summary["frames"] == 4
    assert summary["J&F"] > 0.85, summary
    assert abs(summary["J&F"] - cs.JAX_DAYONE_FALLBACK_JF[run]) < 0.01, summary["J&F"]


@pytest.mark.slow
@pytest.mark.parametrize("run", ["as_saved", "kernels"])
def test_dayone_fallback_reference_value(tmp_path, monkeypatch, run):
    """Recompute ``chip_smoke.JAX_DAYONE_FALLBACK_JF``: infer.py on the same
    tree with the JAX package's native decode (its loader built from
    native/loader into this test's directory), and the port's beside it."""
    pytest.importorskip("flax")
    import sys

    import infer as jax_infer
    from dmm_net_tpu.data import native_loader as jax_native_loader
    from torch_port_native import pin_both_native

    pin_both_native(monkeypatch, jax_native_loader, tmp_path)
    root = write_native_davis_tree(str(tmp_path / "DAVIS"), **cs.DAYONE_TREE)
    sets = ["--set", *cs.ckpt_sets(run)]
    monkeypatch.setattr(sys, "argv", [
        "infer.py", "--ckpt", str(FALLBACK_CKPT), "--davis-root", root,
        "--out", str(tmp_path / "jax"), "--chunk", "4", *sets])
    jax_infer.main()
    want = json.loads((tmp_path / "jax" / "results.json").read_text())
    got = infer_torch.main(["--ckpt", str(FALLBACK_CKPT), "--davis-root", root,
                            "--out", str(tmp_path / "port"), "--chunk", "4",
                            "--device", "cpu", *sets])
    print(f"fallback drill {run}: JAX {want['J&F']!r}, port {got['J&F']!r}")
    assert want["dispatch"] == "chunked_scan"
    assert abs(want["J&F"] - cs.JAX_DAYONE_FALLBACK_JF[run]) < 2e-3, want["J&F"]
    assert abs(got["J&F"] - want["J&F"]) < 0.01


def test_dayone_flagship_artifacts_to_native_jf(tmp_path):
    """runs/torch/'s artifacts -> the cache tool -> infer_torch.py ->
    native-resolution J&F, as docs/DAYONE_torch.md §1 runs them."""
    if not (DMM_CKPT.exists() and MRCNN_CKPT.exists()):
        msg = ("the port's flagship artifacts are missing: run "
               "tools/regen_artifacts_torch.sh on the card, then this drill")
        if os.environ.get("REQUIRE_ARTIFACTS"):
            pytest.fail(msg)
        pytest.skip(msg)
    summary, png_shape = cs.flagship_drill(DMM_CKPT, MRCNN_CKPT, tmp_path, DEVICE)
    print(f"flagship drill: J&F {summary['J&F']}")
    assert summary["dispatch"] == "chunked_scan" and summary["frames"] == 4
    assert summary["J&F"] > 0.90, summary
    assert png_shape == (256, 448)


def test_example_save_is_the_jax_blob(tmp_path):
    """examples/train_and_eval_synthetic_torch.py --save writes the JAX
    example's {"config", "variables"} msgpack: flax restores it to the same
    leaves as the port's reader and writes it back byte for byte, JAX's
    config_from_dict reads its config, and its tree is the JAX DMMNet's
    (paths, shapes and dtypes of jax.eval_shape of its init)."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from dmm_net_tpu.config import config_from_dict as jax_config_from_dict
    from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
    from dmm_net_tpu.models.dmm import init_frame_state
    from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt

    save = tmp_path / "dmm.msgpack"
    example = cs.load_tool("train_and_eval_synthetic_torch", "examples")
    example.main(["--device", "cpu", "--steps", "2", "--size", "32",
                  "--eval-frames", "2", "--distinct-batches", "1",
                  "--min-jf", "0", "--save", str(save)])
    data = save.read_bytes()
    blob = serialization.msgpack_restore(data)
    assert set(blob) == {"config", "variables"}
    assert serialization.msgpack_serialize(blob) == data
    port_cfg, port_vars = load_msgpack_ckpt(str(save))
    assert blob["config"] == port_cfg.to_dict()
    cfg = jax_config_from_dict(blob["config"])
    assert cfg.to_dict() == port_cfg.to_dict()
    got = jax.tree_util.tree_leaves_with_path(blob["variables"])
    mine = jax.tree_util.tree_leaves_with_path(port_vars)
    assert [p for p, _ in got] == [p for p, _ in mine]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, mine))

    S, M, N = 32, cfg.matching.max_templates, cfg.matching.max_proposals
    shapes = jax.eval_shape(
        JaxDMMNet(cfg, train=True).init, jax.random.PRNGKey(0),
        jnp.zeros((1, S, S, 3)), jnp.zeros((1, N, S, S)), jnp.ones((1, N), bool),
        jnp.zeros((1, M, 32)), jnp.ones((1, M), bool),
        init_frame_state(cfg, jnp.zeros((1, M, S, S))))
    want = jax.tree_util.tree_leaves_with_path(
        {k: shapes[k] for k in ("params", "batch_stats")})
    assert [p for p, _ in want] == [p for p, _ in got]
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for (_, a), (_, b) in zip(want, got))
