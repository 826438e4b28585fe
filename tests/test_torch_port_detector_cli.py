"""The port's detector CLIs on the CPU at a small size:
train_proposal_torch.py (steps, metrics lines, held-out AP, --save / --init
through the flax msgpack, the refusals), its saved file served by
tools/extract_proposals_torch.py --params and read by flax, and
examples/full_system_synthetic_torch.py with its gates."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from dmm_net_tpu.models.proposal.maskrcnn import MaskRCNN as JaxMaskRCNN
from dmm_net_tpu_torch.weights import to_flax_variables

import train_proposal_torch

_ROOT = Path(__file__).resolve().parent.parent
_SMALL = ["--image-size", "64", "128", "--backbone", "resnet18",
          "--num-classes", "3", "--distinct-frames", "4", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU work here is small ops that torch would spread over
    every core; with other test processes on the host that oversubscribes
    it several times over (3 small train steps: 48 s at 8 threads, 6 s at
    2, on a loaded 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, _ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("proposal")
    save = tmp / "mrcnn.msgpack"
    r = train_proposal_torch.main([*_SMALL, "--steps", "2", "--batch", "2",
                                   "--eval-images", "2", "--save", str(save),
                                   "--logdir", str(tmp / "log")])
    return tmp, save, r


def test_train_proposal_cli_trains_scores_and_saves(trained):
    tmp, save, r = trained
    assert len(r["history"]) == 2 and len(r["step_times"]) == 2
    for h in r["history"]:
        assert set(h) == {"step", "rpn_cls", "rpn_reg", "box_cls", "box_reg",
                          "mask", "total", "grad_norm"}
        assert all(np.isfinite(v) for v in h.values())
    for ap in (r["box_ap"], r["mask_ap"]):
        assert set(ap) == {"mAP", "AP50", "AP75", "AR", "num_classes"}
    lines = [json.loads(x) for x in (tmp / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 2]          # step 1, then the two AP lines
    assert "total" in lines[0] and "box_AP50" in lines[1] and "mask_AP50" in lines[2]
    # the file is the JAX package's {"params", "batch_stats"} tree, read by flax
    flax_tree = serialization.msgpack_restore(save.read_bytes())
    shapes = jax.eval_shape(JaxMaskRCNN(image_size=(64, 128), backbone_name="resnet18",
                                        num_classes=3).init, jax.random.PRNGKey(0),
                            np.zeros((1, 64, 128, 3), np.float32))
    assert jax.tree_util.tree_structure(flax_tree) == jax.tree_util.tree_structure(shapes)
    mine = to_flax_variables(r["model"])
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(flax_tree),
                                jax.tree_util.tree_leaves_with_path(mine)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_train_proposal_cli_init_resumes_from_the_saved_file(trained):
    tmp, save, r = trained
    again = train_proposal_torch.main([*_SMALL, "--steps", "0", "--init", str(save),
                                       "--logdir", str(tmp / "log2")])
    want = r["model"].state_dict()
    got = again["model"].state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # one more step from it, on the video sampler
    more = train_proposal_torch.main([*_SMALL, "--steps", "1", "--init", str(save),
                                      "--data", "video", "--logdir", str(tmp / "log3")])
    assert np.isfinite(more["history"][0]["total"])


def test_train_proposal_cli_refuses_data_parallel():
    with pytest.raises(SystemExit, match="item 9"):
        train_proposal_torch.main([*_SMALL, "--data-parallel"])


def test_saved_detector_serves_extract_proposals(trained, tmp_path):
    """tools/extract_proposals_torch.py --params reads the saved file into
    the strict bridge and writes a cache json per frame."""
    import chip_smoke
    _, save, _ = trained
    root = chip_smoke.write_davis_tree(tmp_path / "DAVIS", train_seeds=(),
                                       val_seeds=(7404,), T=2, hw=(64, 128))
    extract = _load("tools/extract_proposals_torch.py", "extract_proposals_torch")
    extract.main(["--root", str(root), "--out", str(tmp_path / "cache"),
                  "--params", str(save), "--image-size", "64", "128",
                  "--backbone", "resnet18", "--num-classes", "3",
                  "--max-detections", "8", "--score-thresh", "0", "--device", "cpu"])
    files = sorted((tmp_path / "cache").glob("*/*.json"))
    assert len(files) == 2
    props = json.loads(files[0].read_text())
    assert props and set(props[0]) == {"bbox", "score", "rle"}


def test_full_system_example_runs_and_gates(trained, capsys):
    """frames -> the saved detector -> compact detections -> the engine ->
    J&F, beside the planted proposals' J&F and the recall; --min-recall
    above 1 fails the run after the report."""
    _, save, _ = trained
    example = _load("examples/full_system_synthetic_torch.py",
                    "full_system_synthetic_torch")
    with pytest.raises(SystemExit) as e:
        example.main(["--dmm", str(_ROOT / "artifacts" / "dmm128_fallback.msgpack"),
                      "--mrcnn", str(save), "--eval-seqs", "1", "--frames", "2",
                      "--chunk", "2", "--device", "cpu", "--min-recall", "1.01"])
    assert e.value.code == 1
    report = {line.split(":")[0].strip(): float(line.split(":")[1])
              for line in capsys.readouterr().out.splitlines()
              if line.startswith("  ") and ":" in line}
    assert 0.0 <= report["detector-proposal recall@0.5"] <= 1.0
    assert 0.0 <= report["J&F with DETECTOR proposals"] <= 1.0
    assert report["J&F with PLANTED proposals"] > 0.85   # the checkpoint
