"""The port's profiling and debug utilities (mirroring tests/test_utils.py),
its two weight importers against the JAX package's, and its remaining
examples, on the CPU at small sizes.

The importers take seeded state dicts in torchvision's layouts (the JAX
package's test builders, and chip_smoke.py's own): the JAX importer and
the port's must write the same msgpack bytes; the port's ResNet filled
from one must give the JAX ResNet's features, and the port's detector
heads filled from one must compute what torchvision's heads compute with
the raw state dict (fc6 over a CHW flatten, a convolving transposed conv).
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import serialization

from dmm_net_tpu.models.resnet import ResNet18 as JaxResNet18
from dmm_net_tpu_torch.models.proposal import MaskRCNN
from dmm_net_tpu_torch.models.resnet import backbone_by_name
from dmm_net_tpu_torch.utils.checkpoint import msgpack_restore, msgpack_serialize
from dmm_net_tpu_torch.utils.debug import checked, enable_nan_debugging
from dmm_net_tpu_torch.utils.profiling import StageTimer, trace
from dmm_net_tpu_torch.weights import load_flax_variables
from test_torch_port_train_step import few_threads  # noqa: F401
from tests.test_maskrcnn_import import _fake_torchvision_maskrcnn_sd
from tests.test_weight_import import _fake_torch_resnet_sd
from tools import import_maskrcnn_weights as jax_mrcnn_import
from tools import import_maskrcnn_weights_torch as mrcnn_import
from tools import import_torch_weights as jax_resnet_import
from tools import import_torch_weights_torch as resnet_import

import chip_smoke as cs

_ROOT = Path(__file__).resolve().parent.parent


# -- profiling and debug ------------------------------------------------------

def test_checked_raises_on_nan():
    g = checked(torch.log)
    assert np.isfinite(float(g(torch.tensor(2.0))))
    with pytest.raises(FloatingPointError, match="not finite"):
        g(torch.tensor(-1.0))
    with pytest.raises(FloatingPointError, match=r"\['x'\]"):
        checked(lambda: {"x": np.array([np.inf]), "n": 3})()


def test_stage_timer_accumulates():
    t = StageTimer()
    with t.stage("a", sync=torch.ones(3)):
        sum(range(1000))
    with t.stage("a") as out:
        out["sync"] = {"y": [torch.zeros(2)]}
    with t.stage("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    rep = t.report()
    assert "a" in rep and "ms/call" in rep
    assert rep.splitlines()[0].startswith("a ")      # the larger total first


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert any("mm" in n for n in names), names
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])


def test_nan_debugging_raises_at_the_first_module_then_turns_off():
    net = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.ReLU(),
                              torch.nn.Linear(2, 1))
    with torch.no_grad():
        net[2].bias.fill_(float("nan"))
    x = torch.ones(1, 2)
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="^Linear: output"):
            net(x)
        with pytest.raises(RuntimeError, match="SqrtBackward0.*nan"):
            # the forward is finite; the backward of sqrt at 0 is 0 * inf
            (torch.zeros(1, requires_grad=True).sqrt() * 0).sum().backward()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(net(x)).all()                 # no hook left behind


# -- weight importers ----------------------------------------------------------

@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_importer_writes_the_jax_importers_bytes(arch, tmp_path):
    """The port's CLI on a released-checkpoint-shaped .pth (a
    {"state_dict"} wrapper, DataParallel "module." prefixes, non-tensor
    entries) writes the bytes that flax writes for the JAX importer's tree."""
    stages = resnet_import.STAGE_SIZES[arch]
    bottleneck = arch == "resnet50"
    sd = _fake_torch_resnet_sd(stages, bottleneck, np.random.RandomState(3))
    params, stats = jax_resnet_import.load_torch_resnet(sd, stages, bottleneck)
    want = serialization.msgpack_serialize({"params": params,
                                            "batch_stats": stats})
    pth, out = tmp_path / "r.pth", tmp_path / "r.msgpack"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                               for k, v in sd.items()}, "epoch": 3}, pth)
    resnet_import.main(["--pth", str(pth), "--out", str(out), "--arch", arch])
    assert out.read_bytes() == want


def test_resnet_importer_loads_the_ports_resnet_like_jax():
    """R-18 filled by load_into_resnet gives the JAX ResNet-18's features on
    the JAX importer's tree (float32, 1e-4 of each level's largest value)."""
    rng = np.random.RandomState(1)
    sd = _fake_torch_resnet_sd((2, 2, 2, 2), False, rng)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    params, stats = jax_resnet_import.load_torch_resnet(sd, (2, 2, 2, 2), False)
    want = JaxResNet18(dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    net = backbone_by_name("resnet18", dtype=torch.float32)
    resnet_import.load_into_resnet(net, sd)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k


@pytest.fixture(scope="module")
def mrcnn_sd():
    return _fake_torchvision_maskrcnn_sd(np.random.RandomState(0))


def test_maskrcnn_importer_writes_the_jax_importers_bytes(mrcnn_sd, tmp_path):
    want = serialization.msgpack_serialize(dict(zip(
        ("params", "batch_stats"),
        jax_mrcnn_import.load_torchvision_maskrcnn(mrcnn_sd))))
    got = msgpack_serialize(dict(zip(
        ("params", "batch_stats"),
        mrcnn_import.load_torchvision_maskrcnn(mrcnn_sd))))
    assert got == want
    # chip_smoke.py's own seeded state dict has torchvision's keys and shapes
    own = cs.torchvision_maskrcnn_state_dict(0)
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in mrcnn_sd.items()}


def test_maskrcnn_importer_heads_compute_torchvisions_heads(mrcnn_sd):
    """The full-width detector (R-50-FPN, 81 classes) loads the import
    strictly and runs; its box and mask heads on seeded ROI features equal
    torchvision's heads computed from the raw state dict."""
    det = MaskRCNN(image_size=(64, 128), num_classes=81, pre_nms_top_n=16,
                   post_nms_top_n=8, max_detections=4, device="cpu")
    params, stats = mrcnn_import.load_torchvision_maskrcnn(mrcnn_sd)
    load_flax_variables(det, {"params": params, "batch_stats": stats})
    sd = {k: torch.from_numpy(v) for k, v in mrcnn_sd.items()}
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = det(torch.rand(1, 3, 64, 128, generator=gen))
        assert torch.isfinite(out["boxes"]).all()
        x = torch.randn(5, 256, 7, 7, generator=gen)
        h = F.relu(F.linear(x.flatten(1), sd["roi_heads.box_head.fc6.weight"],
                            sd["roi_heads.box_head.fc6.bias"]))
        h = F.relu(F.linear(h, sd["roi_heads.box_head.fc7.weight"],
                            sd["roi_heads.box_head.fc7.bias"]))
        scores, deltas = det.box_head(x)
        for got, name in ((scores, "cls_score"), (deltas, "bbox_pred")):
            want = F.linear(h, sd[f"roi_heads.box_predictor.{name}.weight"],
                            sd[f"roi_heads.box_predictor.{name}.bias"])
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        m = torch.randn(3, 256, 14, 14, generator=gen)
        y = m
        for i in range(1, 5):
            y = F.relu(F.conv2d(y, sd[f"roi_heads.mask_head.mask_fcn{i}.weight"],
                                sd[f"roi_heads.mask_head.mask_fcn{i}.bias"],
                                padding=1))
        p = "roi_heads.mask_predictor"
        y = F.relu(F.conv_transpose2d(y, sd[f"{p}.conv5_mask.weight"],
                                      sd[f"{p}.conv5_mask.bias"], stride=2))
        want = F.conv2d(y, sd[f"{p}.mask_fcn_logits.weight"],
                        sd[f"{p}.mask_fcn_logits.bias"])
        torch.testing.assert_close(det.mask_head(m), want, rtol=1e-4, atol=1e-4)


def test_maskrcnn_importer_cli_round_trip(mrcnn_sd, tmp_path):
    """The CLI reads a .pth and writes a file both packages' readers take."""
    pth, out = tmp_path / "m.pth", tmp_path / "m.msgpack"
    torch.save({k: torch.from_numpy(v) for k, v in mrcnn_sd.items()}, pth)
    mrcnn_import.main(["--pth", str(pth), "--out", str(out)])
    blob = out.read_bytes()
    port, flax = msgpack_restore(blob), serialization.msgpack_restore(blob)
    pl = jax.tree_util.tree_leaves_with_path(port)
    fl = jax.tree_util.tree_leaves_with_path(flax)
    assert [p for p, _ in pl] == [p for p, _ in fl]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(pl, fl))


# -- examples ------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, _ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_synthetic_example_loss_falls():
    r = _example("train_synthetic_torch").main(["--device", "cpu",
                                                 "--steps", "6"])
    assert len(r["losses"]) == 6 and np.isfinite(r["losses"]).all()
    assert r["losses"][-1] < r["losses"][0]


def test_infer_demo_example_matches_the_jax_demo(tmp_path, monkeypatch, capsys):
    """The port's demo and the JAX package's print the same matcher J&F
    (its aggregated masks) and proposal ceiling, on the same video."""
    monkeypatch.setattr(sys, "argv", ["infer_demo.py", "--out",
                                      str(tmp_path / "jax")])
    spec = importlib.util.spec_from_file_location(
        "jax_infer_demo", _ROOT / "examples" / "infer_demo.py")
    jax_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_demo)
    jax_demo.main()
    lines = dict(line.split("=", 1) for line in capsys.readouterr().out
                 .splitlines() if "J&F =" in line)
    r = _example("infer_demo_torch").main(["--device", "cpu", "--out",
                                           str(tmp_path / "port")])
    want = {k.split()[0]: float(v.split()[0]) for k, v in lines.items()}
    assert abs(r["aggregated"]["J&F"] - want["matcher-aggregated"]) <= 1e-3
    assert abs(r["oracle"]["J&F"] - want["oracle-assignment"]) <= 1e-3
    assert abs(r["aggregated"]["J&F"] - cs.JAX_INFER_DEMO_AGG_JF) <= 1e-3
    assert len(list((tmp_path / "port").glob("*.png"))) == 6


def test_matcher_only_example_recovers_the_planted_assignment(tmp_path):
    r = _example("matcher_only_torch").main(
        ["--device", "cpu", "--fixtures", str(tmp_path / "fx.npz")])
    assert r["accuracy"] > 0.9
    assert (tmp_path / "fx.npz").exists()
