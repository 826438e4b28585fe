"""The port's three quality A/B tools (tools/ab_*_torch.py) at a tiny size on
the CPU, in-process: each runs end to end, and its last JSON line carries
the keys of what the JAX tool reports (tools/ab_*.py: ab_480p's JSON line,
ab_logits_res's printed J&F per arm, ab_decoder_arch's per-variant result
dict), with the JAX tool's flags and variants; and the drill over several
seeds (tools/dayone_seeds_torch.py)."""

import ast
import json
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
import train_proposal_torch

_ROOT = Path(__file__).resolve().parent.parent
_CKPT = str(_ROOT / cs.CKPT)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module's tests run: the test runner
    puts several workers on the machine's cores, and PyTorch's default of
    one thread per core then oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_source(name):
    return (_ROOT / "tools" / f"{name}.py").read_text()


def _jax_flags(name):
    """The --flags the JAX tool's argparse declares."""
    tree = ast.parse(_jax_source(name))
    return {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"}


def _port_flags(name):
    tree = ast.parse((_ROOT / "tools" / f"{name}_torch.py").read_text())
    return {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"}


@pytest.fixture(scope="module")
def det(tmp_path_factory):
    """A seeded 4-class detector at 64x64 (train_proposal_torch.py --steps 0
    --save), for the tools that run the cache tool."""
    tmp = tmp_path_factory.mktemp("det")
    train_proposal_torch.main(["--device", "cpu", "--steps", "0", "--image-size",
                               "64", "64", "--num-classes", "4", "--save",
                               str(tmp / "det.msgpack"), "--logdir", str(tmp / "log")])
    return tmp / "det.msgpack"


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["ab_logits_res", "ab_480p", "ab_decoder_arch"])
def test_tools_keep_the_jax_flags(name):
    assert _port_flags(name) == _jax_flags(name) | {"--device"}


def test_ab_logits_res_tool(capsys):
    tool = cs.load_tool("ab_logits_res_torch")
    r = tool.main(["--ckpt", _CKPT, "--seqs", "1", "--frames", "2", "--cpu"])
    out = _last_json(capsys)
    assert out == json.loads(json.dumps(r))
    assert set(out) == {"ab_logits_res", "delta_per_seq", "device"}
    assert set(out["ab_logits_res"]) == {"full", "mask"}     # the JAX tool's arms
    src = _jax_source("ab_logits_res")
    assert 'for lr in ("full", "mask")' in src and "per-seq delta (mask - full)" in src
    for arm in out["ab_logits_res"].values():
        assert set(arm) == {"jf", "per_seq"} and len(arm["per_seq"]) == 1
        assert arm["jf"] > 0.85                              # trained weights
    assert out["delta_per_seq"] == [out["ab_logits_res"]["mask"]["per_seq"][0]
                                    - out["ab_logits_res"]["full"]["per_seq"][0]]


def test_ab_480p_tool(tmp_path, capsys, det):
    capsys.readouterr()
    tool = cs.load_tool("ab_480p_torch")
    r = tool.main(["--dmm", _CKPT, "--mrcnn", str(det), "--seeds", "7001",
                   "--frames", "2", "--workdir", str(tmp_path / "work"),
                   "--device", "cpu"])
    out = _last_json(capsys)
    assert out == json.loads(json.dumps(r))
    src = _jax_source("ab_480p")
    assert 'json.dumps({"ab_480p": rows,' in src and '"note":' in src
    assert set(out) == {"ab_480p", "note"}
    assert set(out["ab_480p"]) == {"256x448", "480x864"}
    for tag in out["ab_480p"]:
        assert f'"{tag}"' in src
        assert set(out["ab_480p"][tag]) == {"J", "F", "J&F", "fps"}
    assert (tmp_path / "work" / "res_480x864" / "seq0" / "00001.png").exists()


def test_dayone_seeds_tool(capsys, det):
    """tools/dayone_seeds_torch.py: the drill's commands per seed, each arm's
    J&F, then the arms' mean and minimum; planted proposals on the trained
    checkpoint find the objects."""
    capsys.readouterr()
    rows, summary = cs.load_tool("dayone_seeds_torch").main(
        ["--dmm", _CKPT, "--mrcnn", str(det), "--seeds", "7001", "--frames", "2",
         "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"dayone_seeds": summary}
    assert json.loads(lines[-2]) == rows[0] and rows[0]["seed"] == 7001
    assert set(summary) == {"detector", "detector_model_res", "planted",
                            "detector_kernels", "proposals"}
    assert rows[0]["planted"]["J&F"] > 0.85
    assert len(rows[0]["detections_per_frame"]) == 2
    props = rows[0]["proposals"]
    assert set(props) == {"recall@0.5", "recall@0.7", "best_iou", "best_iou_mean"}
    assert len(props["best_iou"]) == 2                   # the tree's two objects
    assert 0.0 <= props["recall@0.7"] <= props["recall@0.5"] <= 1.0
    assert set(summary["proposals"]) == {"recall@0.5", "recall@0.7", "best_iou_mean"}


def test_dayone_seeds_tool_planted_alone(capsys):
    """--mrcnn none: no detector, the planted arm alone, at the DMM file's
    own geometry (the fallback checkpoint's 128x224)."""
    capsys.readouterr()
    rows, summary = cs.load_tool("dayone_seeds_torch").main(
        ["--dmm", _CKPT, "--mrcnn", "none", "--seeds", "7001", "--frames", "2",
         "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"dayone_seeds": summary}
    assert set(rows[0]) == {"seed", "planted"} and set(summary) == {"planted"}
    assert rows[0]["planted"]["J&F"] > 0.85
    assert summary["planted"]["mean"] == rows[0]["planted"]["J&F"]


def test_dayone_seeds_proposal_quality(tmp_path):
    """The tool's recall and best IoU from a hand-made cache: on frame 0 the
    ground truth of both objects, on frame 1 object 1's mask and a copy of
    object 2's with a band cleared (IoU known), against each object's IoU
    computed here."""
    import numpy as np

    from dmm_net_tpu_torch.data.synthetic import write_native_davis_tree
    from dmm_net_tpu_torch.ops import rle as rle_codec

    tool = cs.load_tool("dayone_seeds_torch")
    root = write_native_davis_tree(str(tmp_path / "D"), T=2, seeds=(7001,))
    from dmm_net_tpu_torch.data.davis import DavisDataset
    ds = DavisDataset(root, image_size=tool.CACHE_HW)
    gts = [ds.load_annotation(p) for p in ds.annotation_paths("seq0")]
    o2 = gts[1] == 2
    ys = np.flatnonzero(o2.any(1))
    cut = o2.copy()
    cut[ys[: len(ys) * 2 // 5]] = False                  # 40% of its rows gone
    iou2 = cut.sum() / o2.sum()
    assert 0.5 < iou2 < 0.7
    frames = [[gts[0] == 1, gts[0] == 2], [gts[1] == 1, cut]]
    (tmp_path / "P" / "seq0").mkdir(parents=True)
    for t, masks in enumerate(frames):
        props = []
        for i, m in enumerate(masks):
            rle = rle_codec.encode(m)
            props.append({"bbox": [0, 0, 1, 1], "score": 1.0 - 0.1 * i,
                          "rle": {"size": [int(v) for v in rle["size"]],
                                  "counts": rle["counts"].decode("latin1")}})
        (tmp_path / "P" / "seq0" / f"{t:05d}.json").write_text(json.dumps(props))
    q = tool.proposal_quality(root, str(tmp_path / "P"))
    assert q["recall@0.5"] == 1.0
    assert q["recall@0.7"] == 0.75                       # frames: 1.0, 0.5
    np.testing.assert_allclose(q["best_iou"], [1.0, (1.0 + iou2) / 2], rtol=1e-12)
    assert q["best_iou_mean"] == np.mean(q["best_iou"])


def test_ab_decoder_arch_tool(capsys):
    tool = cs.load_tool("ab_decoder_arch_torch")
    jax_tool = cs.load_tool("ab_decoder_arch")        # imports no JAX at load
    assert tool.VARIANTS == jax_tool.VARIANTS
    with pytest.raises(SystemExit) as e:              # refused before training
        tool.main(["--variants", "base", "nope", "--cpu"])
    assert e.value.code == 2
    capsys.readouterr()
    r = tool.main(["--variants", "base", "objc3+shared_half", "--steps", "2",
                   "--size", "32", "--backbone", "resnet18", "--seqs", "1",
                   "--eval-frames", "2", "--distinct-batches", "1", "--cpu"])
    out = _last_json(capsys)
    assert out == json.loads(json.dumps({"ab_decoder_arch": r}))
    # the keys of the JAX tool's per-variant result (its run()'s return)
    ret = [n for n in ast.walk(ast.parse(_jax_source("ab_decoder_arch")))
           if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    want = {k.value for k in ret[-1].value.keys}
    assert want == {"jf", "per_seq", "loss", "steps_per_s", "compile_s", "knobs"}
    for name, res in out["ab_decoder_arch"].items():
        assert set(res) == want
        assert 0.0 <= res["jf"] <= 1.0 and len(res["per_seq"]) == 1
    assert out["ab_decoder_arch"]["objc3+shared_half"]["knobs"] == {
        "decoder_obj_fuse": "conv1", "decoder_obj_dim_fine": 16,
        "decoder_obj_fine_level": "c3", "decoder_dim_fine": 16}
