"""The port's YouTube-VOS serving path against the JAX package on the CPU:
the reader's streams, the submission writer, the local scorer, and
``infer_torch.py --dataset ytvos`` against ``infer.py --dataset ytvos``,
both run in-process. Trees come from chip_smoke.py's writer (synthetic
videos, PNG frames, an object that appears mid-video)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dmm_net_tpu.data import native_loader as jax_native_loader
from dmm_net_tpu.data import ytvos as jax_ytvos
from dmm_net_tpu.eval import ytvos_local as jyl
from dmm_net_tpu_torch.data import ytvos
from dmm_net_tpu_torch.eval import ytvos_local as yl
from dmm_net_tpu_torch.infer.batching import batch_sequence_streams
from dmm_net_tpu_torch.infer.engine import InferenceEngine
from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt

import chip_smoke as cs
import infer as jax_infer
import infer_torch

_ROOT = Path(__file__).resolve().parent.parent
_CKPT = str(_ROOT / cs.CKPT)
# two small videos: stems every 5, the last object first annotated at frame 3
# (video 0, ids 1 and 3) and 2 (video 1, ids 2, 4 and 5)
_SMALL = dict(seeds=(7401, 7402), ids=((1, 3), (2, 4, 5)), late=(3, 2), T=6,
              hw=(60, 90), stem_step=5)


@pytest.fixture
def jax_reads_with_pil(monkeypatch):
    """The JAX readers decode through their C++ loader when it is built,
    within +-1 of PIL; the port reads with PIL, so hold it to the JAX
    readers' PIL path (the oracle of tests/test_native_loader.py)."""
    monkeypatch.setattr(jax_native_loader, "_native", lambda: None)


def _tree(tmp_path, cache=True, **kw):
    root, props = tmp_path / "YTVOS", tmp_path / "props"
    gts, firsts = cs.write_ytvos_tree(root, cache=props if cache else None,
                                      **{**_SMALL, **kw})
    return str(root), str(props) if cache else None, gts, firsts


def _assert_streams_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        elif k != "frames":
            assert a[k] == b[k], k
    n = 0
    for x, y in zip(a["frames"], b["frames"]):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
        n += 1
    assert n == a["num_frames"]


@pytest.mark.parametrize("with_meta", [True, False])
@pytest.mark.parametrize("with_cache", [True, False])
def test_ytvos_stream_bit_equal(tmp_path, with_meta, with_cache, jax_reads_with_pil):
    """Without meta.json the videos and first frames come from the tree;
    without a cache only annotated frames get (ground-truth) proposals."""
    root, props, _, firsts = _tree(tmp_path, cache=with_cache)
    if not with_meta:
        (Path(root) / "valid" / "meta.json").unlink()
    kw = dict(image_size=(40, 56), max_objects=4, max_proposals=6,
              proposal_dir=props)
    port, ref = ytvos.YTVOSDataset(root, **kw), jax_ytvos.YTVOSDataset(root, **kw)
    assert port.videos == ref.videos == ["vid0", "vid1"]
    assert port.meta == ref.meta
    for vid in port.videos:
        assert port.object_first_frames(vid) == ref.object_first_frames(vid) \
            == firsts[vid]
        a, b = port.sequence_stream(vid), ref.sequence_stream(vid)
        live = a["live_from"][0, :len(firsts[vid])]
        assert live.tolist() == [int(s) // 5 for s in
                                 (firsts[vid][o] for o in a["object_ids"])]
        assert live.max() > 0                        # a mid-video object
        _assert_streams_equal(a, b)
    got = batch_sequence_streams([port.sequence_stream(v) for v in port.videos])
    want = batch_sequence_streams([ref.sequence_stream(v) for v in ref.videos])
    _assert_streams_equal(got, want)


@pytest.mark.parametrize("full_size", [None, (97, 131), (21, 30)])
def test_write_submission_pngs_equal(tmp_path, full_size):
    rng = np.random.RandomState(3)
    labels = rng.randint(0, 4, (3, 40, 56)).astype(np.uint8)
    stems = ["00000", "00005", "00010"]
    for mod, out in ((ytvos, tmp_path / "port"), (jax_ytvos, tmp_path / "jax")):
        mod.write_submission(str(out), "v", stems, labels, [2, 7, 9],
                             full_size=full_size)
    for stem in stems:
        with Image.open(tmp_path / "port" / "Annotations" / "v" / f"{stem}.png") as a, \
                Image.open(tmp_path / "jax" / "Annotations" / "v" / f"{stem}.png") as b:
            assert a.mode == b.mode == "P" and a.size == b.size
            assert a.size == (full_size or (40, 56))[::-1]
            assert np.array_equal(np.asarray(a), np.asarray(b))
            assert set(np.unique(np.asarray(a))) <= {0, 2, 7, 9}


def test_ytvos_scorer_matches_jax():
    rng = np.random.RandomState(5)
    stems = [f"{5 * t:05d}" for t in range(6)]
    gt = {s: rng.randint(0, 4, (33, 47)) for s in stems}
    pred = {s: np.where(rng.rand(33, 47) > 0.2, g, 0) for s, g in gt.items()}
    del pred[stems[2]]
    firsts = {1: "00000", 2: "00010", 3: "00025"}       # object 3: no later frame
    per = {"a": yl.evaluate_video(gt, pred, firsts),
           "b": yl.evaluate_video(gt, gt, {1: "00005"})}
    want = {"a": jyl.evaluate_video(gt, pred, firsts),
            "b": jyl.evaluate_video(gt, gt, {1: "00005"})}
    assert per.keys() == want.keys() and per["a"].keys() == {1, 2}
    for v in per:
        for o in want[v]:
            for k in ("J", "F"):
                assert abs(per[v][o][k] - want[v][o][k]) <= 1e-12
    meta = {"a": {"objects": {"1": {"category": "cat"}, "2": {"category": "dog"},
                              "3": {}}},
            "b": {"objects": {"1": {"category": "dog"}}}}
    split = yl.seen_split_from_meta(meta, ["cat"])
    assert split == jyl.seen_split_from_meta(meta, ["cat"])
    for seen in (None, split):
        a, b = yl.summarize(per, seen), jyl.summarize(want, seen)
        assert a.keys() == b.keys()
        for grp in a:
            for k in ("J", "F", "G"):
                assert (a[grp][k] is None) == (b[grp][k] is None)
                if a[grp][k] is not None:
                    assert abs(a[grp][k] - b[grp][k]) <= 1e-12


def _run_jax_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["infer.py"] + argv)
    jax_infer.main()


def _pngs(out, vid):
    d = Path(out) / "Annotations" / vid
    out = {}
    for p in sorted(d.glob("*.png")):
        with Image.open(p) as im:
            out[p.stem] = np.asarray(im)
    return out


def test_ytvos_cli_matches_jax_cli(tmp_path, monkeypatch, jax_reads_with_pil):
    """infer_torch.py --dataset ytvos (CPU) against infer.py --dataset ytvos
    on the fallback checkpoint: every submission PNG within 1e-3 of label
    mismatch, the same results.json keys; and the repaired fault: the
    engine run without live_from / tmpl_frames, as the CLI ran it before,
    matches the mid-video object from frame 0."""
    root, props, gts, firsts = _tree(tmp_path)
    common = ["--ckpt", _CKPT, "--dataset", "ytvos", "--ytvos-root", root,
              "--proposal-dir", props]
    infer_torch.main(common + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    _run_jax_cli(monkeypatch, common + ["--out", str(tmp_path / "jax")])
    got = json.loads((tmp_path / "port" / "results.json").read_text())
    want = json.loads((tmp_path / "jax" / "results.json").read_text())
    assert got.keys() == want.keys() and got["frames"] == want["frames"] == 12
    mism = []
    for vid in gts:
        a, b = _pngs(tmp_path / "port", vid), _pngs(tmp_path / "jax", vid)
        assert sorted(a) == sorted(b) == sorted(gts[vid])     # every meta stem
        for stem in a:
            assert a[stem].shape == (60, 90)
            mism.append((a[stem] != b[stem]).mean())
    assert np.mean(mism) < 1e-3, np.mean(mism)
    assert cs.ytvos_g(tmp_path / "port", gts, firsts) > 0.5    # objects found

    cfg, variables = load_msgpack_ckpt(_CKPT)
    ds = ytvos.YTVOSDataset(root, image_size=cfg.model.image_size,
                            proposal_dir=props, max_objects=cfg.matching.max_templates,
                            max_proposals=cfg.matching.max_proposals)
    engine = InferenceEngine(cfg, variables=variables, device="cpu")
    sd = batch_sequence_streams([ds.sequence_stream("vid1")])
    late = int(sd["live_from"][0, 2])
    fixed = engine.run_stream_chunked(sd["frames"], sd["tmpl_masks"], sd["tmpl_valid"],
                                      sd["first_frame"], live_from=sd["live_from"],
                                      tmpl_frames=sd["tmpl_frames"])
    sd = batch_sequence_streams([ds.sequence_stream("vid1")])
    before = engine.run_stream_chunked(sd["frames"], sd["tmpl_masks"],
                                       sd["tmpl_valid"], sd["first_frame"])
    assert late == 2
    assert (fixed["assignments"][:late, 0, 2] == 0).all()
    assert not (fixed["labels"][:late] == 3).any()
    np.testing.assert_allclose(before["assignments"][:late, 0, 2].sum(-1), 1.0,
                               atol=1e-3)
    assert (before["labels"] != fixed["labels"]).mean() > 1e-3


def test_per_frame_refuses_mid_video_objects(tmp_path, monkeypatch,
                                             jax_reads_with_pil):
    root, props, _, _ = _tree(tmp_path, cache=False)
    args = ["--ckpt", _CKPT, "--dataset", "ytvos", "--ytvos-root", root,
            "--per-frame", "--out", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as port:
        infer_torch.main(args + ["--device", "cpu"])
    with pytest.raises(SystemExit) as ref:
        _run_jax_cli(monkeypatch, args)
    assert str(port.value) == str(ref.value) == infer_torch.PER_FRAME_LIVE_FROM
    assert not (tmp_path / "out" / "Annotations").exists()


@pytest.mark.parametrize("run", ["as_saved", "kernels"])
def test_ytvos_reference_values(tmp_path, monkeypatch, jax_reads_with_pil, run):
    """chip_smoke.py phase 6c holds the card to the JAX package's overall G
    on its YouTube-VOS tree; recompute that reference (infer.py and the JAX
    scorer) here, and the port's on the CPU beside it."""
    root, props = tmp_path / "YTVOS", tmp_path / "props"
    gts, firsts = cs.write_ytvos_tree(root, cache=props, **cs.YTVOS_VIDEOS)
    args = ["--ckpt", _CKPT, "--dataset", "ytvos", "--ytvos-root", str(root),
            "--proposal-dir", str(props), "--chunk", str(cs.YTVOS_CHUNK)]
    sets = ["--set", *cs.ckpt_sets(run)]
    _run_jax_cli(monkeypatch, args + ["--out", str(tmp_path / "jax")] + sets)
    infer_torch.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"] + sets)
    per_video = {vid: jyl.evaluate_video(gts[vid], _pngs(tmp_path / "jax", vid),
                                         firsts[vid]) for vid in gts}
    jax_g = jyl.summarize(per_video)["overall"]["G"]
    port_g = cs.ytvos_g(tmp_path / "port", gts, firsts)
    assert abs(jax_g - cs.JAX_YTVOS_G[run]) < 2e-3, jax_g
    assert abs(port_g - jax_g) < 0.01 and port_g > 0.5
    mism = [(a != b).mean() for vid in gts
            for a, b in zip(_pngs(tmp_path / "port", vid).values(),
                            _pngs(tmp_path / "jax", vid).values())]
    assert len(mism) == 60 and np.mean(mism) < 1e-3
