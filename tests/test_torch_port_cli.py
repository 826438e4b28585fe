"""The port's inference CLI (infer_torch.py) and the numpy modules under it
against the JAX package: the msgpack checkpoint reader, the synthetic
videos, the RLE codec, the DAVIS reader, the J&F scorer, the PNG writer,
stream batching and proposal compaction."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import jax
from flax import serialization

from dmm_net_tpu.config import config_from_dict as jax_config_from_dict
from dmm_net_tpu.data import native_loader as jax_native_loader
from dmm_net_tpu.data import synthetic as jsyn
from dmm_net_tpu.data.davis import DavisDataset as JaxDavis
from dmm_net_tpu.eval import davis_jf as jjf
from dmm_net_tpu.infer.batching import batch_sequence_streams as jax_batch
from dmm_net_tpu.infer.compact import compact_stream as jax_compact
from dmm_net_tpu.infer.engine import InferenceEngine as JaxEngine
from dmm_net_tpu.ops import rle as jrle
from dmm_net_tpu_torch.data import synthetic as syn
from dmm_net_tpu_torch.data.davis import DavisDataset
from dmm_net_tpu_torch.eval import davis_jf as jf
from dmm_net_tpu_torch.infer.batching import batch_sequence_streams
from dmm_net_tpu_torch.infer.compact import compact_stream
from dmm_net_tpu_torch.infer.engine import DAVIS_PALETTE, InferenceEngine
from dmm_net_tpu_torch.ops import rle
from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt
from test_torch_port_train_step import few_threads  # noqa: F401
from torch_port_native import pin_both_native, pin_port_to_pil

_ROOT = Path(__file__).resolve().parent.parent
_ARTIFACT = _ROOT / "artifacts" / "dmm128_fallback.msgpack"


def test_load_msgpack_ckpt_equals_flax():
    with open(_ARTIFACT, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    cfg, variables = load_msgpack_ckpt(str(_ARTIFACT))
    wl = jax.tree_util.tree_leaves_with_path(want["variables"])
    gl = jax.tree_util.tree_leaves_with_path(variables)
    assert [p for p, _ in gl] == [p for p, _ in wl] and len(gl) == 152
    for (p, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype and np.array_equal(g, w), p
    assert cfg.to_dict() == jax_config_from_dict(want["config"]).to_dict()


def test_load_msgpack_ckpt_rejects_orbax_dirs_and_other_blobs(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        load_msgpack_ckpt(str(tmp_path))
    blob = tmp_path / "other.msgpack"
    blob.write_bytes(serialization.msgpack_serialize(
        {"params": {"w": np.ones((2, 3), np.float16)}, "n": 3, "s": "x"}))
    with pytest.raises(ValueError, match="not a DMM msgpack"):
        load_msgpack_ckpt(str(blob))


@pytest.mark.parametrize("seed", [0, 7003, 12345])
def test_synthetic_data_bit_equal(seed):
    a = syn.synthetic_sequence(seed, T=3, H=40, W=56, num_objects=2,
                               num_proposals=6)
    b = jsyn.synthetic_sequence(seed, T=3, H=40, W=56, num_objects=2,
                                num_proposals=6)
    c = syn.synthetic_clip_batch(seed, batch=2, T=2, H=32, W=40, pad_objects=3)
    d = jsyn.synthetic_clip_batch(seed, batch=2, T=2, H=32, W=40, pad_objects=3)
    e = syn.synthetic_detection_frame(seed, H=48, W=64)
    f = jsyn.synthetic_detection_frame(seed, H=48, W=64)
    for x, y in ((a, b), (c, d), (e, f)):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_rle_round_trip_and_jax_encoding():
    rng = np.random.RandomState(0)
    for shape in ((13, 7), (1, 1), (40, 33)):
        m = (rng.rand(*shape) > 0.6).astype(np.uint8)
        m[0, 0] = 1                                  # a run of ones first
        enc = rle.encode(m)
        assert enc == jrle.encode(m)
        np.testing.assert_array_equal(rle.decode(enc), m)
        np.testing.assert_array_equal(rle.decode({**enc, "counts":
                                                  enc["counts"].decode()}), m)
        assert rle.area(enc) == jrle.area(enc) == int(m.sum())
        m2 = np.roll(m, 3, 1)
        assert rle.iou(enc, rle.encode(m2)) == jrle.iou(enc, jrle.encode(m2))


def _davis_tree(root, seeds=(7003, 7004), T=4, H0=120, W0=210, cache=None):
    """DAVIS-layout tree rendered from synthetic videos (two objects each);
    with ``cache``, a proposal cache of RLE masks beside it."""
    names = []
    for i, seed in enumerate(seeds):
        seq = f"seq{i}"
        names.append(seq)
        s = syn.synthetic_sequence(seed=seed, T=T, H=H0, W=W0, num_objects=2,
                                   num_proposals=4)
        jdir = os.path.join(root, "JPEGImages", "480p", seq)
        adir = os.path.join(root, "Annotations", "480p", seq)
        os.makedirs(jdir)
        os.makedirs(adir)
        for t in range(T):
            Image.fromarray((s["frames"][t] * 255).astype(np.uint8)).save(
                os.path.join(jdir, f"{t:05d}.jpg"), quality=95)
            lab = np.zeros((H0, W0), np.uint8)
            for m in range(2):
                lab[s["gt_masks"][t, m] > 0.5] = m + 1
            Image.fromarray(lab).save(os.path.join(adir, f"{t:05d}.png"))
            if cache is not None:
                pdir = os.path.join(cache, seq)
                os.makedirs(pdir, exist_ok=True)
                encs = [rle.encode(pm > 0.5) for pm in s["prop_masks"][t]]
                props = [{"rle": {**e, "counts": e["counts"].decode()},
                          "score": float(1 - n / 8)} for n, e in enumerate(encs)]
                with open(os.path.join(pdir, f"{t:05d}.json"), "w") as f:
                    json.dump(props, f)
    os.makedirs(os.path.join(root, "ImageSets", "2017"))
    with open(os.path.join(root, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names


@pytest.fixture
def jax_reads_with_pil(monkeypatch):
    """Both packages' readers decode through their C++ loaders when those
    are built, which round within +-1 of PIL (data/native_loader.py); hold
    both to the PIL path, the oracle of tests/test_native_loader.py."""
    monkeypatch.setattr(jax_native_loader, "_native", lambda: None)
    pin_port_to_pil(monkeypatch)


@pytest.fixture
def both_read_natively(monkeypatch, tmp_path):
    """Both packages' readers decode with their C++ loaders: the JAX one
    built from native/loader into this test's directory, the port's from
    its copy in dmm_net_tpu_torch/csrc/host."""
    pin_both_native(monkeypatch, jax_native_loader, tmp_path)


def _assert_streams_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k != "frames":
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    n = 0
    for x, y in zip(a["frames"], b["frames"]):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
        n += 1
    assert n == a["num_frames"]


@pytest.mark.parametrize("with_cache", [False, True])
def test_davis_stream_bit_equal(tmp_path, with_cache, jax_reads_with_pil):
    root, cache = str(tmp_path / "DAVIS"), str(tmp_path / "props")
    names = _davis_tree(root, seeds=(7005,), T=3, H0=70, W0=90,
                        cache=cache if with_cache else None)
    kw = dict(image_size=(48, 64), max_objects=3, max_proposals=6,
              proposal_dir=cache if with_cache else None)
    port, ref = DavisDataset(root, **kw), JaxDavis(root, **kw)
    assert port.sequences == ref.sequences == names
    _assert_streams_equal(port.sequence_stream(names[0]),
                          ref.sequence_stream(names[0]))
    ann = port.annotation_paths(names[0])[1]
    np.testing.assert_array_equal(port.load_annotation_native(ann),
                                  ref.load_annotation_native(ann))
    # batching of two streams and the compact form of a sequence
    got = batch_sequence_streams([port.sequence_stream(n) for n in names * 2])
    want = jax_batch([ref.sequence_stream(n) for n in names * 2])
    _assert_streams_equal(got, want)


@pytest.mark.parametrize("with_cache", [False, True])
def test_davis_stream_bit_equal_native(tmp_path, with_cache, both_read_natively):
    """The same with both packages decoding natively (JPEG frames, palette
    labels, native-size annotations)."""
    test_davis_stream_bit_equal(tmp_path, with_cache, None)


def test_compact_stream_equal():
    s = syn.synthetic_sequence(3, T=2, H=40, W=56, num_proposals=5)
    s["prop_valid"][1, -1] = False
    for x, y in zip(compact_stream(s["frames"], s["prop_masks"], s["prop_valid"]),
                    jax_compact(s["frames"], s["prop_masks"], s["prop_valid"])):
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("hw,native", [((17, 29), (67, 115)),
                                       ((32, 48), (32, 48)),
                                       ((60, 100), (37, 53))])
def test_scorer_matches_jax(hw, native):
    rng = np.random.RandomState(hw[0])
    labels = rng.randint(0, 4, (6,) + hw).astype(np.uint8)
    up = jf.upsample_labels(labels, native)
    np.testing.assert_array_equal(up, jjf.upsample_labels(labels, native))
    gt = np.clip(up.astype(np.int32) + (rng.rand(6, *native) > 0.9), 0, 3)
    for ids in (None, [1, 2, 3]):
        a = jf.evaluate_sequence(gt, up, object_ids=ids)
        b = jjf.evaluate_sequence(gt, up, object_ids=ids)
        for k in ("J", "F", "J&F", "J_recall", "J_decay", "F_recall", "F_decay"):
            assert abs(a[k] - b[k]) <= 1e-12, k
    m = rng.rand(*native) > 0.5
    for r in (0, 1, 4):
        np.testing.assert_array_equal(jf._binary_dilate_disk(m, r),
                                      jjf._binary_dilate_disk(m, r))


def test_write_png_reads_back_with_pil(tmp_path):
    lab = np.random.RandomState(1).randint(0, 7, (23, 41)).astype(np.uint8)
    lab[0, 0] = 255
    path = str(tmp_path / "a" / "00000.png")
    InferenceEngine.write_png(lab, path)
    with Image.open(path) as im:
        assert im.mode == "P" and im.size == (41, 23)
        np.testing.assert_array_equal(np.asarray(im), lab)
        assert im.getpalette()[:768] == DAVIS_PALETTE.flatten().tolist()
    ref = str(tmp_path / "ref.png")
    JaxEngine.write_png(lab, ref)
    with Image.open(ref) as im:
        assert im.getpalette()[:768] == DAVIS_PALETTE.flatten().tolist()


def test_infer_cli_matches_jax_engine_and_scorer(tmp_path, jax_reads_with_pil):
    """infer_torch.py on the fallback checkpoint (in-process, CPU, so that
    the decode pin holds) against the JAX engine and scorer run in-process
    on the same tree."""
    import infer_torch
    root, out = str(tmp_path / "DAVIS"), str(tmp_path / "out")
    names = _davis_tree(root)
    summary = infer_torch.main(["--ckpt", str(_ARTIFACT), "--davis-root", root,
                                "--out", out, "--device", "cpu"])
    with open(os.path.join(out, "results.json")) as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(summary))
    assert got["dispatch"] == "chunked_scan" and got["frames"] == 8

    port_cfg, variables = load_msgpack_ckpt(str(_ARTIFACT))
    cfg = jax_config_from_dict(port_cfg.to_dict())
    ds = JaxDavis(root, image_size=cfg.model.image_size,
                  max_objects=cfg.matching.max_templates,
                  max_proposals=cfg.matching.max_proposals)
    engine = JaxEngine(cfg, variables=variables)
    scores = []
    for name in names:
        sd = ds.sequence_stream(name)
        labels = engine.run_stream_chunked(sd["frames"], sd["tmpl_masks"],
                                           sd["tmpl_valid"], sd["first_frame"],
                                           chunk=8)["labels"][:, 0]
        pngs = np.stack([np.asarray(Image.open(os.path.join(out, name,
                                                            f"{t:05d}.png")))
                         for t in range(len(labels))])
        assert (pngs != labels).mean() < 1e-3
        gt = np.stack([ds.load_annotation_native(p) for p in sd["annotations"]])
        pred = jjf.upsample_labels(labels, gt.shape[1:])
        scores.append(jjf.evaluate_sequence(gt, pred, object_ids=[1, 2])["J&F"])
        assert abs(got["sequences"][name]["J&F"] - scores[-1]) <= 1e-3
    assert abs(got["J&F"] - np.mean(scores)) <= 1e-3
    assert got["J&F"] > 0.85                      # trained weights find the objects


def test_infer_cli_matches_jax_engine_and_scorer_native(tmp_path, both_read_natively):
    """The same with both packages decoding natively."""
    test_infer_cli_matches_jax_engine_and_scorer(tmp_path, None)


@pytest.mark.parametrize("run", ["as_saved", "kernels"])
def test_ckpt_reference_values(run):
    """chip_smoke.py phase 5d holds the card to the JAX package's J&F on its
    8 synthetic videos; recompute that reference here, and the port's on
    the CPU beside it."""
    import chip_smoke as cs
    port_cfg, variables = load_msgpack_ckpt(str(_ROOT / cs.CKPT))
    H, W = port_cfg.model.image_size
    frames, items, tmpl, valid, gt = cs.ckpt_inputs(
        port_cfg.matching.max_templates, port_cfg.matching.max_proposals, H, W)
    cfg = port_cfg.override(**cs.CKPT_RUNS[run])
    want = JaxEngine(jax_config_from_dict(cfg.to_dict()), variables=variables) \
        .run_stream_chunked(iter(items), tmpl, valid, frames[0], chunk=8)
    got = InferenceEngine(cfg, variables=variables, device="cpu") \
        .run_stream_chunked(iter(items), tmpl, valid, frames[0], chunk=8)
    jax_jf, port_jf = cs.mean_jf(want["labels"], gt), cs.mean_jf(got["labels"], gt)
    assert abs(jax_jf - cs.JAX_CKPT_JF[run]) < 2e-3, jax_jf
    assert abs(port_jf - jax_jf) < 0.01 and port_jf > 0.85
    assert (got["labels"] != want["labels"]).mean() < 1e-3
