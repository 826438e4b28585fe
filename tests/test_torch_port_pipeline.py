"""The port's input pipeline against the JAX package on the CPU: the
stager (data/pipeline.Prefetcher, RingStager), normalize_frames, the
engine on staged items, and stage 0 of the two-stage system, the proposal
cache tool (tools/extract_proposals_torch.py) against the JAX detector, with
caches read across packages."""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import serialization

from dmm_net_tpu.data import native_loader as jax_native_loader
from dmm_net_tpu.data import pipeline as jax_pipeline
from dmm_net_tpu.data.davis import DavisDataset as JaxDavis
from dmm_net_tpu.data.ytvos import YTVOSDataset as JaxYTVOS
from dmm_net_tpu.models.proposal.maskrcnn import MaskRCNN as JaxMaskRCNN
from dmm_net_tpu.models.proposal.maskrcnn import paste_masks as jax_paste_masks
from dmm_net_tpu.ops import rle as jrle
from dmm_net_tpu_torch.config import preset
from dmm_net_tpu_torch.data.davis import DavisDataset
from dmm_net_tpu_torch.data.pipeline import (Prefetcher, RingStager,
                                             normalize_frames)
from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
from dmm_net_tpu_torch.data.ytvos import YTVOSDataset
from dmm_net_tpu_torch.infer.engine import InferenceEngine
from dmm_net_tpu_torch.ops import rle

import chip_smoke as cs
from test_torch_port_train_step import few_threads  # noqa: F401
from torch_port_native import pin_both_native, pin_port_to_pil

_ROOT = Path(__file__).resolve().parent.parent
_SPEC = importlib.util.spec_from_file_location(
    "extract_proposals_torch", _ROOT / "tools" / "extract_proposals_torch.py")
extract = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(extract)

# a small 3-class detector, as train_proposal.py trains on synthetic frames
_DET = dict(image_size=(64, 64), backbone_name="resnet18", num_classes=3)


@pytest.fixture
def jax_reads_with_pil(monkeypatch):
    """Both packages' readers decode through their C++ loaders when those
    are built, within +-1 of PIL; hold both to the PIL path (the oracle of
    tests/test_native_loader.py)."""
    monkeypatch.setattr(jax_native_loader, "_native", lambda: None)
    pin_port_to_pil(monkeypatch)


@pytest.fixture
def both_read_natively(monkeypatch, tmp_path):
    """Both packages' readers decode with their C++ loaders (the JAX one
    built from native/loader into this test's directory)."""
    pin_both_native(monkeypatch, jax_native_loader, tmp_path)


# ---------------------------------------------------------------------------
# the stager
# ---------------------------------------------------------------------------

def _load(i):
    return {"x": np.full((2, 3), i, np.float32), "m": np.arange(4) % 2 == i % 2,
            "n": [np.uint8(i)]}


def test_prefetcher_order_and_content_match_jax():
    got = list(Prefetcher(range(20), _load, depth=3, device="cpu"))
    want = list(jax_pipeline.Prefetcher(range(20), _load, depth=3))
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("x", "m"):
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
            assert g[k].numpy().dtype == np.asarray(w[k]).dtype
        assert int(g["n"][0]) == int(w["n"][0])


@pytest.mark.parametrize("where", ["load", "stage"])
def test_prefetcher_raises_in_the_consumer(where):
    """An error of the load function or of the staging copy reaches the
    consumer after the items before it, in both packages."""
    def load(i):
        if i == 3:
            if where == "load":
                raise ValueError("boom")
            return {"x": np.array([object()])}    # no tensor of this dtype
        return {"x": np.zeros(1)}

    seen = []
    with pytest.raises((ValueError, TypeError)) as port:
        for item in Prefetcher(range(10), load, depth=2, device="cpu"):
            seen.append(item)
    assert len(seen) == 3
    if where == "load":
        assert "boom" in str(port.value)
        with pytest.raises(ValueError, match="boom"):
            list(jax_pipeline.Prefetcher(range(10), load, depth=2))


def test_ring_stager_order():
    stream = [{"x": np.full((1,), i)} for i in range(7)]
    got = [int(item["x"][0]) for item in RingStager(stream, depth=3, device="cpu")]
    want = [int(item["x"][0]) for item in jax_pipeline.RingStager(stream, depth=3)]
    assert got == want == list(range(7))


def test_ring_stager_producer_runs_ahead():
    """The source iterator (the decode) runs on the producer thread: after
    the consumer takes one item and stalls, the producer fills the ring on
    its own (a lazy serial iterator would have produced one item)."""
    T, depth = 10, 3
    produced = []

    def stream():
        for i in range(T):
            produced.append(i)
            yield {"x": np.full((1,), i)}

    it = iter(RingStager(stream(), depth=depth, device="cpu"))
    assert int(next(it)["x"][0]) == 0
    deadline = time.monotonic() + 10.0
    while len(produced) < 1 + depth and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(produced) >= 1 + depth
    assert [int(item["x"][0]) for item in it] == list(range(1, T))


def test_prefetcher_stops_when_the_consumer_leaves():
    produced = []

    def stream():
        for i in range(1000):
            produced.append(i)
            yield {"x": np.full((1,), i)}

    pf = Prefetcher(stream(), lambda x: x, depth=2, device="cpu")
    for item in pf:
        if int(item["x"][0]) == 2:
            break
    pf._thread.join(10.0)
    assert not pf._thread.is_alive() and len(produced) < 10


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_normalize_frames_matches_jax(dtype):
    rng = np.random.RandomState(0)
    x = (rng.rand(2, 5, 7, 3) * (255 if dtype == "uint8" else 1)).astype(dtype)
    got = normalize_frames(x)
    want = np.asarray(jax_pipeline.normalize_frames(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(normalize_frames(torch.from_numpy(x)).numpy(),
                                  got.numpy())


def test_engine_takes_staged_items():
    """run_stream_chunked stacks staged tensors (torch.stack on their
    device) and numpy items (np.stack) to the same result."""
    cfg = preset("p3_multi_object").override(**{
        "model.backbone": "resnet18", "model.image_size": (64, 96),
        "model.backbone_dtype": "float32", "model.decoder_dtype": "float32",
        "model.mask_dtype": "float32", "matching.max_templates": 4,
        "matching.max_proposals": 6})
    s = synthetic_sequence(3, T=5, H=64, W=96, num_objects=2, num_proposals=6)
    items = [{"frame": (s["frames"][t:t + 1] * 255).astype(np.uint8),
              "prop_masks": s["prop_masks"][t:t + 1],
              "prop_valid": s["prop_valid"][t:t + 1]} for t in range(5)]
    tmpl = np.pad(s["tmpl_masks"], ((0, 2), (0, 0), (0, 0)))[None]
    valid = np.array([[True, True, False, False]])
    engine = InferenceEngine(cfg, device="cpu", seed=1)
    want = engine.run_stream_chunked(iter(items), tmpl, valid, items[0]["frame"],
                                     chunk=2)
    got = engine.run_stream_chunked(iter(RingStager(items, device="cpu")), tmpl,
                                    valid, items[0]["frame"], chunk=2)
    for k in ("labels", "assignments"):
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the proposal cache tool (stage 0)
# ---------------------------------------------------------------------------

def _randomize(shapes, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _davis_tree(root, T=3, hw=(50, 70)):
    for v, seed in enumerate((7501, 7502)):
        s = synthetic_sequence(seed=seed, T=T, H=hw[0], W=hw[1], num_objects=2)
        for sub in ("JPEGImages", "Annotations"):
            (root / sub / "480p" / f"seq{v}").mkdir(parents=True)
        for t in range(T):
            Image.fromarray((np.clip(s["frames"][t], 0, 1) * 255).astype(np.uint8)) \
                .save(root / "JPEGImages" / "480p" / f"seq{v}" / f"{t:05d}.png")
            lab = ((s["gt_masks"][t, 0] > 0.5) * 1
                   + (s["gt_masks"][t, 1] > 0.5) * 2).clip(0, 2).astype(np.uint8)
            Image.fromarray(lab).save(root / "Annotations" / "480p" / f"seq{v}"
                                      / f"{t:05d}.png")
    return ["seq0", "seq1"]


@pytest.fixture(scope="module")
def jax_detector(tmp_path_factory):
    """The small detector's seeded flax variables as a msgpack file, and the
    JAX detector + paste on them, jitted once for the PIL and the native
    caches' checks."""
    jmodel = JaxMaskRCNN(**_DET)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = _randomize(shapes, seed=2)
    params = tmp_path_factory.mktemp("detector") / "maskrcnn.msgpack"
    params.write_bytes(serialization.msgpack_serialize(variables))

    @jax.jit
    def detect(img):
        o = jmodel.apply(variables, img)
        return (o["boxes"], o["scores"], o["valid"],
                jax_paste_masks(o["masks"], o["boxes"], o["valid"], (64, 64)))

    return params, detect


def _caches(tmp, pil, jax_detector):
    """The port tool's caches, made with the detector file of
    ``jax_detector``, of a DAVIS tree (raw [0, 1] inputs) and of a
    YouTube-VOS tree (ImageNet-normalised inputs), its frames decoded with
    PIL (``pil``) or natively; and the JAX detector."""
    params, detect = jax_detector
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        if pil:
            pin_port_to_pil(mp)
        for dataset, norm in (("davis", "raw01"), ("ytvos", "imagenet")):
            root = tmp / dataset
            if dataset == "davis":
                _davis_tree(root)
            else:
                cs.write_ytvos_tree(root, seeds=(7601,), ids=((1, 2),), late=(2,),
                                    T=4, hw=(50, 70))
            cache = tmp / f"props_{dataset}"
            extract.main(["--dataset", dataset, "--root", str(root), "--out",
                          str(cache), "--params", str(params), "--image-size",
                          "64", "64", "--backbone", "resnet18", "--num-classes",
                          "3", "--input-norm", norm, "--device", "cpu"])
            out[dataset] = (root, cache, norm)
    return detect, out


@pytest.fixture(scope="module")
def caches(tmp_path_factory, jax_detector):
    """_caches with PIL decode."""
    return _caches(tmp_path_factory.mktemp("caches"), True, jax_detector)


@pytest.fixture(scope="module")
def native_caches(tmp_path_factory, jax_detector):
    """_caches with the port's native decode."""
    return _caches(tmp_path_factory.mktemp("native_caches"), False, jax_detector)


@pytest.mark.parametrize("dataset", ["davis", "ytvos"])
def test_cache_tool_matches_jax_detector(caches, dataset, jax_reads_with_pil):
    """Each frame's JSON against the JAX detector + paste + RLE on the same
    frame: the same detections, boxes within 1e-3, scores within 1e-5,
    decoded masks differing in < 1e-3 of the pixels (the tolerances of
    tools/compare_caches_torch.py, which holds two caches to them)."""
    tol = cs.load_tool("compare_caches_torch")
    detect, trees = caches
    root, cache, norm = trees[dataset]
    ds = (JaxDavis(str(root), image_size=(64, 64)) if dataset == "davis"
          else JaxYTVOS(str(root), image_size=(64, 64)))
    n_det, mism = 0, []
    for seq in (ds.sequences if dataset == "davis" else ds.videos):
        for fp in ds.frame_paths(seq):
            img = ds.load_frame(fp).astype(np.float32) / 255.0
            if norm == "imagenet":
                img = (img - jax_pipeline.IMAGENET_MEAN) / jax_pipeline.IMAGENET_STD
            boxes, scores, valid, masks = (np.asarray(x) for x in detect(img[None]))
            props = json.loads((cache / seq / f"{Path(fp).stem}.json").read_text())
            keep = np.flatnonzero(valid)
            assert len(props) == len(keep)
            for p, i in zip(props, keep):
                np.testing.assert_allclose(p["bbox"], boxes[i], atol=tol.BOX_TOL, rtol=0)
                assert abs(p["score"] - scores[i]) <= tol.SCORE_TOL
                assert p["rle"]["size"] == [64, 64]
                mism.append((rle.decode(p["rle"]) != (masks[i] > 0.5)).mean())
            n_det += len(keep)
    assert n_det >= 4                                   # detections to compare
    assert np.mean(mism) < tol.MASK_TOL


def _jax_written(props):
    """A cache entry as tools/extract_proposals.py writes it (the JAX codec)."""
    out = []
    for p in props:
        enc = jrle.encode(rle.decode(p["rle"]) > 0)
        out.append({"bbox": p["bbox"], "score": p["score"],
                    "rle": {"size": [int(x) for x in enc["size"]],
                            "counts": enc["counts"].decode("latin1")}})
    return out


@pytest.mark.parametrize("dataset", ["davis", "ytvos"])
def test_caches_load_across_packages(caches, tmp_path, dataset, jax_reads_with_pil):
    """The port tool's cache read by the JAX readers gives the port readers'
    streams bit-equal; the same cache re-encoded by the JAX codec (the JAX
    tool's output format) reads back equal in both."""
    _, trees = caches
    root, cache, _ = trees[dataset]
    jax_cache = tmp_path / "jax_props"
    for f in cache.rglob("*.json"):
        dst = jax_cache / f.parent.name / f.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(json.dumps(_jax_written(json.loads(f.read_text()))))
    for c in (cache, jax_cache):
        kw = dict(image_size=(48, 48), max_objects=4, max_proposals=32,
                  proposal_dir=str(c))
        if dataset == "davis":
            port, ref = DavisDataset(str(root), **kw), JaxDavis(str(root), **kw)
            names = port.sequences
        else:
            port, ref = YTVOSDataset(str(root), **kw), JaxYTVOS(str(root), **kw)
            names = port.videos
        n_valid = 0
        for name in names:
            a, b = port.sequence_stream(name), ref.sequence_stream(name)
            for x, y in zip(a["frames"], b["frames"]):
                for k in x:
                    assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
                n_valid += int(x["prop_valid"].sum())
        assert n_valid > 0


@pytest.mark.parametrize("dataset", ["davis", "ytvos"])
def test_cache_tool_matches_jax_detector_native(native_caches, dataset,
                                                both_read_natively):
    """The same with both packages decoding natively."""
    test_cache_tool_matches_jax_detector(native_caches, dataset, None)


@pytest.mark.parametrize("dataset", ["davis", "ytvos"])
def test_caches_load_across_packages_native(native_caches, tmp_path, dataset,
                                            both_read_natively):
    """The same with both packages decoding natively."""
    test_caches_load_across_packages(native_caches, tmp_path, dataset, None)


def test_cache_tool_defaults_to_cuda(tmp_path):
    """Without --device the tool builds its detector on CUDA (here an empty
    tree, so it writes nothing), and refuses where there is no card."""
    args = ["--root", str(tmp_path), "--out", str(tmp_path / "o"),
            "--backbone", "resnet18", "--image-size", "64", "64"]
    if torch.cuda.is_available():
        extract.main(args)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            extract.main(args)
    assert not (tmp_path / "o").exists()
