"""The port's C++ host path (dmm_net_tpu_torch/csrc/host, built with g++ at
first use) against the JAX package's: the image loader byte-equal to the
JAX loader built from native/loader with native/build.py's flags, within
+-1 of PIL, threaded batches equal to serial decodes, the PIL path taken
and reported when the library cannot be built; the RLE codec equal to the
numpy codec and to the JAX package's native and numpy codecs."""

import numpy as np
import pytest
from PIL import Image

from dmm_net_tpu.data import native_loader as jax_native_loader
from dmm_net_tpu.ops import rle as jrle
from dmm_net_tpu_torch.data import native_loader as nl
from dmm_net_tpu_torch.kernels import _build
from dmm_net_tpu_torch.ops import rle
from torch_port_native import build_jax_library, pin_both_native

needs_loader = pytest.mark.skipif(
    bool(_build.host_headers_missing("imgloader")),
    reason="libjpeg/libpng headers missing: the native loader cannot build")


def _frames(tmp_path):
    """JPEG and RGB-PNG frames and palette-PNG labels at odd and even sizes."""
    rng = np.random.RandomState(0)
    frames, labels = [], []
    for i, (h, w) in enumerate([(97, 113), (120, 214), (64, 64), (131, 77)]):
        base = rng.rand(h // 8 + 2, w // 8 + 2, 3)
        img = np.asarray(Image.fromarray((base * 255).astype(np.uint8))
                         .resize((w, h), Image.BILINEAR))
        for ext, kw in (("jpg", {"quality": 90}), ("png", {})):
            p = str(tmp_path / f"f{i}.{ext}")
            Image.fromarray(img).save(p, **kw)
            frames.append(p)
        lab = rng.randint(0, 5, (h, w)).astype(np.uint8)
        im = Image.fromarray(lab, mode="P")
        im.putpalette([v for k in range(256) for v in (k, 0, 255 - k)])
        p = str(tmp_path / f"l{i}.png")
        im.save(p)
        labels.append(p)
    return frames, labels


def _pil(fn, *args, **kw):
    """``fn`` on the port's PIL path."""
    lib, tried = nl._LIB, nl._TRIED
    nl._LIB, nl._TRIED = None, True
    try:
        return fn(*args, **kw)
    finally:
        nl._LIB, nl._TRIED = lib, tried


@needs_loader
@pytest.mark.parametrize("hw", [(48, 64), (37, 61), (240, 428)])
def test_native_decode_byte_equal_to_jax_loader(tmp_path, monkeypatch, hw):
    """Down, odd-down and up: frames, labels, native-size decodes and probes
    of both packages' native loaders are byte-equal."""
    pin_both_native(monkeypatch, jax_native_loader, tmp_path)
    assert nl.decoder() == "native" and jax_native_loader.available()
    frames, labels = _frames(tmp_path)
    np.testing.assert_array_equal(nl.load_rgb_batch(frames, hw),
                                  jax_native_loader.load_rgb_batch(frames, hw))
    np.testing.assert_array_equal(nl.load_label_batch(labels, hw),
                                  jax_native_loader.load_label_batch(labels, hw))
    for p in frames + labels:
        assert nl.probe(p) == jax_native_loader.probe(p)
    for p in frames:
        np.testing.assert_array_equal(nl.load_rgb_native_size(p),
                                      jax_native_loader.load_rgb_native_size(p))
    for p in labels:
        np.testing.assert_array_equal(nl.load_label_native_size(p),
                                      jax_native_loader.load_label_native_size(p))


@needs_loader
@pytest.mark.parametrize("hw", [(48, 64), (37, 61), (240, 428)])
def test_native_within_one_of_pil(tmp_path, hw):
    """Frames within +-1 of PIL BILINEAR; labels at their own size equal to
    PIL's, resized equal to the half-pixel nearest oracle (PIL's NEAREST
    picks other source pixels at some rounding points, as in the JAX
    package); native-size frames within +-1 of PIL's."""
    frames, labels = _frames(tmp_path)
    got = nl.load_rgb_batch(frames, hw).astype(int)
    want = _pil(nl.load_rgb_batch, frames, hw).astype(int)
    assert np.abs(got - want).max() <= 1
    H, W = hw
    for p, got in zip(labels, nl.load_label_batch(labels, hw)):
        lab = _pil(nl.load_label_native_size, p)
        np.testing.assert_array_equal(nl.load_label_native_size(p), lab)
        h, w = lab.shape
        ys = np.minimum(((np.arange(H) + 0.5) * (h / H)).astype(int), h - 1)
        xs = np.minimum(((np.arange(W) + 0.5) * (w / W)).astype(int), w - 1)
        np.testing.assert_array_equal(got, lab[np.ix_(ys, xs)])
    for p in frames:
        assert np.abs(nl.load_rgb_native_size(p).astype(int)
                      - _pil(nl.load_rgb_native_size, p)).max() <= 1


@needs_loader
def test_threaded_batch_equals_serial(tmp_path):
    frames, labels = _frames(tmp_path)
    a = nl.load_rgb_batch(frames, (48, 64), threads=8)
    np.testing.assert_array_equal(a, nl.load_rgb_batch(frames, (48, 64), threads=1))
    np.testing.assert_array_equal(
        a, np.stack([nl.load_rgb_batch([p], (48, 64))[0] for p in frames]))
    b = nl.load_label_batch(labels, (33, 47), threads=8)
    np.testing.assert_array_equal(
        b, np.stack([nl.load_label_batch([p], (33, 47), threads=1)[0]
                     for p in labels]))


def test_pil_path_taken_and_reported_when_absent(tmp_path, monkeypatch, capsys):
    """A library that cannot be built leaves the reason readable, the readers
    say once that they decode with PIL, and every function gives PIL's
    result; a file that fails natively raises PIL's error."""
    def no_build(name):
        raise RuntimeError(f"g++ failed for csrc/host/{name}.cpp (exit 1)")
    monkeypatch.setattr(_build, "host_library", no_build)
    monkeypatch.setattr(nl, "_TRIED", False)
    monkeypatch.setattr(nl, "_LIB", None)
    monkeypatch.setattr(nl, "_REASON", None)
    monkeypatch.setattr(nl, "_ANNOUNCED", None)
    assert not nl.available() and nl.decoder() == "pil"
    assert "g++ failed for csrc/host/imgloader.cpp" in nl.reason()
    assert nl.announce() == nl.announce() == "pil"
    err = capsys.readouterr().err
    assert err.count("image decode: PIL (g++ failed") == 1
    frames, labels = _frames(tmp_path)
    with Image.open(frames[0]) as im:
        want = np.asarray(im.convert("RGB").resize((64, 48), Image.BILINEAR))
    np.testing.assert_array_equal(nl.load_rgb_batch(frames[:1], (48, 64))[0], want)
    with pytest.raises(FileNotFoundError):
        nl.load_label_batch([str(tmp_path / "missing.png")], (8, 8))
    from dmm_net_tpu_torch.data.davis import DavisDataset
    DavisDataset(str(tmp_path))
    assert "image decode" not in capsys.readouterr().err     # said once


@pytest.mark.parametrize("shape", [(13, 7), (1, 1), (40, 33), (256, 448)])
def test_native_rle_equals_numpy_and_jax(tmp_path, monkeypatch, shape):
    """Run lengths, masks, COCO strings and IoU: the port's C++ codec equal
    to its numpy codec, to the JAX package's C++ codec (built from
    native/rle) and to its numpy codec."""
    assert rle.available()
    rng = np.random.RandomState(shape[0])
    m = (rng.rand(*shape) > 0.6).astype(np.uint8)
    m[0, 0] = 1                                   # a run of ones first
    m2 = np.roll(m, 3, 1)
    enc, enc2 = rle.encode(m), rle.encode(m2)
    counts = rle.encode_counts(m)
    np.testing.assert_array_equal(counts, rle.encode_counts_plain(m))
    np.testing.assert_array_equal(rle.decode_counts(counts, *shape), m)
    np.testing.assert_array_equal(rle.decode_counts_plain(counts, *shape), m)
    np.testing.assert_array_equal(rle.decode(enc), m)
    assert rle.iou(enc, enc2) == rle.iou_plain(enc, enc2)
    monkeypatch.setattr(jrle, "_LIB", False)              # the JAX numpy codec
    want_np = (jrle.encode(m), jrle.iou(jrle.encode(m), jrle.encode(m2)))
    monkeypatch.setattr(jrle, "_LIB", build_jax_library("maskrle", tmp_path))
    assert jrle._native() is not None                     # the JAX C++ codec
    want_c = (jrle.encode(m), jrle.iou(jrle.encode(m), jrle.encode(m2)))
    assert enc == want_np[0] == want_c[0]
    assert rle.iou(enc, enc2) == want_np[1] == want_c[1]
    np.testing.assert_array_equal(jrle.decode(enc), rle.decode(enc))
