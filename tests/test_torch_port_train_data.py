"""Training data of the port against the JAX package: the clip
augmentation (numpy, no cv2, against the JAX package's cv2 version) and
``clip_batches`` of the DAVIS and YouTube-VOS readers on fixture trees."""

import numpy as np
import pytest

import chip_smoke as cs
from dmm_net_tpu.data import native_loader as jax_native_loader
from dmm_net_tpu.data.augment import augment_batch as jax_augment_batch
from dmm_net_tpu.data.davis import DavisDataset as JaxDavis
from dmm_net_tpu.data.synthetic import synthetic_clip_batch
from dmm_net_tpu.data.ytvos import YTVOSDataset as JaxYTVOS
from dmm_net_tpu_torch.data.augment import augment_batch
from dmm_net_tpu_torch.data.davis import DavisDataset
from dmm_net_tpu_torch.data.ytvos import YTVOSDataset
from test_torch_port_train_step import few_threads  # noqa: F401
from test_ytvos_train import _fake_ytvos_train
from torch_port_native import pin_both_native, pin_port_to_pil


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


@pytest.mark.parametrize("uint8,size", [(True, (64, 64)), (False, (64, 96)),
                                        (True, (60, 100))])
def test_augment_matches_jax_cv2(uint8, size):
    """Masks equal; frames within one uint8 level (float32 frames: 1e-4),
    over seeds that draw flips, crops (s > 1) and pads (s < 1)."""
    H, W = size
    b = synthetic_clip_batch(seed=3, batch=3, T=2, H=H, W=W, num_objects=2,
                             num_proposals=5, pad_objects=3)
    if uint8:
        b["frames"] = (b["frames"] * 255).astype(np.uint8)
    scales = set()
    for seed in range(6):
        want = jax_augment_batch({k: v.copy() for k, v in b.items()}, seed=seed)
        got = augment_batch({k: v.copy() for k, v in b.items()}, seed=seed)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            if k == "frames":
                d = np.abs(got[k].astype(np.float64) - want[k]).max()
                assert d <= (1 if uint8 else 1e-4), (seed, d)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for i in range(3):
            rng = np.random.RandomState(seed * 9973 + i)
            rng.rand()
            scales.add(rng.uniform(0.8, 1.2) > 1)
    assert scales == {True, False}             # both crop and pad drawn


def test_davis_clip_batches_match_jax(tmp_path, jax_reads_with_pil):
    root = cs.write_davis_tree(tmp_path / "DAVIS", train_seeds=(11, 12),
                               val_seeds=(13,), T=5, hw=(60, 100))
    kw = dict(image_size=(64, 96), max_objects=4, max_proposals=8)
    port = DavisDataset(str(root), split="train", **kw)
    jax = JaxDavis(str(root), split="train", **kw)
    assert port.sequences == jax.sequences == ["train11", "train12"]
    for seed in (0, 5):
        a = port.clip_batches(2, 3, seed=seed)
        b = jax.clip_batches(2, 3, seed=seed)
        for _ in range(2):
            x, y = next(a), next(b)
            assert x.keys() == y.keys()
            for k in y:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_ytvos_clip_batches_match_jax(tmp_path, jax_reads_with_pil):
    root, _ = _fake_ytvos_train(tmp_path)
    kw = dict(image_size=(64, 96), max_objects=4, max_proposals=8)
    port = YTVOSDataset(root, split="train", **kw)
    jax = JaxYTVOS(root, split="train", **kw)
    seen_late = False
    for seed in (0, 1, 2):
        x = next(port.clip_batches(2, 3, seed=seed))
        y = next(jax.clip_batches(2, 3, seed=seed))
        assert x.keys() == y.keys() and {"live_from", "gt_valid"} <= set(x)
        for k in y:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
        seen_late |= bool(x["live_from"].max() > 0)
    assert seen_late


def test_davis_clip_batches_match_jax_native(tmp_path, both_read_natively):
    """The same with both packages decoding natively."""
    test_davis_clip_batches_match_jax(tmp_path, None)


def test_ytvos_clip_batches_match_jax_native(tmp_path, both_read_natively):
    """The same with both packages decoding natively."""
    test_ytvos_clip_batches_match_jax(tmp_path, None)
