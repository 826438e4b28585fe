"""The day-one drill's trees and the committed JAX-detector caches.

- The port's ``write_native_davis_tree`` and the JAX drill's
  ``_synthetic_davis_tree`` (``tests/test_dayone_cli.py``) write one tree:
  byte-equal JPEGs, PNGs and split files, for each of the drill's seeds
  7001-7008. The caches in ``artifacts/drill_proposals_jax/`` were made by
  the JAX package on the port's trees and are scored on the card on trees
  the port writes there, so they hold only if this does.
- Every committed cache (``artifacts/drill_proposals_jax/<detector>/<seed>/
  seq0/<t>.json``, the JAX detector stage's proposals, written by
  ``tools/extract_proposals.py``) loads to equal masks and validity in the
  JAX package's DAVIS reader and in the port's, and
  ``tools/dayone_seeds_torch.proposal_quality`` reproduces the recall and
  per-object best IoUs that the directory's README records.
- ``tools/compare_caches_torch.py``, which held the port's cache tool
  against JAX's on the trained detector behind those caches, tells a
  cache's copy from one with a detection, box, score or masks changed.
"""

import json
import os
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from dmm_net_tpu.data.davis import DavisDataset as JaxDavis
from dmm_net_tpu_torch.data.davis import DavisDataset
from dmm_net_tpu_torch.data.synthetic import write_native_davis_tree
from dmm_net_tpu_torch.ops import rle as rle_codec

import chip_smoke as cs
from tests.test_dayone_cli import _synthetic_davis_tree

_ROOT = Path(__file__).resolve().parent.parent
CACHES = _ROOT / "artifacts" / "drill_proposals_jax"
SEEDS = range(7001, 7009)
FRAMES = 4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module's tests run: the test runner
    puts several workers on the machine's cores, and PyTorch's default of
    one thread per core then oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


@pytest.mark.parametrize("seed", SEEDS)
def test_drill_trees_are_one_tree(tmp_path, seed):
    port = write_native_davis_tree(str(tmp_path / "port"), T=FRAMES, seeds=(seed,))
    ref = _synthetic_davis_tree(tmp_path, T=FRAMES, seeds=(seed,))
    files = _files(port)
    assert files == _files(ref)
    assert len(files) == 2 * FRAMES + 2          # JPEGs, PNGs, train/val splits
    for f in files:
        assert (Path(port) / f).read_bytes() == (Path(ref) / f).read_bytes(), f


def _recorded():
    """The README's table: {(detector, seed): (recall@0.5, recall@0.7,
    [best IoU of object 1, of object 2])}."""
    out = {}
    for line in (CACHES / "README.md").read_text().splitlines():
        m = re.match(r"\|\s*(\w+)\s*\|\s*(70\d\d)\s*\|" + r"\s*([\d.]+)\s*\|" * 4,
                     line)
        if m:
            r5, r7, i1, i2 = map(float, m.groups()[2:])
            out[(m.group(1), int(m.group(2)))] = (r5, r7, [i1, i2])
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_committed_caches_load_alike(tmp_path, seed):
    """Both readers give each committed cache's frames equal masks and
    validity at the drill's 256x448 cache geometry, and the tool's
    proposal quality is the README's to 1e-6."""
    tool = cs.load_tool("dayone_seeds_torch")
    recorded = _recorded()
    detectors = sorted(p.name for p in CACHES.iterdir() if p.is_dir())
    assert detectors and {d for d, _ in recorded} == set(detectors)
    root = write_native_davis_tree(str(tmp_path / "D"), T=FRAMES, seeds=(seed,))
    for det in detectors:
        cache = str(CACHES / det / str(seed))
        kw = dict(image_size=tool.CACHE_HW, max_proposals=8, proposal_dir=cache)
        port, ref = DavisDataset(root, **kw), JaxDavis(root, **kw)
        n_valid = 0
        for t in range(FRAMES):
            assert os.path.exists(os.path.join(cache, "seq0", f"{t:05d}.json"))
            (pm, pv), (jm, jv) = port.load_proposals("seq0", t), ref.load_proposals("seq0", t)
            assert np.array_equal(pv, jv) and np.array_equal(pm, jm)
            n_valid += int(pv.sum())
        assert n_valid >= FRAMES                 # a detection on every frame at least
        q = tool.proposal_quality(root, cache)
        r5, r7, ious = recorded[(det, seed)]
        assert abs(q["recall@0.5"] - r5) <= 1e-6 and abs(q["recall@0.7"] - r7) <= 1e-6
        np.testing.assert_allclose(q["best_iou"], ious, atol=1e-6, rtol=0)


@pytest.mark.parametrize("change", ["none", "score", "box", "count", "mask",
                                    "extra", "missing"])
def test_compare_caches_tool(tmp_path, change):
    """tools/compare_caches_torch.py: a committed cache agrees with its
    copy, and no longer when one score moves by 2e-5, one box by 2e-3 px,
    a frame loses a detection, every mask of a frame has a band of rows
    inverted, or the copy has a frame more or a frame less."""
    tool = cs.load_tool("compare_caches_torch")
    det = sorted(p.name for p in CACHES.iterdir() if p.is_dir())[0]
    a, b = CACHES / det / "7001", tmp_path / "b"
    shutil.copytree(a, b)
    f = b / "seq0" / "00000.json"
    props = json.loads(f.read_text())
    if change == "score":
        props[0]["score"] += 2e-5
    elif change == "box":
        props[0]["bbox"][2] += 2e-3
    elif change == "count":
        props = props[:-1]
    elif change == "mask":
        for p in props:
            m = rle_codec.decode(p["rle"])
            m[: m.shape[0] // 4] = ~m[: m.shape[0] // 4]
            enc = rle_codec.encode(m)
            p["rle"] = {"size": [int(v) for v in enc["size"]],
                        "counts": enc["counts"].decode("latin1")}
    f.write_text(json.dumps(props))
    if change == "extra":
        shutil.copy(f, b / "seq0" / "00004.json")
    elif change == "missing":
        (b / "seq0" / "00003.json").unlink()
    out = tool.main([str(a), str(b)])
    assert out["frames"] == FRAMES - (change == "missing")
    assert out["agree"] == (change == "none")
    assert out["only_in_a"] == (["seq0/00003.json"] if change == "missing" else [])
    assert out["only_in_b"] == (["seq0/00004.json"] if change == "extra" else [])
    assert out["count_mismatch"] == (["seq0/00000.json"] if change == "count" else [])
    if change == "none":
        assert out["max_box_diff"] == out["max_score_diff"] == out["max_mask_mismatch"] == 0
