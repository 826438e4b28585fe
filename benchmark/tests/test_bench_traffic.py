"""The traffic generator draws each mix's stated parameters from the seed:
the same seed gives the same requests, and every seed sends the same set of
sizes."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.harness import spec, traffic  # noqa: E402
from benchmark.reference.model import bucket  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
VIDEO = [w["name"] for w in SPEC["workloads"]
         if spec.load_cell(w["name"]).kind == "video_offline"]
TRAIN = [w["name"] for w in SPEC["workloads"]
         if spec.load_cell(w["name"]).kind == "train_clips"]


def _small(cell):
    c = spec.load_cell(cell, rehearse=True)
    cd = spec.config_dict(c)
    p = spec.traffic_params(c)
    return c, cd, p, spec.sizes(cd, p, c.chips)


@pytest.mark.parametrize("cell", VIDEO)
def test_video_bank_repeats_and_keeps_its_parameters(cell):
    c, cd, p, sz = _small(cell)
    a = traffic.video_bank(p, sz, 2 ** 31 + 17, "cpu")
    b = traffic.video_bank(p, sz, 2 ** 31 + 17, "cpu")
    d = traffic.video_bank(p, sz, 5, "cpu")
    assert torch.equal(a.frames, b.frames) and torch.equal(a.boxes, b.boxes)
    assert torch.equal(a.masks28, b.masks28) and np.array_equal(a.tmpl_masks, b.tmpl_masks)
    assert not torch.equal(a.frames, d.frames)
    V, L = p["bank_videos"], max(p["lengths"])
    H, W = sz["image_hw"]
    assert a.frames.shape == (V, L, H, W, 3) and a.frames.dtype == torch.uint8
    assert a.masks28.shape == (V, L, sz["N"], 28, 28)
    lo, hi = p["objects"]
    assert ((a.counts >= lo) & (a.counts <= hi)).all()
    assert (a.tmpl_valid.sum(1) == a.counts).all()
    nv = a.valid.sum(-1)
    assert int(nv.min()) >= p["proposals_valid"][0] and int(nv.max()) <= p["proposals_valid"][1]
    assert not a.masks28[~a.valid].any()
    # every block of a batch holds a video with the most objects: one bucket
    B = p["batch_videos"]
    buckets = {bucket(int(a.counts[s:s + B].max()), sz["M"]) for s in range(V - B + 1)}
    assert len(buckets) == 1


@pytest.mark.parametrize("cell", VIDEO)
def test_request_plan_same_sizes_every_seed(cell):
    p = spec.load_cell(cell).traffic
    n = len(p["lengths"])
    one = traffic.request_plan(p, 2 ** 31 + 5, 3 * n)
    assert one == traffic.request_plan(p, 2 ** 31 + 5, 3 * n)
    other = traffic.request_plan(p, 77, 3 * n)
    for k in range(3):
        assert sorted(r.T for r in one[k * n:(k + 1) * n]) == sorted(p["lengths"])
        assert sorted(r.T for r in other[k * n:(k + 1) * n]) == sorted(p["lengths"])
    assert [r.T for r in one] != [r.T for r in other]
    assert all(0 <= r.start <= p["bank_videos"] - p["batch_videos"] for r in one)


@pytest.mark.parametrize("cell", TRAIN)
def test_clip_pool_repeats_and_holds_the_mix(cell):
    c, cd, p, sz = _small(cell)
    sz = dict(sz, global_clips=4)
    a = traffic.clip_pool(p, sz, 2 ** 31 + 3, "cpu")
    b = traffic.clip_pool(p, sz, 2 ** 31 + 3, "cpu")
    other = traffic.clip_pool(p, sz, 2 ** 31 + 4, "cpu")
    assert len(a) == p["pool_batches"]
    for x, y, o in zip(a, b, other):
        for k in x:
            assert torch.equal(x[k], y[k])
        assert not torch.equal(x["frames"], o["frames"])
        T, (H, W), M, N = sz["T"], sz["image_hw"], sz["M"], sz["N"]
        assert x["prop_masks"].shape == (4, T, N, H, W)
        assert x["gt_masks"].shape == (4, T, M, H, W)
        assert torch.equal(x["tmpl_masks"], x["gt_masks"][:, 0])
        cnt = x["tmpl_valid"].sum(1)
        assert int(cnt.min()) >= p["objects"][0] and int(cnt.max()) <= p["objects"][1]
        assert not x["gt_masks"].transpose(1, 2)[~x["tmpl_valid"]].any()
        assert not x["prop_masks"][~x["prop_valid"]].any()
    assert not torch.equal(a[0]["prop_masks"], a[1]["prop_masks"])
