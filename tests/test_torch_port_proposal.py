"""The port's proposal detector (dmm_net_tpu_torch.models.proposal, ops.nms,
ops.roi_pool ROI-Align) against the JAX package on the same inputs and
weights, in float32 on the CPU.

Inputs come from numpy seeds. The JAX package is channel-last and the port
channel-first, so tensors are transposed on the way between them."""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from dmm_net_tpu.kernels.roi_align import roi_align_pallas
from dmm_net_tpu.models.proposal import anchors as jax_anchors
from dmm_net_tpu.models.proposal.fpn import FPN as JaxFPN
from dmm_net_tpu.models.proposal.maskrcnn import BoxHead as JaxBoxHead
from dmm_net_tpu.models.proposal.maskrcnn import MaskHead as JaxMaskHead
from dmm_net_tpu.models.proposal.maskrcnn import MaskRCNN as JaxMaskRCNN
from dmm_net_tpu.models.proposal.maskrcnn import RPNHead as JaxRPNHead
from dmm_net_tpu.models.proposal.maskrcnn import \
    _multilevel_roi_align as jax_multilevel_roi_align
from dmm_net_tpu.ops.nms import nms_boxes as jax_nms_boxes
from dmm_net_tpu.ops.nms import nms_masks as jax_nms_masks
from dmm_net_tpu.ops.roi_pool import roi_align as jax_roi_align
from dmm_net_tpu.ops.roi_pool import roi_align_mxu as jax_roi_align_mxu
from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
from dmm_net_tpu_torch.kernels.roi_align import fpn_levels, multilevel_roi_align
from dmm_net_tpu_torch.kernels.roi_align import roi_align as b4_roi_align
from dmm_net_tpu_torch.models.layers import ConvTranspose
from dmm_net_tpu_torch.models.proposal import MaskRCNN
from dmm_net_tpu_torch.models.proposal import anchors
from dmm_net_tpu_torch.ops.nms import nms_boxes, nms_masks
from dmm_net_tpu_torch.ops.roi_pool import roi_align, roi_align_mxu
from dmm_net_tpu_torch.weights import convert_flax_variables, load_flax_variables

# tests/test_proposal.py's small detector
_SMALL = dict(image_size=(64, 128), backbone_name="resnet18", num_classes=8,
              pre_nms_top_n=32, post_nms_top_n=16, max_detections=8)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _randomize(shapes, seed):
    """Nontrivial values for every leaf of a variables tree of shapes (BN
    scales and statistics included, so a layout slip cannot hide)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# ---------------------------------------------------------------------------
# anchors and the box coder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(64, 128), (80, 120), (256, 448)])
def test_anchors_and_level_slices_match_jax(size):
    np.testing.assert_array_equal(anchors.generate_anchors(size),
                                  jax_anchors.generate_anchors(size))
    assert anchors.level_slices(size) == jax_anchors.level_slices(size)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_box_coder_and_clip_match_jax(weights):
    rng = np.random.RandomState(0)
    a = (rng.rand(60, 4) * 50).astype(np.float32)
    a[:, 2:] += a[:, :2] + 4
    b = (rng.rand(60, 4) * 60 - 5).astype(np.float32)
    b[:, 2:] += b[:, :2] + 2
    d = (rng.randn(60, 4) * 3).astype(np.float32)     # |dw|, |dh| beyond the clip
    enc = anchors.encode_boxes(torch.from_numpy(b), torch.from_numpy(a), weights)
    np.testing.assert_allclose(
        enc.numpy(), jax_anchors.encode_boxes(b, a, weights), rtol=1e-5, atol=1e-5)
    dec = anchors.decode_boxes(torch.from_numpy(d), torch.from_numpy(a), weights)
    want = np.asarray(jax_anchors.decode_boxes(d, a, weights)).copy()
    np.testing.assert_allclose(dec.numpy(), want, rtol=1e-5, atol=1e-5)
    clip = anchors.clip_to_image(torch.from_numpy(want), (64, 128)).numpy()
    np.testing.assert_array_equal(clip, jax_anchors.clip_to_image(want, (64, 128)))


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,max_out,thresh", [(40, 16, 0.5), (40, 48, 0.3),
                                              (200, 64, 0.7)])
def test_nms_boxes_matches_jax(n, max_out, thresh):
    rng = np.random.RandomState(n + max_out)
    xy = rng.rand(n, 2) * 80
    boxes = np.concatenate([xy, xy + 8 + rng.rand(n, 2) * 30], 1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.2
    idx, mask = nms_boxes(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid), iou_threshold=thresh,
                          max_out=max_out)
    jidx, jmask = jax_nms_boxes(boxes, scores, valid, iou_threshold=thresh,
                                max_out=max_out)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.any() and (idx[~mask] == -1).all()
    if max_out > n:
        assert not mask.all()                       # padded slots exercised


def test_nms_masks_matches_jax():
    """Mask NMS on the IoU matrix of 36 masks in 6 groups of noisy copies
    (high IoU within a group, low across); ``valid`` left at its default."""
    rng = np.random.RandomState(9)
    base = rng.rand(6, 400) > 0.6
    masks = np.repeat(base, 6, 0) ^ (rng.rand(36, 400) > 0.93)
    inter = (masks[:, None] & masks[None]).sum(-1)
    union = (masks[:, None] | masks[None]).sum(-1)
    iou = (inter / np.maximum(union, 1)).astype(np.float32)
    scores = rng.rand(36).astype(np.float32)
    idx, mask = nms_masks(torch.from_numpy(iou), torch.from_numpy(scores),
                          iou_threshold=0.5, max_out=12)
    jidx, jmask = jax_nms_masks(iou, scores, iou_threshold=0.5, max_out=12)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert 0 < mask.sum() < 12                      # suppression and padding both seen


# ---------------------------------------------------------------------------
# ROI-Align (ops; kernel B4's plain version is roi_align_mxu)
# ---------------------------------------------------------------------------

def roi_problem(seed=0, H=32, W=48, C=8, K=5, border=False):
    """tests/test_roi_align.py's problem; ``border`` adds boxes that touch or
    cross the map's edge and boxes smaller than one pixel."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(H, W, C).astype(np.float32)
    x1 = rng.rand(K) * (W - 10)
    y1 = rng.rand(K) * (H - 10)
    w = rng.rand(K) * 12 + 3
    h = rng.rand(K) * 12 + 3
    boxes = np.stack([x1, y1, np.minimum(x1 + w, W - 1),
                      np.minimum(y1 + h, H - 1)], 1)
    if border:
        boxes = np.concatenate([boxes, [[-6.0, -3.0, 9.0, 7.5],        # crosses the corner
                                        [W - 4.0, H - 5.0, W + 8.0, H + 2.0],
                                        [0.0, 0.0, W, H],               # whole map
                                        [10.2, 7.7, 10.5, 7.9],         # < 1 px
                                        [W - 0.3, 3.0, W - 0.1, 3.1]]])
    return feats, boxes.astype(np.float32)


@pytest.mark.parametrize("out_size,scale,border", [((7, 7), 1.0, False),
                                                   ((5, 3), 0.25, False),
                                                   ((14, 14), 0.5, True)])
def test_roi_align_forms_match_jax(out_size, scale, border):
    feats, boxes = roi_problem(seed=2, border=border)
    boxes = boxes / scale
    want_g = np.asarray(jax_roi_align(feats, boxes, out_size, 2, scale))
    want_m = np.asarray(jax_roi_align_mxu(feats, boxes, out_size, 2, scale))
    f, b = _nchw(feats[None])[0], torch.from_numpy(boxes)
    got_g = _nhwc(roi_align(f, b, out_size, 2, scale))
    got_m = _nhwc(roi_align_mxu(f, b, out_size, 2, scale))
    for got in (got_g, got_m):
        for want in (want_g, want_m):
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("out_size,scale,border", [((7, 7), 1.0, False),
                                                   ((14, 14), 0.25, True)])
def test_b4_wrapper_on_cpu_matches_pallas_interpret(out_size, scale, border):
    """Kernel B4's wrapper takes its plain version for CPU tensors; that is
    held against the TPU kernel run in interpret mode."""
    feats, boxes = roi_problem(seed=1, border=border)
    boxes = boxes / scale
    want = np.asarray(roi_align_pallas(feats, boxes, out_size, 2, scale,
                                       interpret=True))
    reset_launch_counts()
    got = b4_roi_align(_nchw(feats[None])[0], torch.from_numpy(boxes), out_size,
                       2, scale)
    assert launch_counts()["roi_align"] == 0
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-4, rtol=1e-4)


def multilevel_problem(seed, C=8, image=(256, 512)):
    """FPN maps p2..p5 of a 256x512 image (p2 64x128) and boxes that take
    every level: sqrt(area) at the level boundaries 112, 224 and 448 +- 1e-3,
    boxes across the border, boxes under one cell of p2, random boxes."""
    rng = np.random.RandomState(seed)
    H, W = image
    maps = {f"p{l}": rng.randn(1, H >> l, W >> l, C).astype(np.float32)
            for l in (2, 3, 4, 5)}
    rows = []
    for side in (112.0, 224.0, 448.0):
        for d in (-1e-3, 1e-3):
            x, y = rng.rand(2) * [W - 100, H - 100]
            rows.append([x, y, x + side + d, y + side + d])
    rows += [[-20.0, -9.0, 90.0, 70.0],           # across the top-left corner
             [W - 50.0, H - 30.0, W + 200.0, H + 150.0],
             [0.0, 0.0, W, H],                    # the whole image
             [33.1, 17.4, 33.9, 18.0],            # under one cell of p2
             [W - 1.5, 5.0, W - 0.2, 7.5]]
    xy = rng.rand(12, 2) * [W, H]
    wh = 2.0 + rng.rand(12, 2) ** 2 * [W, H]
    rows += np.concatenate([xy - 0.3 * wh, xy + 0.7 * wh], 1).tolist()
    return maps, np.asarray(rows, np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
def test_multilevel_roi_align_matches_jax(out_size, seed):
    """B4's multi-level wrapper on the CPU (its plain version) against the
    reference's align-everywhere-then-select, with each level taken."""
    maps, boxes = multilevel_problem(seed)
    want = np.asarray(jax_multilevel_roi_align(
        {k: jnp.asarray(v) for k, v in maps.items()}, jnp.asarray(boxes), out_size))
    b = torch.from_numpy(boxes)
    assert sorted(set(fpn_levels(b).tolist())) == [0, 1, 2, 3]
    reset_launch_counts()
    got = multilevel_roi_align([_nchw(maps[f"p{l}"])[0] for l in (2, 3, 4, 5)], b,
                               out_size)
    assert launch_counts()["roi_align"] == 0
    assert got.shape == (len(boxes), 8) + out_size
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the detector: a small flax MaskRCNN and the port's, same weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def detector():
    jmodel = JaxMaskRCNN(**_SMALL)
    img = np.random.RandomState(0).rand(1, 64, 128, 3).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(img))
    variables = _randomize(shapes, seed=1)
    want = jax.device_get(jax.jit(jmodel.apply)(variables, jnp.asarray(img)))
    port = MaskRCNN(**_SMALL, device="cpu")
    load_flax_variables(port, variables)
    return variables, port, img, want


def test_detector_weights_map_with_nothing_left_over(detector):
    variables, port, _, _ = detector
    sd = convert_flax_variables(variables, port)        # strict both ways
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves == len(port.state_dict())
    k = variables["params"]["mask_head"]["conv5_mask"]["kernel"]      # (kh, kw, I, O)
    np.testing.assert_array_equal(port.mask_head.conv5_mask.weight.numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))
    k = variables["params"]["box_head"]["fc6"]["kernel"]             # (in, out)
    np.testing.assert_array_equal(port.box_head.fc6.weight.numpy(), k.T)


@pytest.mark.parametrize("by", ["module_type", "name"])
def test_conv_transpose_bridge_matches_flax(by):
    """I = O, so only the output can tell a missing flip from a right one."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    name = "up" if by == "module_type" else "conv5_mask"
    layer = fnn.ConvTranspose(6, (2, 2), strides=(2, 2))
    params = {"kernel": rng.randn(2, 2, 6, 6).astype(np.float32),
              "bias": rng.randn(6).astype(np.float32)}
    want = np.asarray(layer.apply({"params": params}, x))
    holder = torch.nn.Module()
    setattr(holder, name, ConvTranspose(6, 6, 2))
    sd = convert_flax_variables({"params": {name: params}},
                                holder if by == "module_type" else None)
    holder.load_state_dict(sd, strict=True)
    got = _nhwc(getattr(holder, name)(_nchw(x)))
    assert got.shape == want.shape == (2, 10, 14, 6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [(64, 128), (80, 120)])
def test_fpn_matches_jax(detector, size):
    """At 80x120 the levels do not halve exactly (c5 3x4, c4 5x8), where
    only half-pixel nearest sampling agrees with the reference."""
    variables, port, _, _ = detector
    rng = np.random.RandomState(size[0])
    dims = {"c2": 64, "c3": 128, "c4": 256, "c5": 512}
    feats = {lvl: rng.randn(1, -(-size[0] // s), -(-size[1] // s), dims[lvl])
             .astype(np.float32) for lvl, s in zip(dims, (4, 8, 16, 32))}
    want = JaxFPN().apply({"params": variables["params"]["fpn"]}, feats)
    got = port.fpn({k: _nchw(v) for k, v in feats.items()})
    for lvl in ("p2", "p3", "p4", "p5", "p6"):
        assert _rel(_nhwc(got[lvl]), want[lvl]) < 1e-4, lvl


def test_heads_match_jax(detector):
    variables, port, _, _ = detector
    p = variables["params"]
    rng = np.random.RandomState(7)
    x = rng.randn(1, 8, 12, 256).astype(np.float32)
    jl, jd = JaxRPNHead().apply({"params": p["rpn"]}, x)
    tl, td = port.rpn(_nchw(x))
    assert _rel(_nhwc(tl), jl) < 1e-4 and _rel(_nhwc(td), jd) < 1e-4
    rois = rng.randn(6, 7, 7, 256).astype(np.float32)
    js, jd = JaxBoxHead(num_classes=8).apply({"params": p["box_head"]}, rois)
    ts, td = port.box_head(_nchw(rois))
    assert _rel(ts.numpy(), js) < 1e-4 and _rel(td.numpy(), jd) < 1e-4
    rois = rng.randn(6, 14, 14, 256).astype(np.float32)
    jm = JaxMaskHead(num_classes=8).apply({"params": p["mask_head"]}, rois)
    assert _rel(_nhwc(port.mask_head(_nchw(rois))), jm) < 1e-4


def test_detector_matches_jax(detector):
    _, port, img, want = detector
    got = {k: v.numpy() for k, v in port(_nchw(img)).items()}
    assert got["boxes"].shape == (8, 4) and got["masks"].shape == (8, 28, 28)
    assert want["valid"].sum() >= 2                 # the comparison has detections
    np.testing.assert_array_equal(got["valid"], np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["classes"], np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["masks"], want["masks"], atol=1e-4, rtol=0)


def test_detector_defaults_to_cuda():
    if torch.cuda.is_available():
        assert MaskRCNN(**_SMALL).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MaskRCNN(**_SMALL)
