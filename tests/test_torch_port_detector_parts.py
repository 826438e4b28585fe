"""Parts of the port's detector training against the JAX package, float32
on the CPU: the proposal losses (target assignment included), B4' (the
ROI-Align backward), COCO-protocol AP, the msgpack writer, and DCNv2.

Inputs come from numpy seeds; the JAX package is channel-last and the
port channel-first, so tensors are transposed on the way between them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dmm_net_tpu.eval import detection_ap as jax_ap
from dmm_net_tpu.models.proposal import losses as jl
from dmm_net_tpu.models.proposal.maskrcnn import \
    _multilevel_roi_align as jax_multilevel_roi_align
from dmm_net_tpu.models.resnet import ResNet18 as JaxResNet18
from dmm_net_tpu.ops.deform_conv import DeformConv as JaxDeformConv
from dmm_net_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from dmm_net_tpu_torch.eval import detection_ap
from dmm_net_tpu_torch.kernels import backward_calls, reset_launch_counts
from dmm_net_tpu_torch.kernels.roi_align import multilevel_roi_align
from dmm_net_tpu_torch.models.proposal import losses
from dmm_net_tpu_torch.models.proposal.maskrcnn import MaskRCNN, top_k_indices
from dmm_net_tpu_torch.models.resnet import backbone_by_name
from dmm_net_tpu_torch.ops.deform_conv import DeformConv, deform_conv2d
from dmm_net_tpu_torch.utils.checkpoint import msgpack_restore, msgpack_serialize
from dmm_net_tpu_torch.weights import (convert_flax_variables, load_flax_variables,
                                       to_flax_variables)
from tests.test_torch_port_proposal import (_nchw, _nhwc, _randomize, _rel,
                                            multilevel_problem)

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU work here is small ops that torch would spread over
    every core; with other test processes on the host that oversubscribes
    it several times over (3 small train steps: 48 s at 8 threads, 6 s at
    2, on a loaded 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _boxes(rng, n, H=64, W=128, lo=2.0):
    xy = rng.rand(n, 2) * [W - 8, H - 8]
    wh = lo + rng.rand(n, 2) * [W / 2, H / 2]
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _problem(seed, A=300, P=24, G=6, C=5, H=64, W=128):
    """Anchors, proposals (some invalid), padded gts (the last two invalid,
    zero boxes) with labels and masks, and random head outputs."""
    rng = np.random.RandomState(seed)
    gt = _boxes(rng, G, H, W, lo=6.0)
    gt[G - 2:] = 0.0
    anchors = np.concatenate([_boxes(rng, A - 10, H, W),
                              gt[:3].repeat(3, 0)[:10] + rng.randn(9, 4).astype(np.float32),
                              gt[:1]], 0).astype(np.float32)
    props = np.concatenate([gt[:4] + rng.randn(4, 4).astype(np.float32),
                            _boxes(rng, P - 4, H, W)], 0).astype(np.float32)
    masks = (rng.rand(G, H, W) > 0.5).astype(np.float32)
    return dict(
        anchors=anchors[:A], gt=gt, gt_valid=np.arange(G) < G - 2,
        gt_labels=rng.randint(1, C, G).astype(np.int32), gt_masks=masks,
        props=props, prop_valid=rng.rand(P) > 0.2,
        obj=rng.randn(A).astype(np.float32),
        deltas=(rng.randn(A, 4) * 0.3).astype(np.float32),
        scores=rng.randn(P, C).astype(np.float32),
        box_deltas=(rng.randn(P, C * 4) * 0.3).astype(np.float32),
        mask_logits=rng.randn(P, 28, 28, C).astype(np.float32))


def test_smooth_l1_matches_jax():
    x = np.random.RandomState(0).randn(500).astype(np.float32) * 0.3
    for beta in (1.0 / 9.0, 0.5):
        np.testing.assert_allclose(losses.smooth_l1(T(x), beta).numpy(),
                                   jl.smooth_l1(x, beta), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_anchors_and_proposals_match_jax(seed):
    p = _problem(seed)
    labels, matched = losses.assign_anchors(T(p["anchors"]), T(p["gt"]),
                                            T(p["gt_valid"]))
    jlab, jm = jl.assign_anchors(p["anchors"], p["gt"], p["gt_valid"])
    np.testing.assert_array_equal(labels.numpy(), jlab)
    np.testing.assert_array_equal(matched.numpy(), jm)
    assert set(np.unique(jlab)) == {-1, 0, 1}
    cls_t, pm = losses.assign_proposals(T(p["props"]), T(p["prop_valid"]),
                                        T(p["gt"]), T(p["gt_labels"]),
                                        T(p["gt_valid"]))
    jc, jpm = jl.assign_proposals(p["props"], p["prop_valid"], p["gt"],
                                  p["gt_labels"], p["gt_valid"])
    np.testing.assert_array_equal(cls_t.numpy(), jc)
    np.testing.assert_array_equal(pm.numpy(), jpm)
    assert (jc > 0).any()


@pytest.mark.parametrize("padded_after", [True, False])
def test_assign_anchors_anchor0_force_match_follows_jax(padded_after):
    """A valid gt whose best anchor is anchor 0, at IoU under 0.3. Padded
    gts' all -1 IoU columns also pick anchor 0; where one follows the valid
    gt, JAX's scatter (last write wins on the CPU) keeps anchor 0's own
    label 0, else the force-match makes it 1. The port gives JAX's label
    either way."""
    anchors = np.array([[0, 0, 40, 40], [60, 60, 70, 70], [100, 0, 110, 10]],
                       np.float32)
    gt = np.array([[0, 0, 10, 10], [0, 0, 0, 0]], np.float32)
    valid = np.array([True, False])
    if not padded_after:
        gt, valid = gt[::-1].copy(), valid[::-1].copy()
    jlab, _ = jl.assign_anchors(jnp.asarray(anchors), jnp.asarray(gt),
                                jnp.asarray(valid))
    labels, _ = losses.assign_anchors(T(anchors), T(gt), T(valid))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlab))
    assert labels[0].item() == (0 if padded_after else 1)


def _grad(fn, *args):
    xs = [T(a.copy()).requires_grad_(True) for a in args]
    out = fn(*xs)
    return out, torch.autograd.grad(out, xs)


@pytest.mark.parametrize("seed", [0, 1])
def test_rpn_loss_matches_jax(seed):
    p = _problem(seed)
    a, g, v = T(p["anchors"]), T(p["gt"]), T(p["gt_valid"])
    parts = losses.rpn_loss(T(p["obj"]), T(p["deltas"]), a, g, v)
    want = jax.jit(jl.rpn_loss)(p["obj"], p["deltas"], p["anchors"], p["gt"],
                                p["gt_valid"])
    for k in ("rpn_cls", "rpn_reg"):
        assert float(want[k]) > 0
        np.testing.assert_allclose(parts[k].item(), float(want[k]), rtol=1e-5)

    def jtot(o, d):
        r = jl.rpn_loss(o, d, *map(jnp.asarray, (p["anchors"], p["gt"], p["gt_valid"])))
        return r["rpn_cls"] + r["rpn_reg"]
    _, (go, gd) = _grad(lambda o, d: sum(losses.rpn_loss(o, d, a, g, v).values()),
                        p["obj"], p["deltas"])
    jo, jd = jax.jit(jax.grad(jtot, argnums=(0, 1)))(p["obj"], p["deltas"])
    assert _rel(go.numpy(), jo) < 1e-5 and _rel(gd.numpy(), jd) < 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_box_and_mask_head_losses_match_jax(seed):
    p = _problem(seed)
    gt_args = (T(p["gt"]), T(p["gt_labels"]), T(p["gt_valid"]))

    def box(s, d):
        r = losses.box_head_loss(s, d, T(p["props"]), T(p["prop_valid"]), *gt_args)
        return r["box_cls"] + r["box_reg"]

    def jbox(s, d):
        r = jl.box_head_loss(s, d, *map(jnp.asarray, (
            p["props"], p["prop_valid"], p["gt"], p["gt_labels"], p["gt_valid"])))
        return r["box_cls"] + r["box_reg"]

    parts = losses.box_head_loss(T(p["scores"]), T(p["box_deltas"]), T(p["props"]),
                                 T(p["prop_valid"]), *gt_args)
    want = jax.jit(jl.box_head_loss)(p["scores"], p["box_deltas"], p["props"],
                                     p["prop_valid"], p["gt"], p["gt_labels"],
                                     p["gt_valid"])
    for k in ("box_cls", "box_reg"):
        assert float(want[k]) > 0
        np.testing.assert_allclose(parts[k].item(), float(want[k]), rtol=1e-5)
    _, (gs, gd) = _grad(box, p["scores"], p["box_deltas"])
    js, jd = jax.jit(jax.grad(jbox, argnums=(0, 1)))(p["scores"], p["box_deltas"])
    assert _rel(gs.numpy(), js) < 1e-5 and _rel(gd.numpy(), jd) < 1e-5

    cls_t, matched = jax.jit(jl.assign_proposals)(p["props"], p["prop_valid"], p["gt"],
                                                  p["gt_labels"], p["gt_valid"])
    ct, mt = T(np.asarray(cls_t).astype(np.int64)), T(np.asarray(matched).astype(np.int64))
    crops = losses.crop_gt_mask(T(p["gt_masks"])[mt], T(p["props"]))
    jcrops = jax.vmap(jl.crop_gt_mask)(jnp.asarray(p["gt_masks"])[matched],
                                       jnp.asarray(p["props"]))
    np.testing.assert_allclose(crops.numpy(), jcrops, atol=1e-5, rtol=0)
    logits = np.ascontiguousarray(np.moveaxis(p["mask_logits"], -1, 1))
    loss, (gm,) = _grad(lambda m: losses.mask_head_loss(
        m, T(p["props"]), ct, mt, T(p["gt_masks"])), logits)
    jloss, jgm = jax.value_and_grad(lambda m: jl.mask_head_loss(
        m, p["props"], cls_t, matched, p["gt_masks"]))(p["mask_logits"])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert _rel(_nhwc(gm), jgm) < 1e-5


# ---------------------------------------------------------------------------
# B4': the ROI-Align backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(1344, 1000), (336, 1000), (21504, 1000)])
def test_proposal_top_k_orders_ties_as_jax(n, k):
    """The RPN's per-level top-k (a level of the small detector's anchors,
    and of the 256x448 detector's p2) on scores with many exact ties, as
    random or flat-image weights give: the same indices in the same order
    as jax.lax.top_k."""
    scores = np.random.RandomState(n).randint(0, 6, n).astype(np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores), min(k, n))[1])
    got = top_k_indices(T(scores), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_b4_backward_passes_gradcheck_in_float64():
    """The Function's backward (autograd through the plain version) against
    finite differences, float64, at a tiny size with boxes on every level."""
    rng = np.random.RandomState(0)
    levels = [torch.tensor(rng.randn(2, 64 >> l, 96 >> l), dtype=torch.float64,
                           requires_grad=True) for l in (2, 3, 4, 5)]
    boxes = torch.tensor([[3, 4, 20, 30], [0, 0, 96, 64], [10, 5, 200, 180],
                          [40, 20, 41, 21], [-5, -5, 60, 50]], dtype=torch.float32)
    assert torch.autograd.gradcheck(
        lambda *lv: multilevel_roi_align(lv, boxes, (3, 2)), levels, eps=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
def test_b4_backward_matches_jax_vjp(out_size):
    """The four level gradients of a seeded upstream gradient equal JAX's
    jax.vjp of the reference's _multilevel_roi_align (1e-5 relative); the
    boxes take no gradient, and the CPU counts no backward call."""
    maps, boxes = multilevel_problem(0)
    cot = np.random.RandomState(1).randn(len(boxes), *out_size, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda m: jax_multilevel_roi_align(m, jnp.asarray(boxes),
                                                        out_size),
                     {k: jnp.asarray(v) for k, v in maps.items()})
    (want,) = vjp(jnp.asarray(cot))
    levels = [_nchw(maps[f"p{l}"])[0].requires_grad_(True) for l in (2, 3, 4, 5)]
    reset_launch_counts()
    out = multilevel_roi_align(levels, T(boxes), out_size)
    grads = torch.autograd.grad(out, levels, _nchw(cot))
    assert backward_calls()["roi_align"] == 0
    for l, g in zip((2, 3, 4, 5), grads):
        w = np.asarray(want[f"p{l}"])[0]
        assert np.abs(w).max() > 0
        assert _rel(np.moveaxis(g.numpy(), 0, -1), w) < 1e-5, l
    with pytest.raises(ValueError, match="boxes must not require"):
        multilevel_roi_align(levels, T(boxes).requires_grad_(True), out_size)


# ---------------------------------------------------------------------------
# COCO-protocol AP
# ---------------------------------------------------------------------------

def _ap_problem(seed, n_img=4, H=32, W=48):
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_img):
        G, K = 5, 9
        gb = _boxes(rng, G, H, W, lo=4.0)
        gm = (rng.rand(G, H, W) > 0.6).astype(np.float32)
        gl = rng.randint(1, 4, G)
        gv = rng.rand(G) > 0.2
        pb = np.concatenate([gb + rng.randn(G, 4).astype(np.float32) * 2,
                             _boxes(rng, K - G, H, W)], 0)
        pm = np.concatenate([np.abs(gm - (rng.rand(G, H, W) > 0.85)),
                             rng.rand(K - G, H, W) > 0.5], 0).astype(np.float32)
        pc = np.concatenate([gl, rng.randint(1, 4, K - G)])
        pc[rng.rand(K) > 0.8] = rng.randint(1, 4)
        preds.append({"boxes": pb, "scores": rng.rand(K).astype(np.float32),
                      "classes": pc, "valid": rng.rand(K) > 0.1, "masks": pm})
        gts.append({"boxes": gb, "labels": gl, "valid": gv, "masks": gm})
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou_type", ["box", "mask"])
def test_detection_ap_matches_jax(seed, iou_type):
    preds, gts = _ap_problem(seed)
    got = detection_ap.evaluate_detections(preds, gts, iou_type=iou_type)
    want = jax_ap.evaluate_detections(preds, gts, iou_type=iou_type)
    assert got.keys() == want.keys() and 0 < want["AP50"] < 1
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, k


# ---------------------------------------------------------------------------
# the msgpack writer
# ---------------------------------------------------------------------------

def test_msgpack_both_ways_with_flax():
    """The tree train_proposal_torch.py --save writes (a seeded small
    detector's to_flax_variables, keys in module order), one with a
    float16, an int32, a bool and an empty leaf, and one with the values a
    config dict holds (str, ints of every width, float, bool, None, lists):
    the port's bytes equal flax's, each package reads the other's bytes
    into identical values, and a value the writer has no form for (a tuple,
    a numpy scalar, a non-str key) raises."""
    rng = np.random.RandomState(0)
    det = to_flax_variables(MaskRCNN(image_size=(64, 128), backbone_name="resnet18",
                                     num_classes=8, device="cpu", seed=1))
    odd = {"z" * 40: {"half": rng.randn(17).astype(np.float16),
                      "ints": np.arange(-3, 300, dtype=np.int32)},
           "flags": rng.rand(5) > 0.5, "empty": np.zeros((0, 3), np.float32)}
    config = {"name": "x" * 40, "n": 3, "big": 2 ** 40, "neg": [-1, -33, -200, -2 ** 33],
              "f": 0.03, "b": True, "none": None, "size": [256, 448],
              "x": [np.zeros(2, np.float32)], "nested": {"k": "v", "e": []}}
    for tree in (det, odd, config):
        mine, theirs = msgpack_serialize(tree), serialization.msgpack_serialize(tree)
        assert mine == theirs
        for a, b in ((serialization.msgpack_restore(mine), tree),
                     (msgpack_restore(theirs), tree)):
            la = jax.tree_util.tree_leaves_with_path(a)
            lb = jax.tree_util.tree_leaves_with_path(b)
            assert [p for p, _ in la] == [p for p, _ in lb]
            for (path, x), (_, y) in zip(la, lb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
                assert np.asarray(x).dtype == np.asarray(y).dtype, path
    for bad in ({"t": (1, 2)}, {"s": np.float32(1.0)}, {1: np.zeros(2)}):
        with pytest.raises(TypeError):
            msgpack_serialize(bad)


# ---------------------------------------------------------------------------
# DCNv2
# ---------------------------------------------------------------------------

def _dcn_case(kind, seed=0, B=2, Ci=5, Co=6, H=9, W=11):
    rng = np.random.RandomState(seed)
    stride = 2 if kind == "stride2" else 1
    Ho, Wo = -(-H // stride), -(-W // stride)
    scale = {"zero": 0.0, "stride2": 1.3, "out_of_bounds": 6.0}[kind]
    return (rng.randn(B, H, W, Ci).astype(np.float32),
            (rng.randn(B, Ho, Wo, 9, 2) * scale).astype(np.float32),
            (rng.randn(3, 3, Ci, Co) / np.sqrt(9 * Ci)).astype(np.float32),
            rng.uniform(0.2, 1.8, (B, Ho, Wo, 9)).astype(np.float32), stride)


@pytest.mark.parametrize("kind", ["zero", "stride2", "out_of_bounds"])
def test_deform_conv2d_matches_jax_forward_and_gradient(kind):
    """Forward (1e-5 relative) and the gradients with respect to the input,
    the offsets, the weights and the modulation (1e-4 relative) of
    sum(out * cot); out-of-bounds taps included (offsets of +-6 px on a
    9x11 map)."""
    x, off, w, mod, s = _dcn_case(kind)
    want, vjp = jax.vjp(lambda *a: jax_deform_conv2d(*a, strides=(s, s)),
                        x, off, w, mod)
    cot = np.random.RandomState(5).randn(*want.shape).astype(np.float32)
    jg = vjp(jnp.asarray(cot))
    args = [_nchw(x), T(np.ascontiguousarray(off.transpose(0, 3, 4, 1, 2))),
            T(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
            T(np.ascontiguousarray(mod.transpose(0, 3, 1, 2)))]
    args = [a.requires_grad_(True) for a in args]
    out = deform_conv2d(*args, stride=(s, s))
    assert _rel(_nhwc(out), want) < 1e-5
    g = torch.autograd.grad(out, args, _nchw(cot))
    back = [np.moveaxis(g[0].numpy(), 1, -1), g[1].numpy().transpose(0, 3, 4, 1, 2),
            g[2].numpy().transpose(2, 3, 1, 0), g[3].numpy().transpose(0, 2, 3, 1)]
    for name, a, b in zip(("x", "offsets", "weights", "modulation"), back, jg):
        assert np.abs(np.asarray(b)).max() > 0, name
        assert _rel(a, b) < 1e-4, name


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_module_matches_flax(stride):
    """DeformConv with a non-zero offset predictor, through the weight
    bridge: output and the gradients of the input and every parameter."""
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 10, 12, 4).astype(np.float32)
    layer = JaxDeformConv(6, strides=(stride, stride))
    params = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.3).astype(np.float32),
        jax.eval_shape(layer.init, jax.random.PRNGKey(0), x))["params"]
    want, vjp = jax.vjp(lambda p, xx: layer.apply({"params": p}, xx), params, x)
    cot = rng.randn(*want.shape).astype(np.float32)
    jp, jx = vjp(jnp.asarray(cot))
    port = DeformConv(4, 6, 3, stride)
    port.load_state_dict(convert_flax_variables({"params": params}, port))
    xt = _nchw(x).requires_grad_(True)
    out = port(xt)
    assert _rel(_nhwc(out), want) < 1e-5
    out.backward(_nchw(cot))
    assert _rel(_nhwc(xt.grad), jx) < 1e-4
    assert _rel(port.weight.grad.numpy().transpose(2, 3, 1, 0), jp["kernel"]) < 1e-4
    assert _rel(port.offset_conv.weight.grad.numpy().transpose(2, 3, 1, 0),
                jp["offset_conv"]["kernel"]) < 1e-4
    assert _rel(port.offset_conv.bias.grad.numpy(), jp["offset_conv"]["bias"]) < 1e-4


def test_dcn_backbone_and_detector_weights_match_jax():
    """A DCN ResNet-18 (c3..c5 deformable, random non-zero offset
    predictors) gives JAX's c2..c5 (1e-4 relative; JAX's plain stem, since
    its space-to-depth stem breaks max-pool ties otherwise, ROADMAP.md §C);
    a DCN MaskRCNN's flax tree maps onto the port's with nothing left over,
    and the port's own DCN init is a plain conv (zero offset predictors)."""
    stages = ("c3", "c4", "c5")
    x = np.random.RandomState(2).rand(1, 64, 96, 3).astype(np.float32)
    jnet = JaxResNet18(dtype=jnp.float32, deform_stages=stages, s2d_stem=False)
    variables = _randomize(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x), 4)
    want = jax.jit(jnet.apply)(variables, x)
    port = backbone_by_name("resnet18", dtype=torch.float32, deform_stages=stages)
    load_flax_variables(port, variables)
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x))
    for lvl in ("c2", "c3", "c4", "c5"):
        assert _rel(_nhwc(got[lvl]), want[lvl]) < 1e-4, lvl
    assert "deform0" in dict(port.blocks[2].named_children())

    kw = dict(image_size=(64, 128), backbone_name="resnet50", num_classes=8,
              deform_stages=stages)
    from dmm_net_tpu.models.proposal.maskrcnn import MaskRCNN as JaxMaskRCNN
    shapes = jax.eval_shape(JaxMaskRCNN(**kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 128, 3)))
    det = MaskRCNN(**kw, device="cpu")
    sd = convert_flax_variables(_randomize(shapes, 5), det)   # strict both ways
    assert len(sd) == len(jax.tree_util.tree_leaves(shapes)) == len(det.state_dict())
    assert all((m.offset_conv.weight == 0).all() for m in det.modules()
               if isinstance(m, DeformConv))
