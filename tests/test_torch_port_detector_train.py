"""The port's detector training (MaskRCNN.train_forward, the proposal losses
through a whole batch, train/proposal_loop's step) against the JAX package
on the same weights and inputs, float32 on the CPU; and the weights' way
back (to_flax_variables, msgpack_serialize) read by the JAX package.

The small detector is tests/test_proposal.py's (R-18, 64x128, 8 classes)
with train_proposal.py's top-n (64/32/16). JAX's value-and-grad of
``make_proposal_batch_loss`` is compiled once for the module, with the
frozen BN statistics as an argument, and serves every gradient and
train-step test here. The images of the gradient test are noise: the JAX
backbone always takes its space-to-depth stem, which breaks max-pool ties
on flat colours otherwise than the port's plain stem (ROADMAP.md §C)."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dmm_net_tpu.data.synthetic import synthetic_detection_frame as jax_frame
from dmm_net_tpu.models.proposal.maskrcnn import MaskRCNN as JaxMaskRCNN
from dmm_net_tpu.train.proposal_loop import \
    make_proposal_batch_loss as jax_batch_loss
from dmm_net_tpu_torch.models.proposal import MaskRCNN
from dmm_net_tpu_torch.train.proposal_loop import (make_proposal_batch_loss,
                                                   make_proposal_optimizer,
                                                   make_proposal_train_step,
                                                   proposal_batch_to,
                                                   proposal_image_loss)
from dmm_net_tpu_torch.utils.checkpoint import msgpack_restore, msgpack_serialize
from dmm_net_tpu_torch.weights import (convert_flax_variables,
                                       load_flax_variables, to_flax_variables)
from tests.test_torch_port_proposal import _nchw, _randomize, _rel

import chip_smoke as cs

_SMALL = dict(image_size=(64, 128), backbone_name="resnet18", num_classes=8,
              pre_nms_top_n=64, post_nms_top_n=32, max_detections=16)
_TRAIN_OUTS = ("rpn_objectness", "rpn_deltas", "cls_scores", "box_deltas",
               "mask_logits")


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


def _loss(jmodel):
    def loss(params, batch_stats, batch):
        return jax_batch_loss(jmodel, batch_stats)(params, batch)
    return loss


@pytest.fixture(scope="module")
def small():
    """The flax detector with randomised variables, the port's on the same
    variables (trainable), a batch-2 noise batch whose gts are shifted and
    grown copies of the port's own proposals (so every loss part has
    foreground), JAX's compiled value-and-grad, and its train_forward."""
    jmodel = JaxMaskRCNN(**_SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 128, 3)))
    variables = _randomize(shapes, seed=3)
    # the RPN's box deltas are its bias alone: random deltas near the
    # decode's clip (exp(4.135) = 62) turn the convolutions' ~1e-6 float32
    # differences into proposals ~2.5e-4 px apart, which ROI-Align passes
    # on to the heads' gradients at ~2e-4; with a zero kernel both packages
    # decode the same proposals, and the kernel's gradient is still taken
    rpn_box = variables["params"]["rpn"]["bbox_pred"]
    rpn_box["kernel"] = np.zeros_like(rpn_box["kernel"])
    # the mask head's convolutions biased positive: with random weights
    # its pre-activations crowd ReLU's kink, where the packages' ~1e-6
    # float32 differences in the ROI features switch single terms of its
    # weight gradients on or off (JAX's own float32 gradients sit ~1e-4
    # from its float64 ones there)
    for name, layer in variables["params"]["mask_head"].items():
        if name.startswith("mask_fcn") or name == "conv5_mask":
            layer["bias"] = np.full_like(layer["bias"], 3.0)
    port = MaskRCNN(**_SMALL, device="cpu")
    load_flax_variables(port, variables)
    port.trainable_()
    rng = np.random.RandomState(11)
    images = rng.rand(2, 64, 128, 3).astype(np.float32)
    with torch.no_grad():
        outs = port.train_forward_batch(_nchw(images))
    G = 4
    batch = {"images": images, "boxes": np.zeros((2, G, 4), np.float32),
             "labels": np.zeros((2, G), np.int32), "valid": np.zeros((2, G), bool),
             "masks": np.zeros((2, G, 64, 128), np.float32)}
    for b, out in enumerate(outs):
        props = out["proposals"][out["prop_valid"]].numpy()
        wh = props[:, 2:] - props[:, :2]
        big = props[(wh >= 10).all(1)]
        for g in range(3):
            # shifted and grown by 12% (IoU ~0.65, foreground): every box
            # residual sits in smooth-L1's linear part, where the proposals'
            # float32 rounding (~1e-5 px) is not multiplied by 1 / beta = 9
            c, half = (big[g, :2] + big[g, 2:]) / 2, (big[g, 2:] - big[g, :2]) / 2
            c = c + 0.12 * 2 * half * rng.choice([-1, 1], 2)
            box = np.clip(np.concatenate([c - 1.12 * half, c + 1.12 * half]),
                          0, [128, 64, 128, 64])
            batch["boxes"][b, g] = box
            batch["labels"][b, g] = rng.randint(1, 8)
            batch["valid"][b, g] = True
            # the whole image, as tests/test_proposal_losses.py's mask test
            # has it: a crop's targets then do not move with the proposals'
            # float32 rounding (the packages' proposals differ by up to
            # ~2.5e-4 px after the decode's exp, which fractional targets
            # at a mask's edge pass into the mask head's gradient at ~3e-4)
            batch["masks"][b, g] = 1.0
    value_and_grad = jax.jit(jax.value_and_grad(_loss(jmodel), has_aux=True))
    train_forward = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=JaxMaskRCNN.train_forward))
    return jmodel, variables, port, batch, value_and_grad, train_forward


def test_train_forward_matches_jax(small):
    """The same proposals (prop_valid equal, boxes to 1e-3 px: the float32
    decode of deltas that agree to ~1e-6), raw RPN outputs and head
    outputs to 1e-4 relative; mask logits in the port's (P, C, 28, 28)."""
    _, variables, port, batch, _, train_forward = small
    for b in range(2):
        img = batch["images"][b:b + 1]
        want = jax.device_get(train_forward(variables, jnp.asarray(img)))
        with torch.no_grad():
            got = port.train_forward(_nchw(img))
        np.testing.assert_array_equal(got["anchors"].numpy(), want["anchors"])
        np.testing.assert_array_equal(got["prop_valid"].numpy(), want["prop_valid"])
        assert want["prop_valid"].sum() >= 8
        np.testing.assert_allclose(got["proposals"].numpy(), want["proposals"],
                                   atol=1e-3, rtol=0)
        w = dict(want, mask_logits=np.moveaxis(want["mask_logits"], -1, 1))
        for k in _TRAIN_OUTS:
            assert got[k].shape == w[k].shape, k
            assert _rel(got[k].numpy(), w[k]) < 1e-4, k


def _grads_as_flax(model):
    """The model's parameter gradients as a flax params tree."""
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), model.parameters()):
            p.copy_(g.grad)
    return to_flax_variables(holder)["params"]


def test_batch_loss_gradient_matches_jax_every_leaf(small):
    """At batch 2: the loss, each part, and the gradient of every parameter
    leaf (BN scales and biases included) equal JAX's jax.grad of
    make_proposal_batch_loss to 1e-4 relative (max |d| over max |grad| per
    leaf)."""
    _, variables, port, batch, value_and_grad, _ = small
    (want, want_parts), jgrads = value_and_grad(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    port.zero_grad(set_to_none=True)
    loss, parts = make_proposal_batch_loss(port)(proposal_batch_to(batch, "cpu"))
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-4 * abs(float(want))
    for k, v in parts.items():
        assert float(want_parts[k]) > 0, k            # every part is exercised
        assert abs(v.item() - float(want_parts[k])) <= 1e-4 * abs(float(want_parts[k])), k
    got = _grads_as_flax(port)
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads))
    gl = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(jl) == len(gl) == len(list(port.parameters()))
    for path, g in jl:
        name = jax.tree_util.keystr(path)
        assert np.abs(g).max() > 0, name
        assert _rel(gl[path], g) < 1e-4, name


def jax_proposal_steps(value_and_grad, variables, batches, lr=1e-4):
    """JAX's train steps (the body of make_proposal_train_step: value and
    grad of make_proposal_batch_loss, optax.adamw(lr, weight_decay=1e-5))
    -> per-step loss and grad norm. AdamW is elementwise, so it runs on the
    parameters raveled into one vector: one small compile, where the tree's
    ~200 leaves cost seconds of compiling."""
    tx = optax.adamw(lr, weight_decay=1e-5)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state,
                optax.global_norm(grads))

    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    cuts = np.cumsum([x.size for x in leaves])[:-1]

    def ravel(tree):
        return np.concatenate([np.ravel(x) for x in
                               jax.tree_util.tree_leaves(jax.device_get(tree))])

    def unravel(flat):
        return jax.tree_util.tree_unflatten(treedef, [
            v.reshape(x.shape) for v, x in zip(np.split(flat, cuts), leaves)])

    flat, bs = ravel(variables["params"]), variables["batch_stats"]
    opt_state = tx.init(flat)
    out = {"loss": [], "grad_norm": []}
    for batch in batches:
        (loss, _), grads = value_and_grad(
            unravel(flat), bs, {k: jnp.asarray(v) for k, v in batch.items()})
        flat, opt_state, norm = update(ravel(grads), opt_state, flat)
        flat = np.asarray(flat)
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(norm))
    return out


def test_proposal_steps_reference_values(small):
    """chip_smoke.py phase 9c holds the card to JAX_PROPOSAL_STEPS: the
    port's seeded weights (to_flax_variables) trained 3 steps by the JAX
    package at batch 2 on synthetic_detection_frame seeds 0-5. Recompute
    it here, and the port's CPU steps beside it (1e-4 relative)."""
    _, _, _, _, value_and_grad, _ = small
    frames = [jax_frame(seed=s, H=64, W=128, max_objects=4, num_classes=8)
              for s in cs.PROPOSAL_STEPS["seeds"]]
    port = MaskRCNN(**cs.PROPOSAL_STEPS["detector"], device="cpu",
                    seed=cs.PROPOSAL_STEPS["seed"])
    want = jax_proposal_steps(value_and_grad, to_flax_variables(port),
                              cs.proposal_batches(frames))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(want[k], cs.JAX_PROPOSAL_STEPS[k], rtol=1e-5)
    got = cs.proposal_train_steps("cpu")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


def test_batch_loss_is_the_mean_of_per_image_losses(small):
    """The batch runs the backbone once; each image's loss is still its own
    (frozen BN): the batch loss and its parts are the means of
    proposal_image_loss's, each image alone (1e-5 relative)."""
    port, batch = small[2], proposal_batch_to(small[3], "cpu")
    with torch.no_grad():
        loss, parts = make_proposal_batch_loss(port)(batch)
        each = [proposal_image_loss(port, batch["images"][b], batch["boxes"][b],
                                    batch["labels"][b], batch["valid"][b],
                                    batch["masks"][b]) for b in range(2)]
    want = torch.stack([t for t, _ in each]).mean()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    for k, v in parts.items():
        w = torch.stack([p[k] for _, p in each]).mean().item()
        assert abs(v.item() - w) <= 1e-5 * abs(w) + 1e-7, k


def test_train_step_updates_like_adamw_and_refuses_a_mesh(small):
    port = MaskRCNN(**_SMALL, device="cpu", seed=2).trainable_()
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        make_proposal_train_step(port, make_proposal_optimizer(port, 1e-4),
                                 mesh=object())
    with pytest.raises(ValueError, match="trainable"):
        frozen = MaskRCNN(**_SMALL, device="cpu", seed=2)
        make_proposal_train_step(frozen, make_proposal_optimizer(frozen, 1e-4))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    step = make_proposal_train_step(port, make_proposal_optimizer(port, 1e-4))
    out = step(proposal_batch_to(small[3], "cpu"))
    assert all(torch.isfinite(v) for v in out.values())
    after = port.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert moved and not any(k.endswith(("running_mean", "running_var"))
                             for k in moved)           # BN stays frozen
    assert any(k.endswith("bn_init.weight") for k in moved)   # its scale trains


# ---------------------------------------------------------------------------
# the weights' way back
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deform", [(), ("c3", "c4", "c5")])
def test_to_flax_variables_inverts_the_bridge(deform):
    """to_flax_variables then convert_flax_variables gives the state_dict
    back bit for bit, a flax tree loaded and read back is itself bit for
    bit, and the tree has the JAX package's names, shapes and leaf count
    (with DCNv2 stages too)."""
    kw = dict(_SMALL, deform_stages=deform)
    port = MaskRCNN(**kw, device="cpu", seed=4)
    with torch.no_grad():                          # non-zero offset predictors
        for n, p in port.named_parameters():
            if "offset_conv" in n:
                p.normal_(0.0, 0.1)
    tree = to_flax_variables(port)
    shapes = jax.eval_shape(JaxMaskRCNN(**kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 128, 3)))
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(shapes)
    for (path, a), (_, s) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves_with_path(shapes)):
        assert a.shape == s.shape and a.dtype == np.float32, jax.tree_util.keystr(path)
    back = convert_flax_variables(tree, port)
    sd = port.state_dict()
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # and the other way: a flax tree through the port and back
    theirs = _randomize(shapes, seed=6)
    load_flax_variables(port, theirs)
    again = to_flax_variables(port)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(again),
                                jax.tree_util.tree_leaves_with_path(theirs)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_jax_detector_on_the_ports_saved_weights_gives_its_detections(small):
    """The port's weights through msgpack_serialize, read by
    flax.serialization.msgpack_restore into the JAX MaskRCNN: the same
    detections as the port's (tolerances of tests/test_torch_port_proposal)."""
    from flax import serialization
    port = small[2]
    variables = serialization.msgpack_restore(msgpack_serialize(to_flax_variables(port)))
    img = small[3]["images"][:1]
    want = jax.device_get(jax.jit(JaxMaskRCNN(**_SMALL).apply)(variables,
                                                               jnp.asarray(img)))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in port(_nchw(img)).items()}
    assert want["valid"].sum() >= 2
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["masks"], want["masks"], atol=1e-4, rtol=0)
    back = msgpack_restore(msgpack_serialize(to_flax_variables(port)))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(variables)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
