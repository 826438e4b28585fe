"""graft_entry_torch.py on the CPU: ``entry`` against the JAX package's
__graft_entry__.entry at a tiny flagship configuration (the same inputs,
the same variables carried across), the step fed its own state, and
``dryrun_multichip`` over two gloo ranks."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
import graft_entry_torch
from dmm_net_tpu.config import preset as jax_preset
from dmm_net_tpu_torch.config import preset
from test_torch_port_train_step import few_threads  # noqa: F401

# p3 with few pixels, objects and channels; the decoder and masks in
# float32, so that labels can be compared exactly (the B1 and B2 paths stay)
TINY = {"model.backbone": "resnet18", "model.backbone_dtype": "float32",
        "model.image_size": (64, 128), "matching.max_templates": 4,
        "matching.max_proposals": 8, "model.feature_dim": 32,
        "model.decoder_dim": 16, "model.decoder_dtype": "float32",
        "model.mask_dtype": "float32"}


def _configs(logits_res):
    tiny = {**TINY, "model.logits_res": logits_res}
    return (jax_preset("p3_multi_object").override(**tiny),
            preset("p3_multi_object").override(**tiny))


@pytest.fixture(scope="module")
def jax_entry():
    """__graft_entry__.entry at TINY with the flagship's mask-grid logits:
    its example arguments, and the variables its ``model.init`` makes with
    PRNGKey(0). That init runs under jax.jit here (the same values as
    eager, which compiles op by op and takes several times as long); both
    logits_res cases share them, the parameters being the same."""
    import jax

    import dmm_net_tpu.models.dmm as jax_dmm
    base, made = jax_dmm.DMMNet, {}

    class JitInit(base):
        def init(self, *args):
            made["variables"] = jax.jit(lambda *a: base.init(self, *a))(*args)
            return made["variables"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dmm, "DMMNet", JitInit)
        mp.setattr(jax_graft, "_flagship_config", lambda: _configs("mask")[0])
        _, jargs = jax_graft.entry()
    return jargs, jax.device_get(made["variables"])


@pytest.mark.parametrize("logits_res", ["full", "mask"])
def test_entry_matches_the_jax_entry(logits_res, jax_entry, monkeypatch,
                                     few_threads):  # noqa: F811
    """The JAX entry's example arguments and variables (``jax_entry``),
    loaded into the port's entry (weights.load_flax_variables), against the
    JAX entry's frame step (``model.apply`` and ``resolve_labels`` as its
    ``fn`` makes them) at each logits_res: the same example arguments, X
    within 1e-5, and the step fed its own state runs again.

    Labels: random weights give every object nearly the same logit (at a
    pixel the four differ by ~1e-7 of ~0.14), and the two packages' float32
    logits differ by up to ~2.4e-7 (convolutions summed in another order),
    so the argmax between objects is a coin toss at a few pixels: 21 of
    8192 (0.26%) with full-resolution logits, 32 with the flagship's
    mask-grid logits, whose label pass (B2) rounds them to bf16 first, as
    the reference's kernel does. So: with full-resolution logits the labels
    are equal wherever JAX's two best candidates (objects and background)
    are more than 5e-7 apart (where no logit difference of 2.4e-7 can swap
    them); with mask-grid logits the port's label pass on JAX's own logits
    gives JAX's labels exactly; and in both the entry's labels agree on at
    least 99% of the pixels."""
    import jax

    from dmm_net_tpu.infer.engine import resolve_labels as jax_resolve
    from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
    from dmm_net_tpu_torch.infer.engine import resolve_labels

    jax_cfg, cfg = _configs(logits_res)
    monkeypatch.setattr(graft_entry_torch, "_flagship_config", lambda: cfg)
    jargs, variables = jax_entry
    fn, args = graft_entry_torch.entry(device="cpu", variables=variables)
    for a, b in zip(args[:5], jargs[:5]):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    for a, b in zip(args[5], jargs[5]):     # resized to the mask grid by each
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=1e-6)
    out = jax.jit(JaxDMMNet(jax_cfg).apply)(variables, *jargs)[0]
    logits = out.logits
    want_labels = np.asarray(jax_resolve(logits, jargs[4], (64, 128),
                                         use_pallas=jax_cfg.matching.use_pallas))
    want_x = np.asarray(out.assignment)
    labels, X, state = fn(*args)
    assert labels.dtype == torch.uint8 and labels.shape == (1, 64, 128)
    np.testing.assert_allclose(X.numpy(), want_x, atol=1e-5)
    if logits_res == "full":
        cand = np.concatenate([np.asarray(logits)[0], np.zeros((1, 64, 128))])
        top2 = np.sort(cand, axis=0)[-2:]
        decided = top2[1] - top2[0] > 5e-7     # twice the logits' distance
        np.testing.assert_array_equal(labels.numpy()[0][decided],
                                      want_labels[0][decided])
        assert (labels.numpy() == want_labels).mean() >= 0.99
    else:
        np.testing.assert_array_equal(
            resolve_labels(torch.from_numpy(np.array(logits)), args[4], (64, 128)).numpy(),
            want_labels)
        assert (labels.numpy() == want_labels).mean() >= 0.99
    assert state.template_masks.dtype == args[5].template_masks.dtype
    labels2, X2, _ = fn(*args[:5], state)
    assert labels2.shape == labels.shape and torch.isfinite(X2).all()


def test_entry_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry_torch.entry()


def test_dryrun_multichip_on_two_gloo_ranks(monkeypatch):
    """Two spawned ranks on the CPU (gloo, the plain versions), two threads
    each: a finite loss equal on both ranks and the whole batch's labels
    gathered to each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    r0, r1 = graft_entry_torch.dryrun_multichip(2, device="cpu")
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["backend"] == r1["backend"] == "gloo"
    assert np.isfinite(r0["loss"]) and r0["loss"] == r1["loss"]
    assert r0["labels_shape"][1] == 2 and r0["labels_shape"] == r1["labels_shape"]
    assert r0["launches"]["fused_pool_cost_match"] == 0     # CPU: plain versions
