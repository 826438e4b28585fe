"""train_torch.py on the CPU, in-process: synthetic steps, a DAVIS-layout
train tree, resume, serving its checkpoint through infer_torch.py, and the
refusals (no CUDA without --device cpu; a batch that does not divide over
--data-parallel's ranks)."""

import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
import infer_torch
import train_torch
from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt
from dmm_net_tpu_torch.weights import convert_flax_variables
from test_torch_port_train_step import few_threads  # noqa: F401

TINY = ["model.backbone=resnet18", "model.backbone_dtype=float32",
        "model.image_size=64,64", "model.feature_dim=32",
        "model.decoder_dim=16", "matching.max_templates=4",
        "matching.max_proposals=8", "data.batch_size=2", "data.clip_length=3",
        "train.warmup_steps=0", "train.checkpoint_every=2"]


def _train(logdir, steps, *sets, resume=False):
    argv = ["--device", "cpu", "--steps", str(steps), "--logdir", str(logdir),
            "--set", *TINY, *sets]
    return train_torch.main(argv + (["--resume"] if resume else []))


def test_synthetic_steps_log_and_checkpoint(tmp_path):
    """10 steps: a metrics line every 10 steps (train.py's interval), a
    checkpoint every train.checkpoint_every (2) and at the end, the last 3
    kept."""
    r = _train(tmp_path, 10, "data.dataset=synthetic")
    assert r["step"] == 10 and len(r["history"]) == 10
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all()
               for h in r["history"])
    lines = [json.loads(x) for x in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [10]
    assert lines[0]["loss"] == r["history"][-1]["loss"]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_00000006.pt", "step_00000008.pt", "step_00000010.pt"]


def test_resume_is_bit_equal(tmp_path):
    """4 steps straight == 2 steps, then --resume for 2 more (the data seed
    and the augmentation seed continue from the step)."""
    straight = _train(tmp_path / "a", 4, "data.dataset=synthetic")
    _train(tmp_path / "b", 2, "data.dataset=synthetic")
    resumed = _train(tmp_path / "b", 4, "data.dataset=synthetic", resume=True)
    assert resumed["step"] == 4 and len(resumed["history"]) == 2
    assert [h["loss"] for h in straight["history"][2:]] == \
        [h["loss"] for h in resumed["history"]]
    a = straight["state"].model.state_dict()
    b = resumed["state"].model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert straight["state"].optimizer.count == resumed["state"].optimizer.count
    sa = straight["state"].optimizer.adamw.state_dict()["state"]
    sb = resumed["state"].optimizer.adamw.state_dict()["state"]
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])


@pytest.mark.parametrize("pallas", [False, True])
def test_davis_tree_trains_and_serves(tmp_path, pallas):
    """A few steps on a DAVIS-layout train split (train-mode BN on the fused
    path), then the checkpoint directory served by infer_torch.py --ckpt on
    the val split."""
    root = cs.write_davis_tree(tmp_path / "DAVIS", train_seeds=(21, 22),
                               val_seeds=(23,), T=5, hw=(60, 100))
    sets = ["data.dataset=davis", f"data.root={root}"]
    if pallas:
        sets += ["matching.use_pallas=true", "model.train_bn=true"]
    r = _train(tmp_path / "run", 2, *sets)
    assert r["step"] == 2 and np.isfinite([h["loss"] for h in r["history"]]).all()
    out = tmp_path / "out"
    summary = infer_torch.main(["--ckpt", str(tmp_path / "run" / "ckpt"),
                                "--davis-root", str(root), "--out", str(out),
                                "--device", "cpu"])
    assert len(list(out.glob("val23/*.png"))) == 5
    assert np.isfinite(summary["J&F"])
    # the served weights are the trained ones
    ckpt = torch.load(r["checkpoint"], weights_only=True)
    trained = r["state"].model.state_dict()
    assert all(torch.equal(ckpt["model"][k], trained[k]) for k in trained)


def test_refusals(tmp_path):
    with pytest.raises(SystemExit, match="must divide over 3"):
        train_torch.main(["--data-parallel", "3", "--device", "cpu",
                          "--logdir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_torch.main(["--steps", "1", "--logdir", str(tmp_path),
                              "--set", *TINY, "data.dataset=synthetic"])


def _example():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_and_eval_synthetic_torch",
        cs.ROOT / "examples" / "train_and_eval_synthetic_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def test_example_trains_scores_and_saves(tmp_path, capsys):
    """examples/train_and_eval_synthetic_torch.py end to end on the CPU, cut
    to 3 steps: J&F through the engine, the saved checkpoint promoted past
    its gate (0 here), the ablation's engines; and with --mrcnn on a seeded
    detector (train_proposal_torch.py --steps 0 --save), its detections in
    place of the planted proposals."""
    example = _example()
    save = tmp_path / "dmm.msgpack"
    r = example.main(["--device", "cpu", "--steps", "3", "--size", "32",
                      "--eval-frames", "3", "--distinct-batches", "2",
                      "--min-jf", "0", "--save",
                      str(save), "--ablate"])
    assert r["steps"] == 3 and 0.0 <= r["jf"]["J&F"] <= 1.0
    assert save.exists() and not (tmp_path / "dmm.msgpack.unverified").exists()
    import train_proposal_torch
    det = tmp_path / "det.msgpack"
    train_proposal_torch.main(["--device", "cpu", "--steps", "0",
                               "--image-size", "32", "32", "--num-classes",
                               "4", "--save", str(det), "--logdir",
                               str(tmp_path / "det_log")])
    capsys.readouterr()
    r = example.main(["--device", "cpu", "--steps", "3", "--size", "32",
                      "--eval-frames", "3", "--distinct-batches", "2",
                      "--min-jf", "0", "--mrcnn", str(det)])
    assert r["steps"] == 3 and np.isfinite(r["final_loss"])
    assert ("replaced planted proposals with detector output for 2 batches"
            in capsys.readouterr().out)


def test_example_starts_from_jax_variables(tmp_path):
    """--init: the JAX package's variables for the example's configuration,
    in msgpack as its example writes them, replace the seeded init. The
    first update has lr 0 under the warmup, so after one step the saved
    model holds exactly those variables."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from dmm_net_tpu.config import (Config, DataConfig, MatchingConfig,
                                    ModelConfig, TrainConfig)
    from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
    from dmm_net_tpu.models.dmm import init_frame_state
    from test_torch_port_engine import _randomize

    S, M, N = 32, 4, 8
    cfg = Config(  # the example's, at --size 32
        name="train_and_eval",
        model=ModelConfig(backbone="resnet18", backbone_dtype="float32",
                          feature_dim=32, decoder_dim=32, decoder_obj_dim=16,
                          image_size=(S, S), template_update="aggregation"),
        matching=MatchingConfig(max_templates=M, max_proposals=N,
                                sinkhorn_iters=15, epsilon=0.03),
        data=DataConfig(dataset="synthetic", batch_size=4, clip_length=3),
        train=TrainConfig(lr=3e-4, warmup_steps=20, total_steps=1,
                          loss_iou_weight=0.5))
    tmpl = jnp.zeros((1, M, S, S))
    shapes = jax.eval_shape(
        JaxDMMNet(cfg, train=True).init, jax.random.PRNGKey(0),
        jnp.zeros((1, S, S, 3)), jnp.zeros((1, N, S, S)),
        jnp.ones((1, N), bool), jnp.zeros((1, M, 32)), jnp.ones((1, M), bool),
        init_frame_state(cfg, tmpl))
    variables = _randomize(shapes, 5)
    blob = tmp_path / "init.msgpack"
    blob.write_bytes(serialization.msgpack_serialize(
        {"config": cfg.to_dict(), "variables": jax.device_get(variables)}))

    save = tmp_path / "dmm.msgpack"
    _example().main(["--device", "cpu", "--steps", "1", "--size", str(S),
                     "--eval-frames", "3", "--distinct-batches", "1",
                     "--min-jf", "0", "--init", str(blob), "--save", str(save)])
    got = convert_flax_variables(load_msgpack_ckpt(str(save))[1])
    want = convert_flax_variables(load_msgpack_ckpt(str(blob))[1])
    assert want.keys() <= got.keys()
    assert all(torch.equal(got[k].float(), w.float()) for k, w in want.items())


def test_example_mrcnn_proposals_match_the_jax_closure(tmp_path):
    """--mrcnn's proposals: the port's ``detect_batch`` and the JAX
    example's jitted closure (examples/train_and_eval_synthetic.py, copied
    below as it stands there) on one seeded detector file (R-18 at 64x128,
    the example's 4 classes, score threshold 0.05, N=8) and one clip batch
    of the example's kind (B=2, T=2): the same binary masks in the same
    order and the same validity."""
    import argparse

    import jax
    import jax.numpy as jnp
    from flax import serialization

    from dmm_net_tpu.data.synthetic import synthetic_clip_batch
    from dmm_net_tpu.models.proposal.maskrcnn import MaskRCNN as JaxMaskRCNN
    from dmm_net_tpu.models.proposal.maskrcnn import paste_masks
    from dmm_net_tpu_torch.models.proposal import MaskRCNN
    from dmm_net_tpu_torch.utils.checkpoint import msgpack_serialize
    from dmm_net_tpu_torch.weights import to_flax_variables

    S, SW, N, classes = 64, 128, 8, 4
    path = tmp_path / "det.msgpack"
    path.write_bytes(msgpack_serialize(to_flax_variables(MaskRCNN(
        image_size=(S, SW), backbone_name="resnet18", num_classes=classes,
        device="cpu", seed=11))))
    frames = synthetic_clip_batch(seed=4, batch=2, T=2, H=S, W=SW, num_objects=2,
                                  num_proposals=N, pad_objects=4)["frames"]

    example = _example()
    det = example.load_detector(argparse.Namespace(
        mrcnn=str(path), mrcnn_backbone="resnet18", mrcnn_classes=classes),
        (S, SW), N, "cpu")
    got_pm, got_pv = example.detect_batch(det, torch.from_numpy(np.asarray(frames)))

    jdet = JaxMaskRCNN(image_size=(S, SW), backbone_name="resnet18",
                       num_classes=classes, score_thresh=0.05, max_detections=N)
    det_vars = serialization.msgpack_restore(path.read_bytes())

    @jax.jit
    def detect_batch(frames):            # (B, T, H, W, 3) on device
        def one(img):
            out = jdet.apply(det_vars, img[None])
            full = paste_masks(out["masks"], out["boxes"], out["valid"],
                               (S, SW))
            order = jnp.argsort(-jnp.where(out["valid"], out["scores"],
                                           -jnp.inf))
            return ((full[order] > 0.5).astype(jnp.float32),
                    out["valid"][order])
        B_, T_ = frames.shape[:2]
        flat = frames.reshape((B_ * T_,) + frames.shape[2:])
        pm, pv = jax.lax.map(one, flat)
        return (pm.reshape((B_, T_) + pm.shape[1:]),
                pv.reshape(B_, T_, -1))

    want_pm, want_pv = (np.asarray(x) for x in detect_batch(jnp.asarray(frames)))
    assert want_pv.sum() > 4 and want_pm.any()      # detections, not all padding
    np.testing.assert_array_equal(got_pv.numpy(), want_pv)
    np.testing.assert_array_equal(got_pm.numpy(), want_pm)
