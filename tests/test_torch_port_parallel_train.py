"""The port's data-parallel DMM train step (parallel/mesh.py, two gloo
ranks spawned on the CPU) against the JAX package's step on the whole
batch, single-device and on the 8-fake-device mesh of tests/conftest.py
(a data axis of 2, the port's world), with tests/test_parallel.py's
tolerances: loss rtol 1e-4, parameters rtol 1e-3 and atol 1e-5. Then
train_torch.py --data-parallel 2 inside spawned ranks: one checkpoint
written by rank 0, resumed on both.

Two configurations, on tests/test_torch_port_train_step.py's tiny model
(R-18 float32 at 64x64, M=4, N=8, B=2 clips of T=3, the JAX ResNet on its
plain stem):
  frozen: the unfused matcher and frozen BN, on a batch whose halves hold
    2 and 1 valid objects (the losses' masked means then differ between a
    per-rank mean and the global one);
  train_bn: the fused matcher (B1's plain version, B1' backward), remat
    and train-mode BN on a gated YouTube-VOS batch, against JAX's step with
    its backbone in float64 (tests/test_torch_port_train_fused.py says why);
    its batch holds 2 valid objects in each half.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import dmm_net_tpu.models.dmm as jax_dmm
from dmm_net_tpu.data.synthetic import synthetic_clip_batch
from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
from dmm_net_tpu.models.dmm import init_frame_state as jax_init_state
from dmm_net_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dmm_net_tpu.parallel.mesh import shard_batch as jax_shard_batch
from dmm_net_tpu.train.loop import TrainState as JaxTrainState
from dmm_net_tpu.train.loop import make_optimizer
from dmm_net_tpu.train.loop import make_train_step as jax_make_train_step
from dmm_net_tpu_torch.parallel import launch
from dmm_net_tpu_torch.weights import convert_flax_variables
from test_torch_port_engine import _randomize
from test_torch_port_train_step import (_stats, few_threads,  # noqa: F401
                                        jax_train_reference, tiny_config)

import chip_smoke as cs
import torch_port_ranks as ranks

LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5


def _unequal_batch():
    b = {k: np.asarray(v) for k, v in synthetic_clip_batch(
        seed=0, batch=2, T=3, H=64, W=64, num_objects=2, num_proposals=8,
        pad_objects=4).items()}
    b["tmpl_valid"][1, 1] = False        # clip 0: 2 valid objects, clip 1: 1
    return b


def _copy(tree):
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def frozen():
    """JAX's train step on the whole batch, single-device and on a data
    axis of 2 of the fake mesh, one step each from the same state; and the
    port's two ranks from the same variables."""
    cfg = tiny_config()
    batch = _unequal_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        plain_stem = jax_dmm.backbone_by_name
        mp.setattr(jax_dmm, "backbone_by_name",
                   lambda *a, **k: plain_stem(*a, **{**k, "s2d_stem": False}))
        model = JaxDMMNet(cfg, train=True)
        shapes = jax.eval_shape(
            model.init, jax.random.PRNGKey(0), jb["frames"][:, 0],
            jb["prop_masks"][:, 0], jb["prop_valid"][:, 0],
            jnp.zeros((2, 4, cfg.model.feature_dim)), jb["tmpl_valid"],
            jax_init_state(cfg, jb["tmpl_masks"]))
        variables = _randomize(shapes, 11)
        tx = make_optimizer(cfg)

        def state():
            params = _copy(variables["params"])
            return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=_copy(variables["batch_stats"]),
                                 opt_state=tx.init(params), tx=tx,
                                 apply_fn=model.apply)

        s_single, m_single = jax_make_train_step(cfg)(state(), jb)
        mesh = jax_make_mesh(data=2)
        s_mesh, m_mesh = jax_make_train_step(cfg, mesh=mesh)(
            state(), jax_shard_batch(batch, mesh))
    port = launch(ranks.dmm_steps, 2, "cpu", cfg.to_dict(), variables, batch, 1)
    return dict(batch=batch, port=port,
                single=(m_single, jax.device_get(s_single.params)),
                mesh=(m_mesh, jax.device_get(s_mesh.params)))


def _assert_params(got, want_tree):
    want = convert_flax_variables({"params": want_tree})
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("reference", ["single", "mesh"])
def test_two_rank_step_matches_jax_with_unequal_valid_counts(frozen, reference):
    """The halves' valid counts differ (2 and 1); the port's two ranks give
    JAX's loss and grad norm on the whole batch, and JAX's parameters after
    the update, on both ranks alike."""
    r0, r1 = frozen["port"]
    assert (r0["valid_count"], r1["valid_count"]) == (2, 1)
    metrics, params = frozen[reference]
    for r in (r0, r1):
        np.testing.assert_allclose(r["loss"][0], float(metrics["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"][0],
                                   float(metrics["grad_norm"]), rtol=LOSS_RTOL)
    assert all(np.array_equal(r0["params"][k], r1["params"][k])
               for k in r0["params"])
    _assert_params(r0["params"], params)


def test_reduction_and_global_normalisation_take_place(frozen):
    """Each rank's own gradient is O(1) away from the summed one, and the
    average of per-rank masked means misses JAX's whole-batch loss by more
    than the tolerance when the ranks' valid counts differ: the port
    computes neither."""
    r0, r1 = frozen["port"]
    assert min(r0["local_vs_reduced_rel"], r1["local_vs_reduced_rel"]) > 0.1
    want = float(frozen["single"][0]["loss"])
    assert abs(r0["per_rank_mean_loss"] - want) > LOSS_RTOL * abs(want)
    np.testing.assert_allclose(r0["loss"][0], want, rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def train_bn(tmp_path_factory):
    ref = jax_train_reference("b", tmp_path_factory, backbone_f64=True)
    port = launch(ranks.dmm_steps, 2, "cpu", ref["cfg"].to_dict(),
                  ref["variables"], {k: np.asarray(v) for k, v in
                                     ref["batch"].items()}, 2)
    return ref, port


def test_two_rank_train_bn_fused_remat_step_matches_jax(train_bn):
    """Global batch statistics through remat's recompute, B1' per rank:
    both steps' losses, every gradient leaf of the first (to 1e-4 of the
    leaf's largest entry, as tests/test_torch_port_train_step.py holds the
    single-process step) and the running statistics after it equal JAX's
    whole-batch step; both ranks hold the same parameters. The parameters
    after the updates are not held to JAX's here: a conv that feeds a
    train-mode BN has gradient directions that vanish analytically, whose
    entries sit at rounding level, and Adam's first updates move every
    entry by about the learning rate whatever its size, so those entries
    land up to ~1e-3 apart between any two summation orders (the
    single-process port against this JAX reference, or against two ranks,
    alike); the gradients before Adam are the comparison that holds."""
    ref, (r0, r1) = train_bn
    for r in (r0, r1):
        np.testing.assert_allclose(r["loss"], [ref["loss"], ref["loss2"]],
                                   rtol=LOSS_RTOL)
    want = convert_flax_variables({"params": ref["grads"]})
    assert set(want) == set(r0["grads"])
    for name, w in want.items():
        w = w.numpy()
        assert np.abs(r0["grads"][name] - w).max() <= \
            1e-4 * np.abs(w).max() + 1e-12, name
    for k, w in _stats(ref["bs"]).items():
        np.testing.assert_allclose(r0["bn_stats_1"][k], w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert all(np.array_equal(r0["params"][k], r1["params"][k])
               for k in r0["params"])


TINY = ["model.backbone=resnet18", "model.backbone_dtype=float32",
        "model.image_size=64,64", "model.feature_dim=32",
        "model.decoder_dim=16", "matching.max_templates=4",
        "matching.max_proposals=8", "data.batch_size=2", "data.clip_length=3",
        "train.warmup_steps=0", "train.checkpoint_every=2",
        "data.dataset=synthetic"]


def test_train_cli_data_parallel_checkpoints_once_and_resumes(tmp_path):
    """train_torch.py --data-parallel 2 on two spawned ranks: 2 steps (rank
    0 writes the one checkpoint and the metrics), then --resume to step 3
    on both ranks; every loss equals a single process's 3 steps on the
    whole batch, and both ranks hold the same model."""
    import train_torch

    def argv(logdir, steps, *extra):
        return ["--device", "cpu", "--steps", str(steps), "--logdir",
                str(logdir), "--set", *TINY, *extra]

    single = train_torch.main(argv(tmp_path / "single", 3))
    dp = tmp_path / "dp"
    runs = launch(ranks.cli_runs, 2, "cpu", str(cs.ROOT), "train_torch",
                  [argv(dp, 2) + ["--data-parallel", "2"],
                   argv(dp, 3) + ["--data-parallel", "2", "--resume"]])
    (first0, resumed0), (first1, resumed1) = runs
    assert sorted(p.name for p in (dp / "ckpt").iterdir()) == [
        "step_00000002.pt", "step_00000003.pt"]
    assert (dp / "metrics.jsonl").exists()
    assert resumed0["step"] == resumed1["step"] == 3
    assert resumed0["checksum"] == resumed1["checksum"]
    losses = [h["loss"] for h in first0["history"] + resumed0["history"]]
    np.testing.assert_allclose(losses, [h["loss"] for h in single["history"]],
                               rtol=LOSS_RTOL)
    assert first0["checkpoint"] == first1["checkpoint"]
