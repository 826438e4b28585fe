"""The port's data-parallel detector train step (two gloo ranks spawned on
the CPU, one image each) against the JAX package's whole-batch gradient,
and train_proposal_torch.py --data-parallel inside spawned ranks: rank 0
writes the one --save file, and both ranks start again from it (--init).

The detector, its variables and its batch-2 batch are
tests/test_torch_port_detector_train.py's (R-18, 64x128, 8 classes; that
file says why the RPN's delta kernel is zero and the mask head's biases
positive). The gradient is held as tests/test_proposal_parallel.py holds
JAX's sharded one against its single-device one: the relative L2 of the
whole gradient below 1e-5 (a lost all-reduce or a wrong normalisation
misses by O(1)), and each leaf as that file's single-process test holds
the port, to 1e-4 of the leaf's largest entry."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dmm_net_tpu_torch.parallel import launch
from dmm_net_tpu_torch.weights import convert_flax_variables
from test_torch_port_detector_cli import _SMALL as _CLI_SMALL
from test_torch_port_detector_train import _SMALL, _two_threads  # noqa: F401
from test_torch_port_detector_train import small  # noqa: F401

import chip_smoke as cs
import torch_port_ranks as ranks


@pytest.fixture(scope="module")
def two_ranks(small):  # noqa: F811
    _, variables, _, batch, value_and_grad, _ = small
    (loss, parts), grads = value_and_grad(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    want = {"loss": float(loss), **{k: float(v) for k, v in parts.items()},
            "grads": convert_flax_variables(
                {"params": jax.device_get(grads)})}
    return want, launch(ranks.detector_grads, 2, "cpu", _SMALL, variables,
                        batch)


def test_two_rank_detector_step_matches_jax_whole_batch_gradient(two_ranks):
    want, (r0, r1) = two_ranks
    for r in (r0, r1):
        for k, v in r["metrics"].items():
            if k != "grad_norm":
                np.testing.assert_allclose(v, want[k], rtol=1e-4, err_msg=k)
    g = want["grads"]
    assert set(g) == set(r0["grads"])
    sq = sum(float((w.double() ** 2).sum()) for w in g.values())
    dsq = sum(float(((r0["grads"][k] - g[k].numpy()).astype(np.float64) ** 2)
                    .sum()) for k in g)
    assert np.sqrt(dsq / sq) < 1e-5, np.sqrt(dsq / sq)
    for k, w in g.items():
        w = w.numpy()
        assert np.abs(r0["grads"][k] - w).max() <= 1e-4 * np.abs(w).max(), k
        assert np.array_equal(r0["grads"][k], r1["grads"][k]), k


def test_train_proposal_cli_data_parallel_saves_once_and_restarts(tmp_path):
    """--data-parallel --batch 2 on two ranks, 2 steps and --save, then 1
    step from that file (--init) on both: the losses equal one process's
    same two runs, and both ranks hold the same model."""
    import train_proposal_torch

    save = tmp_path / "dp" / "mrcnn.msgpack"

    def argv(out, *extra):
        return [*_CLI_SMALL, "--batch", "2", "--logdir", str(out / "log"),
                *extra]

    runs = [argv(tmp_path / "dp", "--steps", "2", "--save", str(save)),
            argv(tmp_path / "dp", "--steps", "1", "--init", str(save))]
    ranks_out = launch(ranks.cli_runs, 2, "cpu", str(cs.ROOT),
                       "train_proposal_torch",
                       [r + ["--data-parallel"] for r in runs])
    single_save = tmp_path / "single" / "mrcnn.msgpack"
    single = [train_proposal_torch.main(argv(tmp_path / "single", "--steps",
                                             "2", "--save", str(single_save))),
              train_proposal_torch.main(argv(tmp_path / "single", "--steps",
                                             "1", "--init", str(single_save)))]
    (a0, b0), (a1, b1) = ranks_out
    assert save.exists() and (tmp_path / "dp" / "log" / "metrics.jsonl").exists()
    for got, want in ((a0, single[0]), (b0, single[1]), (a1, single[0])):
        np.testing.assert_allclose([h["total"] for h in got["history"]],
                                   [h["total"] for h in want["history"]],
                                   rtol=1e-4)
    assert a0["checksum"] == a1["checksum"] and b0["checksum"] == b1["checksum"]
    np.testing.assert_allclose(b0["checksum"], float(sum(
        t.double().sum() for t in single[1]["model"].state_dict().values())),
        rtol=1e-5)
