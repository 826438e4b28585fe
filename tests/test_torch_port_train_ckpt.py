"""chip_smoke.py phase 7c holds the card's train steps from the git-tracked
checkpoint to the JAX package's (``JAX_TRAIN_STEPS``): recompute those
constants here with the JAX train step on the CPU, and hold the port's
same steps on the CPU to them."""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chip_smoke as cs
from dmm_net_tpu.config import config_from_dict as jax_config_from_dict
from dmm_net_tpu.data.synthetic import synthetic_clip_batch
from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
from dmm_net_tpu.train.loop import TrainState, make_optimizer, make_train_step
from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt
from test_torch_port_train_step import few_threads  # noqa: F401

_ROOT = Path(__file__).resolve().parent.parent


def _jax_train_steps(cfg, variables):
    jcfg = jax_config_from_dict(cfg.to_dict())
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    bs = jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {}))
    tx = make_optimizer(jcfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=bs, opt_state=tx.init(params), tx=tx,
                       apply_fn=JaxDMMNet(jcfg).apply)
    step = make_train_step(jcfg)
    H, W = jcfg.model.image_size
    out = {"loss": [], "grad_norm": []}
    for seed in cs.TRAIN_CKPT["seeds"]:
        batch = synthetic_clip_batch(
            seed=seed, batch=cs.TRAIN_CKPT["batch"], T=cs.TRAIN_CKPT["T"],
            H=H, W=W, num_objects=2,
            num_proposals=jcfg.matching.max_proposals,
            pad_objects=jcfg.matching.max_templates)
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        for k in out:
            out[k].append(float(m[k]))
    return out


@pytest.mark.parametrize("run", ["as_saved", "kernels"])
def test_train_reference_values(run):
    cfg0, variables = load_msgpack_ckpt(str(_ROOT / cs.CKPT))
    cfg = cfg0.override(**cs.TRAIN_CKPT_RUNS[run])
    want = _jax_train_steps(cfg, variables)
    print(run, want)
    got = cs.ckpt_train_steps(cfg, variables, "cpu")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(cs.JAX_TRAIN_STEPS[run][k], want[k],
                                   rtol=1e-6, err_msg=f"{run} {k}: stale")
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   err_msg=f"{run} {k}: port on the CPU")
    assert want["loss"][0] != want["loss"][1]       # the steps moved
