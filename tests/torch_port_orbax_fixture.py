"""Writes artifacts/orbax_jax_fixture/: orbax checkpoint directories saved
by the JAX package's own Checkpointer (dmm_net_tpu/utils/checkpoint.py),
and digests.json beside them, for the port's orbax reader
(dmm_net_tpu_torch/utils/checkpoint.read_orbax_step) and chip_smoke.py's
phase 13, which reads them on a machine without JAX.

    python tests/torch_port_orbax_fixture.py [OUT_DIR]

(the committed fixture by default). Two runs, each a directory of one
TrainState-shaped payload {step, params, batch_stats, opt_state} saved
after every optimizer call with keep 2, so two step directories stay, the
last with an ``extra`` JSON item and the one before without, plus a copy
of the last step under an unfinished save's name
(``<step>.orbax-checkpoint-tmp-<n>``):

* ``accum1``: make_optimizer (dmm_net_tpu/train/loop.py) with
  train.grad_accum 1, after two real updates (steps 1 and 2 kept);
* ``accum2``: the same wrapped in optax.MultiSteps (grad_accum 2), after
  five calls, two updates and one accumulated gradient (steps 4 and 5).

The params are chip_smoke.orbax_fixture_module's in flax's layout;
batch_stats holds its BatchNorm's statistics and leaves that cover the
reader's cases: int32, int64 (a numpy leaf, as orbax keeps its dtype),
bfloat16, and a float32 array sharded over a 2x2 mesh of CPU devices,
which zarr stores as four chunks. Large leaves are stored by reference in
the OCDBT store, small ones inline. digests.json has each leaf's shape,
dtype and sha256 (computed from the JAX side's arrays), each step's extra,
and each run's next update as JAX computes it: one more optimizer call
with gradient orbax_fixture_tree(*gradient), summed absolute update and
moments per parameter under the port's names. OCDBT data file names are
random, so a rewrite changes the bytes on disk but not digests.json.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")

import numpy as np  # noqa: E402

import jax  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))

import chip_smoke as cs  # noqa: E402
from dmm_net_tpu.config import Config, TrainConfig  # noqa: E402
from dmm_net_tpu.train.loop import make_optimizer  # noqa: E402
from dmm_net_tpu.utils.checkpoint import Checkpointer  # noqa: E402
from dmm_net_tpu_torch.weights import convert_flax_variables  # noqa: E402

FIXTURE = cs.ORBAX_FIXTURE
TRAIN = dict(lr=1e-3, warmup_steps=1, total_steps=8, weight_decay=1e-2)
RUNS = {"accum1": 1, "accum2": 2}
INIT = (0, 0.1)                       # orbax_fixture_tree(seed, scale)
GRAD_SCALE = 1.0                      # global norms ~70: the clip scales them
NEXT_GRADIENT = (200, 0.005)          # global norm ~0.4: under the clip
TMP_NAME = "{}.orbax-checkpoint-tmp-1792300000"


class _State:
    """What Checkpointer.save reads of a flax TrainState."""

    def __init__(self, step, params, batch_stats, opt_state):
        self.step, self.params = step, params
        self.batch_stats, self.opt_state = batch_stats, opt_state


def _batch_stats():
    rng = np.random.RandomState(1)
    devices = np.array(jax.devices()[:4]).reshape(2, 2)
    sharded = jax.device_put(
        jnp.asarray(rng.randn(8, 12).astype(np.float32)),
        NamedSharding(Mesh(devices, ("a", "b")), PartitionSpec("a", "b")))
    return {"BatchNorm_0": {"mean": jnp.asarray(rng.randn(32).astype(np.float32) * 0.1),
                            "var": jnp.asarray(rng.uniform(0.5, 1.5, 32).astype(np.float32))},
            "coverage": {"counts": jnp.asarray(rng.randint(-9, 9, (5,)), jnp.int32),
                         "ids": np.arange(3, 9, dtype=np.int64) * (1 << 40),
                         "ema": jnp.asarray(rng.randn(4, 7), jnp.bfloat16),
                         "sharded": sharded}}


def leaf_digests(payload) -> dict:
    """{path: [shape, dtype, sha256]} of a payload's array leaves, from the
    arrays JAX holds (paths as chip_smoke.orbax_leaf_digests joins them)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(payload):
        arr = np.asarray(leaf)
        keys = "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                        for k in path)
        out[keys] = [list(arr.shape), arr.dtype.name,
                     hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()]
    return out


def _port_l1(tree) -> dict:
    """Summed absolute values of a params-shaped tree, under the port's
    parameter names."""
    return {k: float(v.double().abs().sum()) for k, v in
            convert_flax_variables({"params": jax.tree.map(np.asarray, tree)}).items()}


def _adam(opt_state, grad_accum):
    inner = opt_state.inner_opt_state if grad_accum > 1 else opt_state
    return inner[1][0]


def write_run(directory: Path, grad_accum: int) -> dict:
    """One run's checkpoint directory; its digests.json entry."""
    cfg = Config(train=TrainConfig(**TRAIN, grad_accum=grad_accum))
    tx = make_optimizer(cfg)
    params = jax.tree.map(jnp.asarray, cs.orbax_fixture_tree(*INIT))
    opt_state = tx.init(params)
    batch_stats = _batch_stats()
    calls = 2 * grad_accum + (grad_accum > 1)     # two updates (+ one mini step)
    ckpt = Checkpointer(str(directory), keep=2, async_save=False)
    steps = {}
    for step in range(1, calls + 1):
        grads = jax.tree.map(jnp.asarray, cs.orbax_fixture_tree(100 + step, GRAD_SCALE))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        state = _State(jnp.asarray(step, jnp.int32), params, batch_stats, opt_state)
        extra = {"run": directory.name, "step": step} if step == calls else None
        ckpt.save(state, extra=extra)
        ckpt.wait()
        steps[str(step)] = {"extra": extra, "leaves": leaf_digests({
            "step": state.step, "params": params, "batch_stats": batch_stats,
            "opt_state": opt_state})}
    ckpt.close()
    shutil.copytree(directory / str(calls), directory / TMP_NAME.format(calls + 1))
    kept = {s: steps[s] for s in sorted(steps, key=int)[-2:]}

    grads = jax.tree.map(jnp.asarray, cs.orbax_fixture_tree(*NEXT_GRADIENT))
    updates, after = tx.update(grads, opt_state, params)
    moved = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                         optax.apply_updates(params, updates), params)
    adam = _adam(after, grad_accum)
    return {"train": {**TRAIN, "grad_accum": grad_accum}, "steps": kept,
            "next": {"gradient": list(NEXT_GRADIENT), "count": int(adam.count),
                     "update_l1": _port_l1(moved), "mu_l1": _port_l1(adam.mu),
                     "nu_l1": _port_l1(adam.nu)}}


def write_fixture(out: Path = FIXTURE) -> dict:
    """Write the fixture's runs and digests.json under ``out`` (replacing
    the runs' directories); returns the digests."""
    out.mkdir(parents=True, exist_ok=True)
    runs = {}
    for run, grad_accum in RUNS.items():
        if (out / run).exists():
            shutil.rmtree(out / run)
        runs[run] = write_run(out / run, grad_accum)
    digests = {"written_by": "tests/torch_port_orbax_fixture.py", "runs": runs}
    (out / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True)
                                      + "\n")
    return digests


if __name__ == "__main__":
    write_fixture(Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURE)
