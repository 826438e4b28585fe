"""The full system's planted-proposal reference: chip_smoke.py phase 9e holds
examples/full_system_synthetic_torch.py's planted-proposal J&F on the card
to the JAX package's (JAX_FULL_SYSTEM_PLANTED_JF) on the same 4 held-out
videos and the git-tracked checkpoint, as saved and on the kernels
(CKPT_RUNS). Recompute those values here with the JAX package's engine, as
examples/full_system_synthetic.py runs it (one video at a time,
run_stream_chunked on compact planted proposals, chunks of 4), and the
port's on the CPU beside them."""

from pathlib import Path

import numpy as np
import pytest
import torch

from dmm_net_tpu.config import config_from_dict as jax_config_from_dict
from dmm_net_tpu.data.synthetic import synthetic_sequence as jax_sequence
from dmm_net_tpu.eval.davis_jf import evaluate_sequence as jax_evaluate
from dmm_net_tpu.infer.compact import compact_stream as jax_compact
from dmm_net_tpu.infer.engine import InferenceEngine as JaxEngine
from dmm_net_tpu_torch.data.synthetic import synthetic_sequence
from dmm_net_tpu_torch.eval.davis_jf import evaluate_sequence
from dmm_net_tpu_torch.infer.compact import compact_stream
from dmm_net_tpu_torch.infer.engine import InferenceEngine
from dmm_net_tpu_torch.utils.checkpoint import load_msgpack_ckpt

import chip_smoke as cs

_ROOT = Path(__file__).resolve().parent.parent


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


def planted_jf(engine, sequence, compact, evaluate, cfg, seeds, T=8, chunk=4):
    """Mean planted-proposal J&F over ``seeds``, as the full-system
    examples compute it (either package's modules)."""
    H, W = cfg.model.image_size
    M, N = cfg.matching.max_templates, cfg.matching.max_proposals

    def pad_m(x):
        return np.pad(x, [(0, M - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

    jfs = []
    for s in seeds:
        seq = sequence(seed=s, T=T, H=H, W=W, num_objects=2, num_proposals=N)
        res = engine.run_stream_chunked(
            iter(compact(seq["frames"], seq["prop_masks"], seq["prop_valid"])),
            pad_m(seq["tmpl_masks"])[None], pad_m(seq["tmpl_valid"])[None],
            seq["frames"][0][None], chunk=chunk)
        labels = res["labels"][:, 0]
        gt = np.zeros_like(labels)
        for i in range(seq["gt_masks"].shape[1]):
            gt[seq["gt_masks"][:, i] > 0.5] = i + 1
        jfs.append(evaluate(gt, labels)["J&F"])
    return float(np.mean(jfs))


@pytest.mark.parametrize("run", ["as_saved", "kernels"])
def test_full_system_planted_reference_values(run):
    port_cfg, variables = load_msgpack_ckpt(str(_ROOT / cs.CKPT))
    cfg = port_cfg.override(**cs.CKPT_RUNS[run])
    seeds = range(5000, 5004)
    want = planted_jf(JaxEngine(jax_config_from_dict(cfg.to_dict()),
                                variables=variables, update_templates=True),
                      jax_sequence, jax_compact, jax_evaluate, cfg, seeds)
    got = planted_jf(InferenceEngine(cfg, variables=variables, device="cpu"),
                     synthetic_sequence, compact_stream, evaluate_sequence, cfg,
                     seeds)
    assert abs(want - cs.JAX_FULL_SYSTEM_PLANTED_JF[run]) < 2e-3, want
    assert abs(got - want) < 0.01 and got > 0.85, (got, want)
