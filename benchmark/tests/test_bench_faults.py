"""A whole run on the CPU at the rehearsal sizes (the look for a card
skipped), sound and with the timed path broken underneath: the sound run
is correct, and each fault that a cell can have makes ``correct`` false
under the cell's own limits."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import calibrate  # noqa: E402
from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import spec  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
KIND = {w["name"]: spec.load_cell(w["name"]).kind for w in SPEC["workloads"]}
FAULTS = {"video_offline": ("none", "answer_altered", "half_batch", "state_unchanged"),
          "train_clips": ("none", "state_unchanged", "half_batch", "b1_backward_zeroed",
                          "b1_backward_doubled")}
CASES = [(c, f) for c, k in KIND.items() for f in FAULTS[k]]


def _plant(monkeypatch, kind, fault):
    if kind == "video_offline":
        from dmm_net_tpu_torch.infer import engine as eng
        if fault == "answer_altered":          # one video's labels, as produced
            orig = eng.resolve_labels

            def resolve(logits, valid, hw):
                lab = orig(logits, valid, hw)
                lab[0] = (lab[0] + 1) % (logits.shape[1] + 1)
                return lab
            monkeypatch.setattr(eng, "resolve_labels", resolve)
        elif fault == "half_batch":            # the second half never served
            orig = eng.InferenceEngine.run_stream_chunked

            def half(self, items, tm, tv, f0, chunk=8, **k):
                h = tv.shape[0] // 2
                out = orig(self, ({a: b[:h] for a, b in it.items()} for it in items),
                           tm[:h], tv[:h], f0[:h], chunk=chunk, **k)
                return {a: np.concatenate([b, np.zeros_like(b)], axis=1)
                        for a, b in out.items()}
            monkeypatch.setattr(eng.InferenceEngine, "run_stream_chunked", half)
        elif fault == "state_unchanged":       # templates and GRU state not carried
            orig = eng.InferenceEngine._finish_step

            def stuck(self, out, new_state, state, valid):
                labels, X, _ = orig(self, out, new_state, state, valid)
                return labels, X, state
            monkeypatch.setattr(eng.InferenceEngine, "_finish_step", stuck)
    else:
        from dmm_net_tpu_torch.train import loop
        if fault == "state_unchanged":         # the update applies nothing
            monkeypatch.setattr(loop.Optimizer, "update", lambda self, grads: None)
        elif fault == "half_batch":            # the loss over half the rows
            orig = loop.make_train_step

            def make(cfg, mesh=None):
                step = orig(cfg, mesh)

                def halved(state, batch):
                    h = batch["frames"].shape[0] // 2
                    return step(state, {k: v[:h] for k, v in batch.items()})
                return halved
            monkeypatch.setattr(loop, "make_train_step", make)
        elif fault.startswith("b1_backward"):  # B1' returns no gradient, or twice it
            from dmm_net_tpu_torch.kernels import matcher
            monkeypatch.setattr(matcher._PoolCostMatch, "backward",     # restored after it
                                matcher._PoolCostMatch.__dict__["backward"])
            calibrate.plant_b1_backward(0.0 if fault.endswith("zeroed") else 2.0)


@pytest.mark.parametrize("cell, fault", CASES)
def test_rehearsal_run_and_its_faults(cell, fault, monkeypatch, capsys):
    _plant(monkeypatch, KIND[cell], fault)
    bench_run.main(["--workload", cell, "--seed", str(2 ** 31 + 9), "--seconds", "0.5",
                    "--rehearse"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu"
    assert all(k.startswith("cpu.") for k in out["metrics"])
    assert list(out)[-1] == "checks"
    assert out["correct"] is (fault == "none"), out["checks"]
