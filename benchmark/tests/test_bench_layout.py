"""The benchmark's files: every cell's pieces are found by name, the
specification keeps to its contract, and a new configuration, traffic mix
or per-layer metric needs only new files."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)


def test_command_names_only_the_benchmark():
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert (ROOT / SPEC["command"][1]).is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config_file["name"] == c.config
    assert c.kind in ("video_offline", "train_clips")
    assert set(c.limits) >= ({"label_mismatch_pct", "assignment_mean_gap", "decisive_margin"}
                             if c.kind == "video_offline"
                             else {"loss_gap", "grad_norm_gap", "change_gap", "matcher_grad_gap",
                                   "matcher_leaves"})
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.readers) == {m["name"] for m in c.per_layer}


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_preset_as_run(name):
    from dmm_net_tpu_torch.config import config_from_dict, preset
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    f = json.loads((ROOT / entry["file"]).read_text())
    assert f["source"] and len(f["source"]) <= 200
    want = preset(f["preset"]).override(**f["overrides"]).to_dict()
    assert f["config"] == want
    assert config_from_dict(f["config"]).to_dict() == want
    assert sorted(entry["reduced"]) == sorted(f["reduced"])
    assert set(f["reduced"]) <= set(f["overrides"]) <= set(f["assumed"])


def test_new_files_are_found_by_name(tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric,
    added as files to a copy, are found by their names."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    s = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "p3_480p.json").read_text())
    cfg["name"] = "p3_tmp"
    (bench / "configs" / "p3_tmp.json").write_text(json.dumps(cfg))
    tr = json.loads((BENCH / "traffic" / "davis_b16.json").read_text())
    tr["lengths"] = [30]
    (bench / "traffic" / "tmp_mix.json").write_text(json.dumps(tr))
    (bench / "limits" / "p3_tmp.tmp_mix.json").write_text(
        (BENCH / "limits" / "p3_480p.davis_b16.json").read_text())
    (bench / "metrics" / "tmp_metric.infer.py").write_text(
        "def read(r):\n    return 42.0\n")
    s["configs"].append({"name": "p3_tmp", "source": "x", "file": "benchmark/configs/p3_tmp.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "p3_tmp.tmp_mix", "config": "p3_tmp", "traffic": "tmp_mix",
                           "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "tmp_metric.infer", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "frames_per_s", "workloads": ["p3_tmp.tmp_mix"]})
    for m in s["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("p3_tmp.tmp_mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    c = spec.load_cell("p3_tmp.tmp_mix", bench_dir=bench)
    assert c.config_file["name"] == "p3_tmp" and c.traffic["lengths"] == [30]
    assert c.readers["tmp_metric.infer"](None) == 42.0
    assert "tmp_metric.infer" not in spec.load_cell("p3_480p.davis_b16", bench_dir=bench).readers
