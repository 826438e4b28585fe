"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its correctness limits (``limits/<cell>.json``)
and the readers of its per-layer metrics (``metrics/<metric>.py``). Nothing
here names a cell, a configuration or a metric: adding one adds files.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    config: str
    traffic_name: str
    chips: int
    config_file: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    rehearse: bool = False
    readers: Dict[str, Callable] = field(default_factory=dict)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read(reading)`` of ``metrics/<name>.py`` (a file name may hold
    dots, so it is loaded by path)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, bench_dir: Path = BENCH_DIR, rehearse: bool = False) -> Cell:
    spec = _json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, name) and m["moves"] in reported]
    cell = Cell(name=name, config=w["config"], traffic_name=w["traffic"], chips=w["chips"],
                config_file=_json(bench_dir / "configs" / f"{w['config']}.json"),
                traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_json(bench_dir / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, rehearse=rehearse)
    cell.readers = {m["name"]: load_reader(m["name"], bench_dir) for m in per_layer}
    return cell


def config_dict(cell: Cell) -> dict:
    """The configuration as run (nested dict), with the rehearsal's
    overrides on the CPU."""
    import copy
    d = copy.deepcopy(cell.config_file["config"])
    over = cell.config_file.get("rehearsal", {}) if cell.rehearse else {}
    for path, value in over.items():
        node = d
        parts = path.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
    return d


def traffic_params(cell: Cell) -> dict:
    p = {k: v for k, v in cell.traffic.items() if k != "rehearsal"}
    if cell.rehearse:
        p.update(cell.traffic.get("rehearsal", {}))
    return p


def sizes(cfg: dict, p: dict, chips: int) -> dict:
    """The shapes the traffic is drawn at, from the configuration."""
    H, W = cfg["model"]["image_size"]
    stride = 4 if cfg["model"]["mask_res"] == "stride4" else 1
    return {"image_hw": (H, W), "mask_hw": (H // stride, W // stride),
            "M": cfg["matching"]["max_templates"], "N": cfg["matching"]["max_proposals"],
            "T": cfg["data"]["clip_length"],
            "global_clips": p.get("clips_per_rank", 0) * chips}
