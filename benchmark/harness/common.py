"""What every run shares: the look for the cards, the check that no JAX
module was loaded, the device block, the comparison lines, and the result
line."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from typing import Dict, List, Optional

# compared by whole top-level name: the port's package name begins with
# the JAX package's
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "dmm_net_tpu")


def loaded_forbidden(modules=None) -> List[str]:
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def require_cards(chips: int) -> None:
    """Exit non-zero, printing no result, unless CUDA has ``chips`` cards."""
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("benchmark: CUDA is not available; no result\n")
        raise SystemExit(3)
    if torch.cuda.device_count() < chips:
        sys.stderr.write(f"benchmark: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} are visible; no result\n")
        raise SystemExit(3)


def power_limit_w() -> Optional[float]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, timeout=30, check=True)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_block(rehearse: bool, chips: int, peak_bytes: int) -> dict:
    if rehearse:
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def check(name: str, value: float, limit: float) -> dict:
    """One compared number, ``value`` <= ``limit`` to pass (a NaN fails)."""
    return {"name": name, "value": float(value), "limit": float(limit),
            "ok": bool(value <= limit) and not math.isnan(value)}


def emit(result: dict, checks: List[dict]) -> None:
    """The comparison lines last on standard error, then the result line
    last on standard output, its ``checks`` key last."""
    for c in checks:
        sys.stderr.write(f"check {c['name']} = {c['value']!r} limit {c['limit']!r} "
                         f"{'ok' if c['ok'] else 'FAILED'}\n")
    result = dict(result)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def metric_block(values: Dict[str, float], metrics: List[dict], rehearse: bool) -> dict:
    """{name: {"value", "unit"}} for the metrics that read a number. A CPU
    rehearsal's numbers are named ``cpu.<name>``: they are no device
    metric."""
    units = {m["name"]: m["unit"] for m in metrics}
    out = {}
    for name, v in values.items():
        if v is None or name not in units:
            continue
        out[("cpu." if rehearse else "") + name] = {"value": float(v), "unit": units[name]}
    return out
