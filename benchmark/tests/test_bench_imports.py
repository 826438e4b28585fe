"""No module that the harness or the reference loads is JAX or the JAX
package (compared by whole top-level name: the port's name begins with the
JAX package's), and the reference loads nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark.harness.common import FORBIDDEN_MODULES, loaded_forbidden  # noqa: E402

_WALK = """
import json, pkgutil, importlib, sys
sys.path.insert(0, {root!r})
import benchmark.harness, benchmark.reference
for pkg in (benchmark.harness, benchmark.reference):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(pkg.__name__ + "." + m.name)
{extra}
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""


def _tops(extra="", only_reference=False):
    code = _WALK.format(root=str(ROOT), extra=extra)
    if only_reference:
        code = code.replace("import benchmark.harness, benchmark.reference",
                            "import benchmark.reference").replace(
            "(benchmark.harness, benchmark.reference)", "(benchmark.reference,)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT), check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_whole_name_comparison():
    assert loaded_forbidden({"dmm_net_tpu_torch.models": 1, "jaxtyping": 1}) == []
    assert loaded_forbidden({"dmm_net_tpu.config": 1, "flax.linen": 1}) == ["dmm_net_tpu", "flax"]


def test_harness_and_a_run_load_no_jax():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w["name"] for w in spec["workloads"] if w["traffic"].startswith("davis"))
    run = (f"from benchmark import run\n"
           f"run.main(['--workload', {cell!r}, '--seed', '3', '--seconds', '0.5', "
           f"'--rehearse'])\n"
           "from benchmark.harness import spec as s\n"
           "[s.load_reader(m['name']) for m in json.load(open('BENCHMARK.json'))['per_layer']]")
    tops = _tops(run)
    assert "dmm_net_tpu_torch" in tops
    assert not tops & set(FORBIDDEN_MODULES)


def test_reference_loads_nothing_of_the_program():
    tops = _tops(only_reference=True)
    assert not tops & (set(FORBIDDEN_MODULES) | {"dmm_net_tpu_torch"})


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_only_torch_numpy_and_itself(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            top = n.split(".")[0]
            assert top in ("torch", "numpy", "math", "typing", "__future__") or \
                n.startswith("benchmark.reference"), f"{path.name} imports {n}"
