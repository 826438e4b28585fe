"""The port's streaming slice (dmm_net_tpu_torch.infer.engine) against the
JAX package's engine: the p3-shaped compact ``run_stream_chunked`` path at a
small size, plus the guards that keep the port free of JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmm_net_tpu.config import preset
from dmm_net_tpu.infer.engine import InferenceEngine as JaxEngine
from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
from dmm_net_tpu.models.dmm import init_frame_state as jax_init_state
from dmm_net_tpu_torch.config import config_from_dict
from dmm_net_tpu_torch.infer.engine import InferenceEngine, bucket_objects

_ROOT = Path(__file__).resolve().parent.parent
_PKG = _ROOT / "dmm_net_tpu_torch"


def _randomize(variables, seed):
    """Seeded random values for every leaf of a flax tree; only the leaves'
    shapes are read, so ``variables`` may come from ``jax.eval_shape``."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _slice_cfg(dtype):
    """p3_multi_object's path (fused matcher, stride-4 masks, mask-grid
    logits, shipped decoder knobs) cut to R-18 at 64x96, M=4, N=8."""
    return preset("p3_multi_object").override(**{
        "model.backbone": "resnet18", "model.image_size": (64, 96),
        "model.backbone_dtype": dtype, "model.decoder_dtype": dtype,
        "model.mask_dtype": dtype, "model.feature_dim": 16,
        "model.decoder_dim": 16, "model.decoder_obj_dim": 8,
        "model.decoder_obj_dim_fine": 4, "model.decoder_detail_dim": 4,
        "matching.max_templates": 4, "matching.max_proposals": 8})


def _stream(seed, T=4, B=2, N=8, M=4, H=64, W=96):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (T, B, H, W, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:H, :W]
    tmpl = np.zeros((B, M, H, W), np.float32)
    for b in range(B):
        for m in range(3):
            cy, cx = rng.randint(10, H - 10), rng.randint(10, W - 10)
            tmpl[b, m] = ((yy - cy) ** 2 + (xx - cx) ** 2) < rng.randint(60, 300)
    valid = np.zeros((B, M), bool)
    valid[:, :3] = True
    items = []
    for t in range(T):
        xy = rng.rand(B, N, 2) * np.array([W - 20, H - 20])
        wh = 8 + rng.rand(B, N, 2) * np.array([W, H]) * 0.4
        items.append({"frame": frames[t],
                      "prop_boxes": np.concatenate([xy, xy + wh], -1)
                      .astype(np.float32),
                      "prop_masks28": (rng.rand(B, N, 28, 28) > 0.4)
                      .astype(np.float32),
                      "prop_valid": rng.rand(B, N) > 0.2})
    return frames, tmpl, valid, items


def _jax_variables(cfg, frames, tmpl, valid, items):
    model = JaxDMMNet(cfg)
    B, M = valid.shape
    N = items[0]["prop_valid"].shape[1]
    state0 = jax_init_state(cfg, jnp.asarray(tmpl))
    variables = jax.eval_shape(   # shapes only: _randomize fills every leaf
        model.init, jax.random.PRNGKey(0), jnp.asarray(frames[0]),
        jnp.zeros((B, N) + tmpl.shape[2:]), jnp.asarray(items[0]["prop_valid"]),
        jnp.zeros((B, M, cfg.model.feature_dim)), jnp.asarray(valid), state0)
    return model, _randomize(variables, 1)


@pytest.mark.parametrize("dtype,max_mismatch,x_atol", [
    # f32: the two packages differ only by float summation order
    ("float32", 1e-3, 2e-3),
    # bf16: the resizes round once here (f32 compute, cast back) and twice in
    # JAX (one bf16 contraction per axis); the logits then differ by ~0.01
    # while these random weights give logits below 1 in magnitude, so ~2% of
    # pixels sit close enough to a tie to flip
    ("bfloat16", 5e-2, 5e-2),
])
def test_stream_chunked_compact_matches_jax(dtype, max_mismatch, x_atol):
    cfg = _slice_cfg(dtype)
    frames, tmpl, valid, items = _stream(0)
    model, variables = _jax_variables(cfg, frames, tmpl, valid, items)
    want = JaxEngine(cfg, model=model, variables=variables).run_stream_chunked(
        iter(items), tmpl, valid, frames[0], chunk=2)

    port = InferenceEngine(config_from_dict(cfg.to_dict()),
                           variables=variables, device="cpu")
    got = port.run_stream_chunked(iter(items), tmpl, valid, frames[0], chunk=2)
    assert got["labels"].shape == want["labels"].shape == (4, 2, 64, 96)
    assert got["labels"].dtype == np.uint8
    assert len(np.unique(want["labels"])) > 1          # not a trivial map
    mismatch = (got["labels"] != want["labels"]).mean()
    assert mismatch < max_mismatch, mismatch
    np.testing.assert_allclose(got["assignments"], want["assignments"],
                               atol=x_atol)
    rows = got["assignments"].sum(-1)[:, valid]
    np.testing.assert_allclose(rows, 1.0, atol=1e-3)


def test_stream_live_from_gating_and_bucketing():
    """Mid-video objects: a slot before its first frame never labels a pixel
    and keeps its template; bucketing pads assignments back to M_max."""
    cfg = _slice_cfg("float32").override(**{"matching.max_templates": 8})
    frames, tmpl, valid, items = _stream(1)
    tmpl = np.pad(tmpl, ((0, 0), (0, 4), (0, 0), (0, 0)))
    valid = np.pad(valid, ((0, 0), (0, 4)))
    live_from = np.zeros(valid.shape, np.int64)
    live_from[:, 2] = 3                       # object 3 appears at frame 3
    port = InferenceEngine(config_from_dict(cfg.to_dict()), device="cpu")
    out = port.run_stream_chunked(iter(items), tmpl, valid, frames[0],
                                  chunk=2, live_from=live_from,
                                  tmpl_frames=np.stack([frames[0]] * 8, 1))
    assert out["assignments"].shape == (4, 2, 8, 8)
    assert not (out["labels"][:3] == 3).any()
    assert (out["assignments"][:3, :, 2] == 0).all()
    assert (out["assignments"][:, :, 4:] == 0).all()
    assert bucket_objects(3, 8) == 4 and bucket_objects(0, 16) == 1


def test_engine_defaults_to_cuda():
    cfg = config_from_dict(_slice_cfg("float32").to_dict())
    if torch.cuda.is_available():
        assert InferenceEngine(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceEngine(cfg)


def test_engine_rejects_unported_paths(tmp_path):
    """What the engine and the CLI refuse: a mesh that is not a
    parallel.mesh.Mesh, --per-frame with --data-parallel (as infer.py
    does), and a checkpoint directory that holds neither the port's
    checkpoints nor orbax steps (tests/test_torch_port_orbax.py has the
    orbax directories the port reads)."""
    from dmm_net_tpu_torch.utils.checkpoint import load_checkpoint
    cfg = config_from_dict(_slice_cfg("float32").to_dict())
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        InferenceEngine(cfg, mesh=object(), device="cpu")
    r = subprocess.run([sys.executable, str(_ROOT / "infer_torch.py"),
                        "--data-parallel", "--per-frame", "--device", "cpu"],
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "exclusive" in r.stderr, r.stderr[-2000:]
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="holds neither"):
        load_checkpoint(str(tmp_path / "empty"))


def test_port_imports_no_jax():
    code = ("import sys, pkgutil, importlib, dmm_net_tpu_torch\n"
            "for m in pkgutil.walk_packages(dmm_net_tpu_torch.__path__, "
            "'dmm_net_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import infer_torch, train_torch, train_proposal_torch\n"
            "import bench_torch, graft_entry_torch\n"
            "import importlib.util as u\n"
            "for f in ('tools/extract_proposals_torch.py',\n"
            "          'tools/import_torch_weights_torch.py',\n"
            "          'tools/import_maskrcnn_weights_torch.py',\n"
            "          'examples/train_and_eval_synthetic_torch.py',\n"
            "          'examples/full_system_synthetic_torch.py',\n"
            "          'examples/train_synthetic_torch.py',\n"
            "          'examples/infer_demo_torch.py',\n"
            "          'examples/matcher_only_torch.py',\n"
            "          'tools/ab_logits_res_torch.py',\n"
            "          'tools/ab_480p_torch.py',\n"
            "          'tools/ab_decoder_arch_torch.py',\n"
            "          'tools/dayone_seeds_torch.py',\n"
            "          'tools/compare_caches_torch.py',\n"
            "          *sorted(str(p) for p in __import__('pathlib').Path('bench')"
            ".glob('*_torch.py'))):\n"
            "    s = u.spec_from_file_location('x', f)\n"
            "    s.loader.exec_module(u.module_from_spec(s))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tensorstore', "
            "'zstandard', 'cv2', 'dmm_net_tpu')]\n"
            "assert not bad, bad\n"
            "from dmm_net_tpu_torch.data import native_loader\n"
            "from dmm_net_tpu_torch.ops import rle\n"
            "native_loader.available(), rle.available()\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert '/native/loader/' not in maps and '/native/rle/' not in maps\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(_ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_port_sources_never_name_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|cv2)\b"
                         r"|\bdmm_net_tpu\.|from\s+dmm_net_tpu\s+import",
                         re.MULTILINE)
    files = sorted(_PKG.rglob("*.py")) + [
        _ROOT / "chip_smoke.py", _ROOT / "infer_torch.py",
        _ROOT / "train_torch.py", _ROOT / "train_proposal_torch.py",
        _ROOT / "bench_torch.py", _ROOT / "graft_entry_torch.py",
        *sorted((_ROOT / "bench").glob("*_torch.py")),
        *sorted((_ROOT / "examples").glob("*_torch.py")),
        *sorted((_ROOT / "tools").glob("*_torch.py")),
        _ROOT / "tests" / "torch_port_ranks.py"]
    assert len(files) >= 40
    for f in files:
        hit = pattern.search(f.read_text())
        assert hit is None, f"{f.relative_to(_ROOT)}: {hit.group(0)!r}"
