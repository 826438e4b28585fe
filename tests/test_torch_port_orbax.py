"""The port's reader of the JAX package's orbax checkpoints against orbax,
tensorstore and libzstd, and the two CLIs that take them against the JAX
package's: infer_torch.py --ckpt <orbax dir> against infer.py, and
train_torch.py --resume from a train.py run against train.py --resume.

The JAX CLIs run in this process (jit compiles dominate: two train steps
compile once per grad_accum, ~35 s each cold). infer.py restores params
alone through a StandardRestore whose target names only "params"; the
orbax these tests run with (0.11.32) refuses such a target (its
StandardRestore has no partial restore), so the infer.py comparison hands
infer.py's Checkpointer a manager that restores the whole item and
returns what the target names (``_params_only_restore``): what infer.py
asks of orbax.
"""

import functools
import json
import os
import shutil
import struct
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax
import orbax.checkpoint as ocp
import tensorstore as ts
import zstandard

import chip_smoke as cs
import infer_torch
import train_torch
import dmm_net_tpu.train.loop as jax_loop
import dmm_net_tpu.utils.checkpoint as jax_checkpoint
from dmm_net_tpu.config import preset as jax_preset
from dmm_net_tpu.data import native_loader as jax_native_loader
from dmm_net_tpu.data.synthetic import synthetic_clip_batch
from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
from dmm_net_tpu.models.dmm import init_frame_state as jax_init_state
from dmm_net_tpu_torch.config import Config, TrainConfig
from dmm_net_tpu_torch.train.loop import Optimizer
from dmm_net_tpu_torch.utils import ocdbt, zstd
from dmm_net_tpu_torch.weights import convert_flax_variables
from dmm_net_tpu_torch.utils.checkpoint import (checkpoint_kind,
                                                latest_orbax_step,
                                                load_checkpoint, orbax_steps,
                                                read_orbax_state,
                                                read_orbax_step)
from test_torch_port_engine import _randomize
from test_torch_port_train_step import few_threads  # noqa: F401
from torch_port_native import pin_port_to_pil
from torch_port_orbax_fixture import leaf_digests, write_fixture

# tests/test_cli.py's tiny geometry, as train.py runs it
TINY = ["model.backbone=resnet18", "model.backbone_dtype=float32",
        "model.feature_dim=16", "model.decoder_dim=8", "model.image_size=64,96",
        "matching.max_templates=4", "matching.max_proposals=8",
        "matching.sinkhorn_iters=5", "data.dataset=synthetic",
        "data.batch_size=1", "data.clip_length=2", "train.checkpoint_every=1000"]
# per grad_accum: train.py's steps before the resume (3 leaves MultiSteps
# half-way through an accumulation), and the steps it resumes for
JAX_RUNS = {1: 2, 2: 3}
RESUMED_STEPS = 2
STEP_REL = 1e-4
UPDATE_REL = 1e-2
# both trainers warm up in one step, so that the resumed updates are at the
# full learning rate and rest on the restored moments and counts
RESUME_SET = [*TINY, "train.warmup_steps=1"]


def _leaves(tree, path=()):
    """{path: leaf} of a nested dict / tuple / list tree."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], path + (str(k),)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: v for i, x in enumerate(tree)
                for p, v in _leaves(x, path + (str(i),)).items()}
    return {"/".join(path): tree}


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return cs._raw_bytes(x)
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_bit_equal(got, want):
    """Every leaf of orbax's restore (``want``, numpy or jax arrays) and the
    port's (``got``, CPU tensors) bit for bit, with the same dtype."""
    g = {k: v for k, v in _leaves(got).items() if v is not None}
    w = {k: v for k, v in _leaves(want).items() if v is not None}
    assert sorted(g) == sorted(w)
    for k in w:
        a = np.asarray(w[k])
        assert list(g[k].shape) == list(a.shape), k
        assert str(g[k].dtype).replace("torch.", "") == a.dtype.name, k
        assert _bits(g[k]) == _bits(a), k


def _orbax_restore(directory, step):
    """orbax's own restore of a step's state item (no target: the arrays
    as saved)."""
    mgr = ocp.CheckpointManager(str(directory))
    try:
        return mgr.restore(step, args=ocp.args.Composite(
            state=ocp.args.StandardRestore()))["state"]
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------

def _fixture_frames():
    """zstd frames tensorstore wrote: every zarr chunk of a fixture step."""
    return [v for k, v in _ts_items(cs.ORBAX_FIXTURE / "accum1" / "2" / "state").items()
            if not k.endswith(".zarray")]


def _frames(kind):
    rng = np.random.RandomState(3)
    data = (rng.randint(0, 4, 300_000).astype(np.uint8).tobytes()
            + os.urandom(70_000))
    if kind == "known size":
        return [(zstandard.ZstdCompressor(level=3).compress(data), data)]
    if kind == "unknown size":
        c = zstandard.ZstdCompressor(level=1, write_content_size=False)
        return [(c.compress(data), data)]
    if kind == "streamed":        # no size recorded, several blocks
        obj = zstandard.ZstdCompressor(level=1).compressobj()
        return [(obj.compress(data) + obj.flush(), data)]
    if kind == "two frames":
        c = zstandard.ZstdCompressor()
        return [(c.compress(data[:1000]) + c.compress(data[1000:]), data)]
    if kind == "empty":
        return [(zstandard.ZstdCompressor().compress(b""), b"")]
    frames = _fixture_frames()                  # tensorstore's zarr chunks
    return [(f, zstandard.ZstdDecompressor().decompressobj().decompress(f))
            for f in frames]


@pytest.mark.parametrize("kind", ["known size", "unknown size", "streamed",
                                  "two frames", "empty", "tensorstore"])
def test_zstd_matches_zstandard(kind):
    for frame, want in _frames(kind):
        assert zstd.decompress(frame) == want
        assert zstd.decompress(frame, size=len(want)) == want
        size = zstd.content_size(frame)          # the first frame's
        assert size == {"two frames": 1000, "known size": len(want),
                        "empty": 0}.get(kind)


def test_zstd_refusals(monkeypatch):
    data = os.urandom(5000)
    frame = zstandard.ZstdCompressor().compress(data)
    with pytest.raises(ValueError, match="too small"):
        zstd.decompress(frame, size=100)
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(frame[:-10])
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"\x00" * 64)
    with pytest.raises(ValueError, match="expected 6000"):
        zstd.decompress(frame, size=6000)
    zstd._lib.cache_clear()
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-not-here.so.1")
    try:
        with pytest.raises(RuntimeError, match="libzstd-not-here.so.1"):
            zstd.decompress(frame)
    finally:
        zstd._lib.cache_clear()


# ---------------------------------------------------------------------------
# OCDBT against tensorstore
# ---------------------------------------------------------------------------

STORES = {
    # small nodes: interior B-tree nodes of several heights; arity 2: the
    # manifest refers to version tree nodes, which the reader skips
    "interior nodes": dict(config={"max_decoded_node_bytes": 200,
                                   "max_inline_value_bytes": 8,
                                   "version_tree_arity_log2": 1}, n=60),
    "uncompressed": dict(config={"compression": None, "max_inline_value_bytes": 16,
                                 "max_decoded_node_bytes": 300}, n=30),
    "zstd level 9": dict(config={"compression": {"id": "zstd", "level": 9}}, n=12),
    "emptied": dict(config={}, n=5, clear=True),
}


def _ts_items(path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


def _ts_store(path, config, n, clear=False):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": config}).result()
    rng = np.random.RandomState(n)
    for i in range(n):
        key = f"{['a', 'arrays/x', 'arrays/y'][i % 3]}/{rng.randint(1000):03d}.{i}"
        kv.write(key, os.urandom(int(rng.randint(0, 40)))).result()
    if clear:
        kv.delete_range(ts.KvStore.KeyRange()).result()


@pytest.mark.parametrize("name", list(STORES))
def test_ocdbt_matches_tensorstore(tmp_path, name):
    """Every key's value at the newest generation as tensorstore reads it,
    and no value for keys it does not list."""
    path = str(tmp_path / "kv")
    _ts_store(path, **STORES[name])
    store = ocdbt.OcdbtStore(path)
    want = _ts_items(path)
    for k, v in want.items():
        assert store.read(k) == v, k
    for k in ("zz", "", "a", "arrays/", "arrays/x/"):
        assert store.read(k) is None, k
    assert store.version.num_keys == len(want)
    # generation 1 is the empty store, then one per write (and one for the
    # clear); an arity-2 version tree keeps at most two inline in the manifest
    assert store.version.generation == 1 + STORES[name]["n"] + STORES[name].get("clear", 0)
    if name == "interior nodes":
        assert store.version.root_height >= 2
        assert {type(node).__name__ for node in store._nodes.values()} == {
            "_Leaf", "_Interior"}


def _reframe(raw: bytes, body: bytes = None, version=None, method=None,
             magic=None) -> bytes:
    """An OCDBT frame with its parts replaced (the checksum recomputed)."""
    head = ocdbt._Cursor(raw[12:-4], "frame")
    v, m = head.varint(), head.varint()
    old = raw[12 + head.pos:-4]
    if body is not None:
        old, m = body, 0
    v = v if version is None else version
    m = m if method is None else method
    out = struct.pack(">I", magic or struct.unpack(">I", raw[:4])[0])
    rest = bytes([v, m]) + old
    out += struct.pack("<Q", len(out) + 8 + len(rest) + 4) + rest
    return out + struct.pack("<I", ocdbt.crc32c(out))


def test_ocdbt_refusals(tmp_path):
    path = tmp_path / "kv"
    _ts_store(str(path), {"max_inline_value_bytes": 4}, 6)
    manifest = (path / "manifest.ocdbt").read_bytes()
    body = ocdbt._unframe(manifest, ocdbt.MANIFEST_MAGIC, "m").data

    def refused(raw, match):
        (path / "manifest.ocdbt").write_bytes(raw)
        with pytest.raises(ValueError, match=match):
            ocdbt.OcdbtStore(str(path))

    refused(manifest[:-1] + bytes([manifest[-1] ^ 1]), "CRC-32C")
    refused(_reframe(manifest, magic=ocdbt.BTREE_MAGIC), "not an OCDBT manifest")
    refused(_reframe(manifest, version=1), "format version 1")
    refused(_reframe(manifest, body=body, method=2), "compression 2")
    refused(_reframe(manifest, body=body[:16] + b"\x01" + body[17:]),
            "manifest kind 1 \\(numbered\\)")
    refused(_reframe(manifest, body=body + b"\x00"), "1 bytes left over")
    (path / "manifest.ocdbt").write_bytes(manifest)
    store = ocdbt.OcdbtStore(str(path))
    root = store.version.root
    assert store.version.root_height == 0
    raw = (path / root.path).read_bytes()[root.offset:root.offset + root.length]
    leaf = ocdbt._unframe(raw, ocdbt.BTREE_MAGIC, "leaf")
    leaf.u8()
    ocdbt._data_files(leaf)
    n = leaf.varint()
    leaf.varints(n - 1)
    leaf.take(sum(leaf.varints(n)))            # the keys
    leaf.varints(n)                            # the value sizes
    at = leaf.pos                              # the first value's kind
    bad = _reframe(raw, body=leaf.data[:at] + b"\x02" + leaf.data[at + 1:])
    (path / "d" / "bad").write_bytes(bad)
    with pytest.raises(ValueError, match="value kind 2"):
        store._node(ocdbt.Location("d/bad", 0, len(bad)), 0)


# ---------------------------------------------------------------------------
# orbax directories against orbax's own restore
# ---------------------------------------------------------------------------

class _State:
    def __init__(self, step, params, batch_stats, opt_state):
        self.step, self.params = step, params
        self.batch_stats, self.opt_state = batch_stats, opt_state


def test_full_width_train_state_is_orbax_restore(tmp_path):
    """p3_multi_object's R-50 TrainState (params and Adam's moments filled
    from seeds, in make_optimizer's state) saved by the JAX package's
    Checkpointer:
    every leaf the port reads is orbax's restore, bit for bit, and serving's
    read of the params alone (load_checkpoint) gives the same params. Run
    with -s, it prints the host seconds of both reads."""
    cfg = jax_preset("p3_multi_object").override(**{"model.image_size": (64, 96)})
    b = {k: jnp.asarray(v) for k, v in synthetic_clip_batch(
        seed=0, batch=1, T=1, H=64, W=96, num_objects=2, num_proposals=128,
        pad_objects=16).items()}
    shapes = jax.eval_shape(
        JaxDMMNet(cfg, train=True).init, jax.random.PRNGKey(0),
        b["frames"][:, 0], b["prop_masks"][:, 0], b["prop_valid"][:, 0],
        jnp.zeros((1, 16, cfg.model.feature_dim)), b["tmpl_valid"],
        jax_init_state(cfg, b["tmpl_masks"]))
    variables = jax.tree.map(jnp.asarray, _randomize(shapes, 0))
    opt_state = jax_loop.make_optimizer(cfg).init(variables["params"])
    adam = opt_state[1][0]._replace(     # moments of a run's values, not zeros
        mu=jax.tree.map(jnp.asarray, _randomize(shapes["params"], 1)),
        nu=jax.tree.map(jnp.abs, _randomize(shapes["params"], 2)))
    opt_state = (opt_state[0], (adam, *opt_state[1][1:]))
    state = _State(jnp.asarray(7, jnp.int32), variables["params"],
                   variables["batch_stats"], opt_state)
    ckpt = jax_checkpoint.Checkpointer(str(tmp_path / "ckpt"), async_save=False)
    ckpt.save(state)
    ckpt.wait()
    ckpt.close()
    del state, variables, opt_state, adam
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    assert n_params > 25_000_000                      # ResNet-50's width
    assert latest_orbax_step(str(tmp_path / "ckpt")) == 7
    t0 = time.perf_counter()
    got = read_orbax_step(str(tmp_path / "ckpt"), 7)
    t1 = time.perf_counter()
    cfg_, served = load_checkpoint(str(tmp_path / "ckpt"))
    t2 = time.perf_counter()
    assert got["extra"] is None and cfg_ is None and set(served) == {"params"}
    whole = sum(t.numel() * t.element_size() for t in _leaves(got["state"]).values()
                if isinstance(t, torch.Tensor))
    params = sum(t.numel() * t.element_size() for t in _leaves(served).values())
    print(f"\nfull-width p3 TrainState: whole step {whole / 1e6:.1f} MB in "
          f"{t1 - t0:.3f} s ({whole / 1e6 / (t1 - t0):.1f} MB/s); params alone "
          f"(load_checkpoint) {params / 1e6:.1f} MB in {t2 - t1:.3f} s "
          f"({params / 1e6 / (t2 - t1):.1f} MB/s)")
    assert 3 * params <= whole < 4 * params      # params, and Adam's mu and nu
    _assert_bit_equal(served, {"params": got["state"]["params"]})
    _assert_bit_equal(got["state"], _orbax_restore(tmp_path / "ckpt", 7))


def test_reader_covers_orbax_leaf_kinds(tmp_path):
    """Scalars saved as Python numbers, empty dicts, tuples and optax's
    empty states, numpy leaves of their own dtype, and an array sharded
    over four CPU devices (four zarr chunks), as orbax restores them;
    leaves of dtypes the JAX trainer does not write (uint8, float16,
    float64, bool) are refused by name, and skipped by a read of the other
    top-level keys."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from dmm_net_tpu_torch.utils.checkpoint import read_zarr
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
    x = np.random.RandomState(0).randn(6, 10).astype(np.float32)
    params = {"sharded": jax.device_put(jnp.asarray(x), NamedSharding(
        mesh, PartitionSpec("a", "b"))), "count": 7,
        "i64": np.arange(5, dtype=np.int64), "bf16": jnp.full((2, 3), 1.5, jnp.bfloat16)}
    other = {"u8": np.arange(5, dtype=np.uint8), "f64": np.float64(1.5),
             "half": jnp.ones((2, 3), jnp.float16), "flag": np.array([True, False])}
    state = _State(jnp.asarray(3, jnp.int32), params, other,
                   (optax.EmptyState(), ()))
    ckpt = jax_checkpoint.Checkpointer(str(tmp_path / "c"), async_save=False)
    ckpt.save(state, extra={"note": [1, "two"]})
    ckpt.wait()
    ckpt.close()
    item = tmp_path / "c" / "3" / "state"
    store = ocdbt.OcdbtStore(str(item))
    assert [k for k in _ts_items(item) if k.startswith("params.sharded/")] == [
        "params.sharded/.zarray", "params.sharded/0.0", "params.sharded/0.1",
        "params.sharded/1.0", "params.sharded/1.1"]
    with pytest.raises(ValueError, match="is not read \\(only <f4, <i4, <i8, bfloat16\\)"):
        read_orbax_step(str(tmp_path / "c"), 3)
    for k in other:
        with pytest.raises(ValueError, match=f"zarr: batch_stats.{k}: dtype"):
            read_zarr(store, f"batch_stats.{k}")
    got = read_orbax_step(str(tmp_path / "c"), 3, keys=("step", "params", "opt_state"))
    assert got["extra"] == {"note": [1, "two"]}
    tree = got["state"]
    assert sorted(tree) == ["opt_state", "params", "step"]
    assert tree["opt_state"] == (None, ())
    assert tree["params"]["count"] == 7
    assert torch.equal(tree["params"]["sharded"], torch.from_numpy(x))
    want = _orbax_restore(tmp_path / "c", 3)
    for k in ("i64", "sharded"):
        _assert_bit_equal({k: tree["params"][k]}, {k: want["params"][k]})
    assert tree["params"]["bf16"].dtype == torch.bfloat16
    assert _bits(tree["params"]["bf16"]) == _bits(np.asarray(want["params"]["bf16"]))
    # a chunk the store does not hold: orbax refuses it
    # (fill_missing_data_reads false), and so does the port
    ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/c/3/state/"}
                    ).result().delete_range(ts.KvStore.KeyRange(
                        "params.sharded/1.0", "params.sharded/1.0\x00")).result()
    with pytest.raises(Exception, match="error while reading array"):
        _orbax_restore(tmp_path / "c", 3)
    with pytest.raises(ValueError, match="chunk params.sharded/1.0 is missing"):
        read_orbax_step(str(tmp_path / "c"), 3, keys=("params",))


@pytest.mark.parametrize("run", ["accum1", "accum2"])
def test_fixture_reads_as_committed(tmp_path, run):
    """The committed fixture: its finished steps (the unfinished save is
    not one, for orbax either), each leaf's digest, its extra, orbax's
    restore bit for bit, and the next update against JAX's."""
    want = json.loads((cs.ORBAX_FIXTURE / "digests.json").read_text())["runs"][run]
    copy = tmp_path / run
    shutil.copytree(cs.ORBAX_FIXTURE / run, copy)       # orbax may touch it
    steps = orbax_steps(str(copy))
    assert steps == sorted(int(s) for s in want["steps"])
    assert any(".orbax-checkpoint-tmp-" in p.name for p in copy.iterdir())
    manager = ocp.CheckpointManager(str(copy))
    assert manager.latest_step() == steps[-1]
    manager.close()
    for step in steps:
        got = read_orbax_step(str(copy), step)
        assert cs.orbax_leaf_digests(got["state"]) == want["steps"][str(step)]["leaves"]
        assert got["extra"] == want["steps"][str(step)]["extra"]
        _assert_bit_equal(got["state"], _orbax_restore(copy, step))
    tree = read_orbax_step(str(copy), steps[-1])["state"]
    dtypes = {str(v.dtype) for v in _leaves(tree).values() if v is not None}
    assert {"torch.float32", "torch.int32", "torch.int64", "torch.bfloat16"} <= dtypes
    got = cs.orbax_fixture_update(tree, want, "cpu")
    assert cs.orbax_update_error(got, want["next"]) < cs.ORBAX_UPDATE_REL


def test_fixture_helper_rewrites_the_committed_digests(tmp_path):
    """tests/torch_port_orbax_fixture.py writes, through the JAX package's
    Checkpointer, what is committed: the same digests.json (the OCDBT data
    files have random names, so the bytes on disk differ)."""
    got = write_fixture(tmp_path)
    assert got == json.loads((cs.ORBAX_FIXTURE / "digests.json").read_text())
    for run in got["runs"]:
        for step in orbax_steps(str(tmp_path / run)):
            tree = read_orbax_step(str(tmp_path / run), step)["state"]
            assert cs.orbax_leaf_digests(tree) == got["runs"][run]["steps"][str(step)]["leaves"]
    total = sum(f.stat().st_size for f in cs.ORBAX_FIXTURE.rglob("*") if f.is_file())
    assert total < 4 << 20


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_checkpoint_directories_are_refused(tmp_path):
    """A directory holding both kinds or neither (an unfinished save alone
    is neither); orbax items this reader does not decode; an optax state
    of another optimizer, at its first differing path."""
    fixture = tmp_path / "orbax"
    shutil.copytree(cs.ORBAX_FIXTURE / "accum1", fixture)
    assert checkpoint_kind(str(fixture)) == "orbax"
    assert checkpoint_kind(str(tmp_path / "nothing")) is None
    (fixture / "step_00000002.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="holds both"):
        load_checkpoint(str(fixture))
    with pytest.raises(SystemExit, match="holds both"):
        infer_torch.main(["--ckpt", str(fixture), "--device", "cpu"])
    logdir = tmp_path / "run"
    shutil.copytree(fixture, logdir / "ckpt")
    with pytest.raises(SystemExit, match="holds both"):
        train_torch.main(["--logdir", str(logdir), "--resume", "--device", "cpu"])
    unfinished = tmp_path / "unfinished"
    unfinished.mkdir()
    shutil.copytree(cs.ORBAX_FIXTURE / "accum1" / "2",
                    unfinished / "2.orbax-checkpoint-tmp-123")
    for d in (unfinished, tmp_path / "empty"):
        d.mkdir(exist_ok=True)
        with pytest.raises(ValueError, match="holds neither"):
            load_checkpoint(str(d))

    state = tmp_path / "zarr3" / "2" / "state"
    shutil.copytree(cs.ORBAX_FIXTURE / "accum1" / "2", state.parent)
    meta = json.loads((state / "_METADATA").read_text())
    (state / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(ValueError, match="use_zarr3 false"):
        read_orbax_state(str(state))
    (state / "_METADATA").write_text(json.dumps(
        {**meta, "tree_metadata": {**meta["tree_metadata"], "('x',)": {
            "key_metadata": [{"key": "x", "key_type": 2}],
            "value_metadata": {"value_type": "string"}}}}))
    with pytest.raises(ValueError, match="value type 'string'"):
        read_orbax_state(str(state))

    tree = read_orbax_step(str(cs.ORBAX_FIXTURE / "accum1"), 2)["state"]
    net = cs.orbax_fixture_module("cpu")
    train = {k: v for k, v in json.loads((cs.ORBAX_FIXTURE / "digests.json")
                                         .read_text())["runs"]["accum1"]["train"].items()}
    accum2 = Optimizer(net.parameters(), Config(train=TrainConfig(
        **{**train, "grad_accum": 2})))
    with pytest.raises(ValueError, match="opt_state: expected a dict of 5, "
                                         "found tuple of 2"):
        accum2.load_optax_state(tree["opt_state"], net)
    opt = Optimizer(net.parameters(), Config(train=TrainConfig(**train)))
    adam = tree["opt_state"][1][0]
    mu = {**adam["mu"], "head": {"kernel": adam["mu"]["head"]["kernel"].T,
                                 "bias": adam["mu"]["head"]["bias"]}}
    bad = (None, ({**adam, "mu": mu}, None, tree["opt_state"][1][2]))
    with pytest.raises(ValueError, match="opt_state/1/0/mu: does not match"):
        opt.load_optax_state(bad, net)
    skewed = (None, (adam, None, {"count": torch.tensor(5, dtype=torch.int32)}))
    with pytest.raises(ValueError, match="the schedule's count 5 differs"):
        opt.load_optax_state(skewed, net)


# ---------------------------------------------------------------------------
# the CLIs against train.py and infer.py
# ---------------------------------------------------------------------------

def _jax_train(logdir, steps, grad_accum, resume=False):
    """train.py in this process, logging every step (metrics.jsonl)."""
    import train as jax_train_cli
    argv = ["train.py", "--preset", "p5_train", "--steps", str(steps),
            "--logdir", str(logdir), "--data-parallel", "1",
            "--set", *RESUME_SET, f"train.grad_accum={grad_accum}"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", argv + (["--resume"] if resume else []))
        mp.setattr(jax_loop, "train_loop",
                   functools.partial(jax_loop.train_loop, log_every=1))
        jax_train_cli.main()
    return [json.loads(x) for x in (logdir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per grad_accum: train.py's run to JAX_RUNS steps (copied before the
    resume) and its metrics after --resume for RESUMED_STEPS more."""
    root = tmp_path_factory.mktemp("jax_runs")
    out = {}
    for grad_accum, steps in JAX_RUNS.items():
        logdir = root / f"accum{grad_accum}"
        _jax_train(logdir, steps, grad_accum)
        shutil.copytree(logdir, root / f"accum{grad_accum}_before_resume")
        lines = _jax_train(logdir, steps + RESUMED_STEPS, grad_accum, resume=True)
        out[grad_accum] = {"before": root / f"accum{grad_accum}_before_resume",
                           "after": logdir, "metrics": lines[-RESUMED_STEPS:]}
    return out


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_cli_resumes_a_jax_run(tmp_path, jax_runs, few_threads, grad_accum):
    """train_torch.py --resume on train.py's directory: the next two steps'
    loss and grad_norm are train.py --resume's, and so is every parameter's
    update over them, to UPDATE_REL of its largest element; the port keeps
    its own checkpoints in <logdir>/ckpt_torch, and a second --resume
    continues from them."""
    run = jax_runs[grad_accum]
    logdir = tmp_path / "run"
    shutil.copytree(run["before"], logdir)
    start = JAX_RUNS[grad_accum]
    argv = ["--preset", "p5_train", "--device", "cpu", "--logdir", str(logdir),
            "--resume", "--set", *RESUME_SET, f"train.grad_accum={grad_accum}"]
    r = train_torch.main(argv + ["--steps", str(start + RESUMED_STEPS)])
    assert r["step"] == start + RESUMED_STEPS
    assert [m["step"] for m in run["metrics"]] == list(
        range(start + 1, start + RESUMED_STEPS + 1))
    for got, want in zip(r["history"], run["metrics"]):
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= STEP_REL * abs(want[k]), (k, got, want)

    def params(directory, step):
        tree = read_orbax_step(str(directory / "ckpt"), step, keys=("params",))
        return convert_flax_variables({"params": tree["state"]["params"]})
    before = params(run["before"], start)
    jax_after = params(run["after"], start + RESUMED_STEPS)
    port_after = r["state"].model.state_dict()
    assert sorted(before) == sorted(n for n, _ in r["state"].model.named_parameters())
    for name, b in before.items():
        want = jax_after[name] - b
        err = float((port_after[name] - jax_after[name]).abs().max())
        assert err <= UPDATE_REL * float(want.abs().max()), (name, err)
    assert r["checkpoint"] == str(logdir / "ckpt_torch" / f"step_{start + 2:08d}.pt")
    assert orbax_steps(str(logdir / "ckpt")) == [start]      # train.py's, untouched
    again = train_torch.main(argv + ["--steps", str(start + RESUMED_STEPS + 1)])
    assert again["step"] == start + RESUMED_STEPS + 1 and len(again["history"]) == 1


@pytest.fixture
def jax_reads_with_pil(monkeypatch):
    """Both packages' readers decode with PIL (test_torch_port_cli.py)."""
    monkeypatch.setattr(jax_native_loader, "_native", lambda: None)
    pin_port_to_pil(monkeypatch)


_JaxCheckpointer = jax_checkpoint.Checkpointer


def _params_only_restore(directory, **kw):
    """infer.py's Checkpointer, whose manager restores the whole state item
    and returns the part infer.py's target names (module docstring)."""
    ckpt = _JaxCheckpointer(directory, **kw)
    manager = ckpt.manager

    class ParamsOnly:
        def __getattr__(self, name):
            return getattr(manager, name)

        def restore(self, step, args):
            full = manager.restore(step, args=ocp.args.Composite(
                state=ocp.args.StandardRestore()))["state"]
            return {"state": {k: full[k] for k in args["state"].item}}

    ckpt.manager = ParamsOnly()
    return ckpt


def test_infer_cli_serves_a_jax_run_as_infer_py(tmp_path, jax_runs, few_threads,
                                                jax_reads_with_pil, monkeypatch):
    """infer_torch.py --ckpt <orbax directory> gives infer.py's labels and
    J&F: the latest step's params over the seeded init's BN statistics,
    the config from --preset / --set. The directory is train.py's last step
    saved again by the JAX package's Checkpointer with BN statistics far
    from the init's, so that serving them would change every label."""
    import infer as jax_infer_cli
    full = _orbax_restore(jax_runs[1]["after"] / "ckpt", JAX_RUNS[1] + RESUMED_STEPS)
    rng = np.random.RandomState(5)
    stats = {k: v for k, v in _leaves(full["batch_stats"]).items()}
    assert stats and all(np.all(np.asarray(v) == (k.endswith("var")))
                         for k, v in stats.items())          # the init's
    batch_stats = jax.tree.map(lambda x: (rng.uniform(0.2, 5.0, x.shape)).astype(
        np.float32), full["batch_stats"])
    ckpt = tmp_path / "ckpt"
    saver = _JaxCheckpointer(str(ckpt), async_save=False)
    saver.save(_State(full["step"], full["params"], batch_stats, full["opt_state"]))
    saver.wait()
    saver.close()
    root = cs.write_davis_tree(tmp_path / "DAVIS", train_seeds=(21,),
                               val_seeds=(23, 24), T=4, hw=(60, 100))
    argv = ["--preset", "p5_train", "--ckpt", str(ckpt), "--davis-root",
            str(root), "--set", *TINY]
    monkeypatch.setattr(jax_checkpoint, "Checkpointer", _params_only_restore)
    monkeypatch.setattr(sys, "argv", ["infer.py", "--out", str(tmp_path / "jax"),
                                      *argv])
    jax_infer_cli.main()
    got = infer_torch.main(["--out", str(tmp_path / "port"), "--device", "cpu",
                            *argv])
    want = json.loads((tmp_path / "jax" / "results.json").read_text())
    assert sorted(got["sequences"]) == sorted(want["sequences"]) == ["val23", "val24"]
    for name in want["sequences"]:
        for t in range(4):
            a = np.asarray(Image.open(tmp_path / "port" / name / f"{t:05d}.png"))
            b = np.asarray(Image.open(tmp_path / "jax" / name / f"{t:05d}.png"))
            assert (a != b).mean() < 1e-3, (name, t)
        assert abs(got["sequences"][name]["J&F"] - want["sequences"][name]["J&F"]) <= 1e-3
    assert abs(got["J&F"] - want["J&F"]) <= 1e-3
    cfg, loaded = load_checkpoint(str(ckpt))
    assert cfg is None and set(loaded) == {"params"}
