"""The port's bench tools on the CPU: the bench inputs and the bytes model
against the JAX package's, the frame step's FLOP count against XLA's cost
analysis, bench_torch.py in-process (``BENCH_DEVICE=cpu``) and its refusal
without a card, and one tiny run of each bench/*_torch.py tool."""

import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import bench_torch
from dmm_net_tpu.config import preset as jax_preset
from dmm_net_tpu.kernels.matcher import _pool_cost_match_reference
from dmm_net_tpu.models import dmm as jax_dmm
from dmm_net_tpu.utils.bench_inputs import make_frame_inputs as jax_frame_inputs
from dmm_net_tpu.utils.bytes_model import chunk_step_bytes as jax_chunk_step_bytes
from dmm_net_tpu_torch.config import _PRESETS, preset
from dmm_net_tpu_torch.infer.engine import InferenceEngine
from dmm_net_tpu_torch.kernels.matcher import pool_cost_match_ops
from dmm_net_tpu_torch.utils.bench_inputs import make_frame_inputs
from dmm_net_tpu_torch.utils.bytes_model import chunk_step_bytes
from test_torch_port_train_step import few_threads  # noqa: F401

_ROOT = Path(__file__).resolve().parents[1]

# p3 cut to a few pixels, objects and channels (the kernels' paths stay)
TINY = {"model.backbone": "resnet18", "model.backbone_dtype": "float32",
        "model.image_size": (64, 128), "matching.max_templates": 4,
        "matching.max_proposals": 8, "model.feature_dim": 32,
        "model.decoder_dim": 16}
TINY_SET = ("model.backbone=resnet18 model.backbone_dtype=float32 "
            "model.image_size=64,64 matching.max_templates=4 "
            "matching.max_proposals=8 model.feature_dim=32 model.decoder_dim=16")


def test_frame_inputs_match_jax_in_kind():
    """The same six tensors in shapes and dtypes (the state's included),
    all slots valid, masks 1 with probability 0.2 (within 0.01 of each
    other at these sizes)."""
    B = 3
    got = make_frame_inputs(preset("p3_multi_object").override(**TINY), B,
                            seed=1, device="cpu")
    want = jax_frame_inputs(jax_preset("p3_multi_object").override(**TINY), B,
                            seed=1)
    flat = list(got[:5]) + list(got[5])
    jflat = list(want[:5]) + list(want[5])
    assert len(flat) == len(jflat) == 7
    for g, w in zip(flat, jflat):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert got[2].all() and got[4].all()
    for i in (1, 5):                      # proposal masks, template masks
        g = float(flat[i].float().mean())
        w = float(jnp.asarray(jflat[i], jnp.float32).mean())
        assert abs(g - 0.2) < 0.01 and abs(w - 0.2) < 0.01, (i, g, w)
    assert abs(float(got[3].std()) - 1) < 0.1


@pytest.mark.parametrize("name", sorted(_PRESETS))
@pytest.mark.parametrize("B", [1, 16])
def test_bytes_model_matches_jax_but_for_the_detail_basis(name, B):
    """Every stage equal to the JAX package's model, except the detail
    head's basis weights: k*k*f*D (k = decoder_detail_basis_k) where the
    reference counts 9*f*D, a difference of (k*k - 9)*f*D weight elements
    per step amortised over B, present where the per-object pyramid stops
    above stride 4 (the detail head exists)."""
    cfg, jcfg = preset(name), jax_preset(name)
    got, want = chunk_step_bytes(cfg, B), jax_chunk_step_bytes(jcfg, B)
    assert got["stages"].keys() == want["stages"].keys()
    m = cfg.model
    head = m.decoder_variant == "shared" and m.decoder_obj_fine_level in ("c3", "c4")
    k, dd = m.decoder_detail_basis_k, {"bfloat16": 2, "float32": 4}[m.decoder_dtype]
    diff_mb = (k * k - 9) * m.decoder_dim * m.decoder_detail_dim * dd / B / 1e6 if head else 0.0
    for stage, mb in want["stages"].items():
        if stage == "weights_decoder":
            assert got["stages"][stage] == pytest.approx(mb + diff_mb, abs=1e-3)
        else:
            assert got["stages"][stage] == mb, stage
    assert got["total_mb_per_frame"] == pytest.approx(
        want["total_mb_per_frame"] + diff_mb, rel=1e-12)
    # with a 3x3 basis the two models agree exactly
    k3 = {"model.decoder_detail_basis_k": 3}
    assert (chunk_step_bytes(cfg.override(**k3), B)
            == jax_chunk_step_bytes(jcfg.override(**k3), B))


def _taps(n_in, n_out, k, s, p, d):
    return sum(sum(1 for j in range(k) if 0 <= o * s - p + j * d < n_in)
               for o in range(n_out))


def _conv_without_padding(x_shape, w_shape, _bias, stride, padding, dilation,
                          transposed, *args, out_shape=None, **kwargs):
    """A conv's FLOPs over the kernel taps that land inside its input, as
    XLA's cost analysis counts them (FlopCounterMode counts every tap)."""
    assert not transposed
    th = _taps(x_shape[2], out_shape[2], w_shape[2], stride[0], padding[0], dilation[0])
    tw = _taps(x_shape[3], out_shape[3], w_shape[3], stride[1], padding[1], dilation[1])
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * th * tw


def test_frame_step_flops_against_xla_cost_analysis(few_threads):  # noqa: F811
    """One tiny frame step (B=2, R-18 at 64x128, the plain matcher, as XLA
    can count it): bench_torch.count_flops against XLA's cost analysis of
    the JAX package's step (plain 7x7 stem). Measured once: the port counts
    1.199x XLA's. The whole gap is the convs' padding: XLA counts only the
    taps inside the input, FlopCounterMode every tap, and at 64x128 the
    stride-32 maps are 2x4. Counted XLA's way the port is 0.979x XLA's, the
    rest being the elementwise ops (BatchNorm, ReLU, adds, the Sinkhorn)
    that XLA counts and FlopCounterMode does not."""
    from torch.utils.flop_counter import FlopCounterMode

    from dmm_net_tpu.infer.engine import resolve_labels as jax_resolve
    from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
    from dmm_net_tpu.models.dmm import init_frame_state as jax_init_state

    ov = {**TINY, "matching.use_pallas": False}
    cfg, jcfg = preset("p3_multi_object").override(**ov), \
        jax_preset("p3_multi_object").override(**ov)
    B, (H, W), M, N = 2, TINY["model.image_size"], 4, 8
    args = (jnp.zeros((B, H, W, 3)), jnp.zeros((B, N, H, W)), jnp.ones((B, N), bool),
            jnp.zeros((B, M, 32)), jnp.ones((B, M), bool),
            jax_init_state(jcfg, jnp.zeros((B, M, H, W))))
    with pytest.MonkeyPatch.context() as mp:
        plain_stem = jax_dmm.backbone_by_name
        mp.setattr(jax_dmm, "backbone_by_name",
                   lambda *a, **k: plain_stem(*a, **{**k, "s2d_stem": False}))
        model = JaxDMMNet(jcfg)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)

        def step(v, *a):
            out, st = model.apply(v, *a)
            return (jax_resolve(out.logits, a[4], (H, W), use_pallas=False),
                    out.assignment, st)
        cost = jax.jit(step).lower(shapes, *args).compile().cost_analysis()
    want = float((cost[0] if isinstance(cost, list) else cost)["flops"])

    engine = InferenceEngine(cfg, device="cpu")
    ins = make_frame_inputs(cfg, B, device="cpu")
    aten = torch.ops.aten
    with torch.inference_mode():
        got = bench_torch.count_flops(engine._frame_step, ins,
                                      bench_torch.kernel_ops(cfg, B, ins[4], ins[2]))
        with FlopCounterMode(display=False, custom_mapping={
                aten.convolution: _conv_without_padding,
                aten._convolution: _conv_without_padding}) as counter:
            engine._frame_step(*ins)
    assert 1.18 < got / want < 1.22, got / want
    assert 0.97 < counter.get_total_flops() / want < 0.99


def test_b1_operation_count_against_xla():
    """The hand count B1's bound and the bench's FLOPs use
    (``pool_cost_match_ops``) against XLA's cost analysis of the JAX
    package's plain version of the same function: measured 1.077x XLA's
    flops at this shape (the hand count charges 10 operations per valid
    pair per Sinkhorn iteration for the two log-sum-exps; XLA counts the
    exp and log apart, as transcendentals)."""
    B, M, N, P, D, Pc, iters = 2, 4, 8, 32, 32, 1024, 30
    f = jax.jit(lambda *a: _pool_cost_match_reference(*a, 0.05, iters, 0.3))
    shapes = [jax.ShapeDtypeStruct(s, jnp.float32) for s in
              ((B, P, D), (B, N, P), (B, M, Pc), (B, N, Pc), (B, M, D))]
    shapes += [jax.ShapeDtypeStruct((B, M), bool), jax.ShapeDtypeStruct((B, N), bool)]
    cost = f.lower(*shapes).compile().cost_analysis()
    want = float((cost[0] if isinstance(cost, list) else cost)["flops"])
    got = pool_cost_match_ops(B, M, N, P, D, Pc, iters, B * M * N)
    assert 1.05 < got / want < 1.10, got / want


@pytest.mark.parametrize("mode", ["chunked_scan", "frame"])
def test_bench_runs_on_the_cpu_when_asked(mode, monkeypatch, capsys, few_threads):  # noqa: F811
    """bench_torch.main() with BENCH_DEVICE=cpu at a tiny BENCH_SET: one
    JSON line with bench.py's keys, the five decoder fields, the device
    and its power limit; one fps per window; a finite parity; null for
    every share of a device peak."""
    for k, v in {"BENCH_DEVICE": "cpu", "BENCH_MODE": mode, "BENCH_BATCH": "2",
                 "BENCH_CHUNK": "2", "BENCH_ITERS": "1", "BENCH_WINDOWS": "3",
                 "BENCH_SET": TINY_SET}.items():
        monkeypatch.setenv(k, v)
    r = bench_torch.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == r
    bench_py_keys = {
        "metric", "value", "unit", "vs_baseline", "vs_estimate", "baseline_note",
        "mode", "batch", "chunk", "preset", "image_size", "M", "N",
        "decoder_variant", "decoder_obj_dim_fine", "mask_dtype", "use_pallas",
        "fps_windows", "pallas_parity_max_abs", "gflop_per_frame",
        "mfu_pct_bf16_peak", "mb_per_frame", "hbm_roofline_pct",
        "mb_per_frame_hand", "hbm_roofline_pct_hand", "overrides"}
    added = {"decoder_obj_fuse", "decoder_obj_fine_level",
             "decoder_obj_merge_fine_k", "decoder_detail_dim",
             "decoder_detail_basis_k", "device", "power_limit_w", "peak_mem_gib"}
    assert set(r) == bench_py_keys | added
    assert r["mode"] == mode and r["device"] == "cpu" and r["power_limit_w"] is None
    assert len(r["fps_windows"]) == 3 and r["value"] == max(r["fps_windows"]) > 0
    assert math.isfinite(r["pallas_parity_max_abs"]) and r["pallas_parity_max_abs"] < 5e-3
    assert r["gflop_per_frame"] > 0 and r["mb_per_frame_hand"] > 0
    for k in ("mfu_pct_bf16_peak", "hbm_roofline_pct_hand", "mb_per_frame",
              "hbm_roofline_pct", "peak_mem_gib"):
        assert r[k] is None, k
    assert r["chunk"] == (2 if mode == "chunked_scan" else None)


def test_bench_matcher_times_several_shapes_in_train_mode(capsys, few_threads):  # noqa: F811
    """bench/bench_matcher_torch.py with --shape twice and --train: one row
    per shape, keyed by its sizes, with the float inputs requiring a
    gradient; --device-ms adds nothing on the CPU."""
    r = _tool("bench_matcher_torch").main(
        ["--device", "cpu", "--iters", "1", "--P", "16", "--D", "8", "--Pc", "64",
         "--sinkhorn", "3", "--shape", "2,4,16", "--shape", "1,2,8", "--train",
         "--device-ms", "5"])
    assert list(r) == ["B=2 M=4 N=16", "B=1 M=2 N=8"]
    for row in r.values():
        assert set(row) == {"plain_ms", "kernel_ms"}
        assert all(math.isfinite(v) and v > 0 for v in row.values())
    assert capsys.readouterr().out.count(", train\n") == 2


def test_bench_matcher_times_the_backward_at_named_shapes(capsys, few_threads):  # noqa: F811
    """--backward times the forward and B1' (all five gradients) of each
    version at chip_smoke.py 7a's named shapes, with their epsilons; the
    device split needs a card, so on the CPU only the two wall times."""
    r = _tool("bench_matcher_torch").main(
        ["--device", "cpu", "--iters", "1", "--P", "16", "--D", "8", "--Pc", "64",
         "--sinkhorn", "3", "--shape", "p5", "--shape", "2,4,16", "--backward"])
    assert list(r) == ["p5", "B=2 M=4 N=16"]
    for row in r.values():
        assert set(row) == {"plain_ms", "kernel_ms"}
        assert all(math.isfinite(v) and v > 0 for v in row.values())
    out = capsys.readouterr().out
    assert "B=4 M=8 N=64" in out and "epsilon=0.03, backward" in out
    assert "epsilon=0.05, backward" in out


def test_bench_roi_align_times_both_heads_per_train_image(capsys, few_threads):  # noqa: F811
    """bench/bench_roi_align_torch.py on the CPU times the plain versions
    (the forward, and with --backward the explicit plain backward) of both
    heads at chip_smoke.py 9a's pyramid, and their sum per train image."""
    tool = _tool("bench_roi_align_torch")
    for extra in ([], ["--backward"]):
        r = tool.main(["--device", "cpu", "--K", "3", "--calls", "1", *extra])
        assert set(r) == {"K=3 box", "K=3 mask", "K=3 image"}
        assert r["K=3 image"] == r["K=3 box"]["ms"] + r["K=3 mask"]["ms"] > 0
    assert "backward" in capsys.readouterr().out
    levels, boxes, g = tool.detector_inputs(5, (14, 14), "cpu", C=8)
    assert [tuple(f.shape) for f in levels] == [(8, 64, 112), (8, 32, 56), (8, 16, 28), (8, 8, 14)]
    assert tuple(boxes.shape) == (5, 4) and tuple(g.shape) == (5, 8, 14, 14)
    assert boxes[-1].tolist() == [0.0, 0.0, 448.0, 256.0]


def test_bench_refuses_without_a_card(monkeypatch):
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_torch.main()
    assert e.value.code not in (0, None)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, _ROOT / "bench" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOLS = {
    "bench_matcher_torch": (["--device", "cpu", "--batch", "2", "--iters", "2",
                             "--N", "16", "--P", "16", "--D", "8", "--Pc", "64",
                             "--sinkhorn", "5"], {}),
    "bench_e2e_torch": (["--device", "cpu", "--batches", "1", "--iters", "1",
                         "--pallas", "--set", *TINY_SET.split()], {}),
    "bench_breakdown_torch": (["--device", "cpu", "--set", *TINY_SET.split()],
                              {"BENCH_BATCH": "1", "BENCH_ITERS": "1"}),
    "bench_opprofile_torch": (["--device", "cpu", "--calls", "1", "--top", "5"],
                              {"BENCH_BATCH": "1", "BENCH_CHUNK": "2",
                               "BENCH_SET": TINY_SET}),
    "bench_stream_torch": (["--device", "cpu", "--frames", "4", "--decode-ms", "1",
                            "--chunk", "2", "--set", *TINY_SET.split()], {}),
    "bench_loader_torch": (["--files", "2", "--threads", "2", "--reps", "1"], {}),
    "bench_convmarginal_torch": (["--device", "cpu", "--batch", "1", "--objects",
                                  "2", "--image-size", "64", "64"],
                                 {"BENCH_REPS": "1", "BENCH_DEPTH": "2"}),
    "bench_objpack_torch": (["--device", "cpu", "--objects", "2", "--image-size",
                             "64", "64"], {"BENCH_BATCH": "1", "BENCH_REPS": "1"}),
    "bench_roi_align_torch": (["--device", "cpu", "--K", "2", "--calls", "1"], {}),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_bench_tool_runs_on_the_cpu(name, monkeypatch, capsys, few_threads):  # noqa: F811
    """Each bench/*_torch.py main(argv) once at a tiny setting: it prints
    and returns its rows, each number finite."""
    argv, env = TOOLS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    r = _tool(name).main(argv)
    assert capsys.readouterr().out.strip()
    values = (list(r.values()) if isinstance(r, dict)
              else [v for row in r for v in (row.values() if isinstance(row, dict)
                                             else row[1:])])
    flat = [x for v in values for x in (v.values() if isinstance(v, dict) else [v])]
    assert flat and all(x is None or isinstance(x, (str, list)) or math.isfinite(x)
                        for x in flat)
    if name == "bench_loader_torch":
        from dmm_net_tpu_torch.data import native_loader
        assert (r["native"] is None) == (not native_loader.available())
