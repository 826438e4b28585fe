"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked ``cuda``: they skip without a CUDA device and nvcc. The file imports
no JAX, so on a machine without JAX it runs with the repository's conftest
left out:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from dmm_net_tpu_torch.kernels import _build
from dmm_net_tpu_torch.kernels.matcher import (cost_match_plain,
                                               fused_cost_match,
                                               fused_pool_cost_match,
                                               pool_cost_match_plain)
from dmm_net_tpu_torch.kernels.resolve import (fused_resolve_upsample,
                                               resolve_upsample_plain)
from dmm_net_tpu_torch.kernels.roi_align import (multilevel_roi_align,
                                                 multilevel_roi_align_plain,
                                                 roi_align)
from dmm_net_tpu_torch.ops.roi_pool import roi_align_mxu


@pytest.fixture
def cuda_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc")
    _build.build_all()


def _matcher_problem(gen, B, M, N, P, D, Pc):
    dev = "cuda"
    emb = torch.randn(B, P, D, device=dev, generator=gen)
    pm_pool = (torch.rand(B, N, P, device=dev, generator=gen) > 0.6).float()
    tm = (torch.rand(B, M, Pc, device=dev, generator=gen) > 0.6).float()
    pm = (torch.rand(B, N, Pc, device=dev, generator=gen) > 0.6).float()
    tf = torch.randn(B, M, D, device=dev, generator=gen)
    rm = torch.rand(B, M, device=dev, generator=gen) > 0.25
    rm[:, 0] = True
    cm = torch.rand(B, N, device=dev, generator=gen) > 0.2
    return emb, pm_pool, tm, pm, tf, rm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16, 128, 448, 256, 4096),  # p3 B=16
                                   (4, 16, 128, 448, 256, 4096),   # p3 B=4
                                   (4, 32, 256, 448, 256, 4096),   # p4 B=4
                                   (4, 16, 100, 448, 256, 4096),   # N % 32 != 0
                                   (2, 64, 40, 450, 130, 1000),    # M at its limit
                                   (3, 5, 19, 37, 24, 300)])       # unaligned
@pytest.mark.parametrize("eps_init", [None, 0.5])
def test_cuda_matcher_matches_plain(cuda_kernels, shape, eps_init):
    gen = torch.Generator(device="cuda").manual_seed(0)
    arrs = _matcher_problem(gen, *shape)
    got = fused_pool_cost_match(*arrs, epsilon_init=eps_init)
    want = pool_cost_match_plain(*arrs, epsilon_init=eps_init)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
    rm, cm = arrs[5], arrs[6]
    assert (got[~rm] == 0).all()
    assert (got.transpose(1, 2)[~cm] == 0).all()


@pytest.mark.cuda
def test_cuda_matcher_keeps_a_nan_as_its_plain_version(cuda_kernels):
    """A NaN in B1's embedding reaches X where it reaches the plain
    version's (torch's clamps keep a NaN; CUDA's fminf / fmaxf would drop
    it and give finite garbage), and the other batch elements are
    untouched; so utils/debug.checked catches it."""
    from dmm_net_tpu_torch.utils.debug import checked
    gen = torch.Generator(device="cuda").manual_seed(0)
    arrs = _matcher_problem(gen, 4, 16, 128, 448, 256, 4096)
    arrs[0][0, 0, 0] = float("nan")
    got, want = fused_pool_cost_match(*arrs), pool_cost_match_plain(*arrs)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[0]).any() and not torch.isnan(got[1:]).any()
    torch.testing.assert_close(got[1:], want[1:], atol=2e-4, rtol=0)
    with pytest.raises(FloatingPointError):
        checked(fused_pool_cost_match)(*arrs)


def _resolve_problem(gen, B, M, h, w, dead=False):
    """Logits with ~70% valid slots whose invalid slots carry the largest
    logits; ``dead``: the last batch element has no valid slot."""
    lg = torch.randn(B, M, h, w, device="cuda", generator=gen) * 3
    v = torch.rand(B, M, device="cuda", generator=gen) > 0.3
    v[:, 0] = True
    if dead:
        v[-1] = False
    lg[~v] = 50.0
    return lg, v


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16, 64, 112, 256, 448),    # p3 B=16
                                   (4, 16, 64, 112, 256, 448),     # p3 B=4
                                   (1, 32, 64, 112, 256, 448),     # p4
                                   (4, 16, 120, 216, 480, 864),    # p3_480p
                                   (2, 40, 64, 112, 256, 448),     # M over a chunk
                                   (2, 5, 17, 29, 67, 115),        # non-integer scale
                                   (2, 3, 7, 1, 7, 9)],            # w == 1
                         ids=["p3-B16", "p3-B4", "p4", "p3_480p", "M40", "unaligned",
                              "w1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_resolve_matches_plain(cuda_kernels, shape, dtype):
    """Every product is of two bf16 values and every sum has at most two
    nonzero terms, so the kernel's labels equal the plain version's."""
    B, M, h, w, H, W = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    lg, v = _resolve_problem(gen, B, M, h, w)
    got = fused_resolve_upsample(lg.to(dtype), v, (H, W))
    want = resolve_upsample_plain(lg.to(dtype), v, (H, W))
    assert got.dtype == torch.uint8 and got.shape == (B, H, W)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_resolve_launches_once_and_leaves_dead_elements_unlabelled(cuda_kernels):
    gen = torch.Generator(device="cuda").manual_seed(4)
    lg, v = _resolve_problem(gen, 2, 16, 64, 112, dead=True)
    _build.reset_launch_counts()
    got = fused_resolve_upsample(lg, v, (256, 448))
    assert _build.launch_counts()["fused_resolve_upsample"] == 1
    assert (got[1] == 0).all() and (got[0] > 0).any()
    assert torch.equal(got, resolve_upsample_plain(lg, v, (256, 448)))


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda_kernels):
    lg = torch.randn(1, 3, 8, 8, device="cuda").half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_resolve_upsample(lg, torch.ones(1, 3, dtype=torch.bool,
                                              device="cuda"), (16, 16))
    # an 8x downsample: a band's windows would not fit in shared memory
    lg = torch.randn(1, 3, 256, 448, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        fused_resolve_upsample(lg, torch.ones(1, 3, dtype=torch.bool,
                                              device="cuda"), (32, 56))
    gen = torch.Generator(device="cuda").manual_seed(2)
    arrs = list(_matcher_problem(gen, 1, 4, 8, 16, 8, 64))
    arrs[0] = arrs[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_pool_cost_match(*arrs)


def _boxes(gen, K, H, W):
    """Boxes in image coordinates at the detector's 256x448: most inside,
    some touching or crossing the border, some under one pixel at p5."""
    dev = "cuda"
    xy = torch.rand(K, 2, device=dev, generator=gen) * torch.tensor([W, H], device=dev)
    wh = 1 + torch.rand(K, 2, device=dev, generator=gen) * torch.tensor(
        [W, H], device=dev) * 0.6
    b = torch.cat([xy - 0.2 * wh, xy + wh], 1)
    b[: K // 8, 2:] = b[: K // 8, :2] + 0.4          # < 1 px at every level
    b[K // 8: K // 4, 0] = -12.0                     # beyond the left edge
    b[K // 8: K // 4, 3] = H + 20.0                  # beyond the bottom edge
    return b.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
@pytest.mark.parametrize("level", [2, 3, 4, 5])
def test_cuda_roi_align_matches_plain(cuda_kernels, level, out_size):
    gen = torch.Generator(device="cuda").manual_seed(level)
    H, W = 256 // 2 ** level, 448 // 2 ** level
    feats = torch.randn(256, H, W, device="cuda", generator=gen)
    boxes = _boxes(gen, 128, 256, 448)
    got = roi_align(feats, boxes, out_size, 2, 1.0 / 2 ** level)
    want = roi_align_mxu(feats, boxes, out_size, 2, 1.0 / 2 ** level)
    assert got.shape == (128, 256) + out_size
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16, 128, 4096, 256),    # B, M, N, P, D
                                   (1, 5, 37, 100, 48),         # unaligned
                                   (1, 32, 256, 256, 64)])      # p4's M, N
def test_cuda_cost_match_matches_plain(cuda_kernels, shape):
    B, M, N, P, D = shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    tm = (torch.rand(B, M, P, device="cuda", generator=gen) > 0.6).float()
    pm = (torch.rand(B, N, P, device="cuda", generator=gen) > 0.6).float()
    tf = torch.randn(B, M, D, device="cuda", generator=gen)
    pf = torch.randn(B, N, D, device="cuda", generator=gen)
    rm = torch.rand(B, M, device="cuda", generator=gen) > 0.25
    rm[:, 0] = True
    cm = torch.rand(B, N, device="cuda", generator=gen) > 0.2
    got = fused_cost_match(tm, pm, tf, pf, rm, cm)
    want = cost_match_plain(tm, pm, tf, pf, rm, cm)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert (got[~rm] == 0).all()
    assert (got.transpose(1, 2)[~cm] == 0).all()


@pytest.mark.cuda
def test_cuda_roi_align_rejects_bad_inputs(cuda_kernels):
    feats = torch.randn(8, 16, 16, device="cuda")
    boxes = torch.tensor([[1.0, 2.0, 9.0, 12.0]], device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        roi_align(feats.transpose(1, 2), boxes)
    with pytest.raises(ValueError, match="float32"):
        roi_align(feats.double(), boxes.double())


@pytest.mark.cuda
def test_cuda_roi_align_without_boxes_launches_nothing(cuda_kernels):
    _build.reset_launch_counts()
    out = roi_align(torch.randn(8, 16, 16, device="cuda"),
                    torch.zeros(0, 4, device="cuda"), (14, 14))
    assert out.shape == (0, 8, 14, 14)
    assert _build.launch_counts()["roi_align"] == 0


def _pyramid(gen, C=256, image=(256, 448)):
    return [torch.randn(C, -(-image[0] // 2 ** l), -(-image[1] // 2 ** l),
                        device="cuda", generator=gen) for l in (2, 3, 4, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
def test_cuda_multilevel_roi_align_matches_plain(cuda_kernels, out_size):
    """The detector's shapes: 256x448 pyramid, K=128, C=256; one launch."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    levels = _pyramid(gen)
    boxes = _boxes(gen, 128, 256, 448)
    boxes[-1] = torch.tensor([0.0, 0.0, 448.0, 256.0], device="cuda")
    _build.reset_launch_counts()
    got = multilevel_roi_align(levels, boxes, out_size)
    assert _build.launch_counts()["roi_align"] == 1
    want = multilevel_roi_align_plain(levels, boxes, out_size)
    assert got.shape == (128, 256) + out_size
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_multilevel_roi_align_without_boxes_launches_nothing(cuda_kernels):
    gen = torch.Generator(device="cuda").manual_seed(8)
    _build.reset_launch_counts()
    out = multilevel_roi_align(_pyramid(gen, C=16), torch.zeros(0, 4, device="cuda"),
                               (7, 7))
    assert out.shape == (0, 16, 7, 7)
    assert _build.launch_counts()["roi_align"] == 0


def _small_p3(**sets):
    """p3_multi_object's path (fused matcher, stride-4 masks, mask-grid
    logits) cut to R-18 at 64x96, float32, M=4, N=8."""
    from dmm_net_tpu_torch.config import preset
    return preset("p3_multi_object").override(**{
        "model.backbone": "resnet18", "model.image_size": (64, 96),
        "model.backbone_dtype": "float32", "model.decoder_dtype": "float32",
        "model.mask_dtype": "float32", "model.decoder_dim": 16,
        "matching.max_templates": 4, "matching.max_proposals": 8, **sets})


def _full_grid_items(seed, T=3, B=2, N=8, M=4, H=64, W=96):
    import numpy as np
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
        cy = rng.randint(8, H - 8, (B, N, 1, 1))
        cx = rng.randint(8, W - 8, (B, N, 1, 1))
        r2 = rng.randint(40, 400, (B, N, 1, 1))
        items.append({"frame": frames[t],
                      "prop_masks": (((yy - cy) ** 2 + (xx - cx) ** 2) < r2)
                      .astype(np.uint8),
                      "prop_valid": rng.rand(B, N) > 0.2})
    return frames, tmpl, valid, items


@pytest.mark.cuda
def test_cuda_legacy_frame_step_matches_cpu(cuda_kernels):
    """The legacy decoder's frame step on the card (B1, cuDNN) against the
    port on the CPU (plain versions), same seeded weights, float32."""
    from dmm_net_tpu_torch.models.dmm import DMMNet
    cfg = _small_p3(**{"model.decoder_variant": "legacy"})
    frames, tmpl, valid, items = _full_grid_items(0)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = DMMNet(cfg, device=dev, seed=3)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        with torch.no_grad():
            state = model.init_state(t(tmpl))
            tf = model.pool_mask_features(model.extract_features(t(frames[0])),
                                          t(tmpl))
            out, st = model(t(items[1]["frame"]), t(items[1]["prop_masks"]),
                            t(items[1]["prop_valid"]), tf, t(valid), state)
        outs[dev] = (out.logits.cpu(), out.assignment.cpu(), st.decoder_state.cpu())
    (lg, X, s), (lg_c, X_c, s_c) = outs["cuda"], outs["cpu"]
    torch.testing.assert_close(X, X_c, atol=2e-4, rtol=0)
    assert (lg - lg_c).abs().max() <= 1e-3 * lg_c.abs().max()
    assert (s - s_c).abs().max() <= 1e-3 * s_c.abs().max()


@pytest.mark.cuda
def test_cuda_hungarian_step_launches_b1_and_b2_once(cuda_kernels):
    import numpy as np
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    cfg = _small_p3(**{"matching.decode": "hungarian"})
    frames, tmpl, valid, items = _full_grid_items(1)
    engine = InferenceEngine(cfg, seed=0)
    _build.reset_launch_counts()
    out = engine.run_sequence(iter(items), tmpl, valid, frames[0])
    counts = _build.launch_counts()
    assert counts["fused_pool_cost_match"] == counts["fused_resolve_upsample"] == 3
    X = out["assignments"]
    assert set(np.unique(X).tolist()) <= {0.0, 1.0}
    assert (X.sum(-1)[:, valid] == 1).all() and X.sum(-2).max() <= 1


@pytest.mark.cuda
def test_cuda_ring_stager_stages_in_order_and_raises(cuda_kernels):
    """Items staged through pinned memory on the stager's own stream arrive
    on the card in order and equal to the host arrays; a failed staging
    raises in the consumer."""
    import numpy as np
    from dmm_net_tpu_torch.data.pipeline import RingStager
    rng = np.random.RandomState(0)
    items = [{"frame": rng.randint(0, 256, (1, 64, 96, 3)).astype(np.uint8),
              "prop_masks": rng.rand(1, 8, 64, 96).astype(np.float32),
              "prop_valid": rng.rand(1, 8) > 0.5} for _ in range(6)]
    got = list(RingStager(iter(items), depth=2))
    assert len(got) == 6
    for g, w in zip(got, items):
        for k in w:
            assert g[k].device.type == "cuda"
            assert np.array_equal(g[k].cpu().numpy(), w[k])
    with pytest.raises(TypeError):
        list(RingStager(iter(items[:2] + [{"frame": np.array([object()])}])))


@pytest.mark.cuda
def test_cuda_engine_takes_staged_items(cuda_kernels):
    """run_stream_chunked on items staged to the card equals the same run
    on numpy items."""
    from dmm_net_tpu_torch.data.pipeline import RingStager
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    cfg = _small_p3()
    frames, tmpl, valid, items = _full_grid_items(2)
    engine = InferenceEngine(cfg, seed=0)
    want = engine.run_stream_chunked(iter(items), tmpl, valid, frames[0], chunk=2)
    _build.reset_launch_counts()
    got = engine.run_stream_chunked(iter(RingStager(iter(items))), tmpl, valid,
                                    frames[0], chunk=2)
    assert _build.launch_counts()["fused_resolve_upsample"] == len(items)
    for k in ("labels", "assignments"):
        assert (got[k] == want[k]).all(), k


@pytest.mark.cuda
@pytest.mark.parametrize("epsilon,eps_init", [(0.1, None), (0.03, 0.2)])
def test_cuda_b1_backward_matches_plain(cuda_kernels, epsilon, eps_init):
    """B1' on the card at the CPU tests' shapes (B=2, M=4, N=16, P=64, D=32,
    Pc=256): X and the five gradients of the kernel-forward Function equal
    autograd through the plain version; one launch and one backward
    counted."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    arrs = _matcher_problem(gen, 2, 4, 16, 64, 32, 256)
    W = torch.randn(2, 4, 16, device="cuda", generator=gen)
    out = {}
    for name, fn in (("kernel", fused_pool_cost_match),
                     ("plain", pool_cost_match_plain)):
        xs = [a.clone().requires_grad_(True) for a in arrs[:5]]
        _build.reset_launch_counts()
        X = fn(*xs, *arrs[5:], epsilon=epsilon, iters=30, epsilon_init=eps_init)
        (X * W).sum().backward()
        out[name] = (X.detach(), [x.grad for x in xs], _build.launch_counts(),
                     _build.backward_calls())
    (Xk, gk, ck, bk), (Xp, gp, _, _) = out["kernel"], out["plain"]
    assert (Xk - Xp).abs().max().item() <= 2e-4
    for a, b in zip(gk, gp):
        assert b.abs().max() > 0
        assert (a - b).abs().max().item() <= 1e-5 + 1e-4 * b.abs().max().item()
    assert ck["fused_pool_cost_match"] == 1
    assert bk["fused_pool_cost_match"] == 1


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_kernels):
    """A tiny float32 train step on the fused path (R-18 64x64, M=4, N=8,
    B=2, T=3, train-mode BN, remat) on the card and on the CPU from the same
    seed: loss, every gradient leaf and the running statistics to 1e-4."""
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.data.synthetic import synthetic_clip_batch
    from dmm_net_tpu_torch.train.loop import (_clip_forward, batch_to,
                                              create_train_state)
    cfg = preset("p5_train").override(**{
        "model.backbone": "resnet18", "model.backbone_dtype": "float32",
        "model.image_size": (64, 64), "model.feature_dim": 32,
        "model.decoder_dim": 16, "model.train_bn": True,
        "matching.max_templates": 4, "matching.max_proposals": 8,
        "matching.use_pallas": True, "train.remat": True})
    batch = synthetic_clip_batch(seed=0, batch=2, T=3, H=64, W=64,
                                 num_objects=2, num_proposals=8, pad_objects=4)
    res = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(cfg, seed=0, device=dev)
        loss, _ = _clip_forward(state.model, batch_to(batch, dev), cfg)
        params = list(state.model.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        res[dev] = (loss.item(), [None if g is None else g.cpu() for g in grads],
                    {k: v.cpu() for k, v in state.model.state_dict().items()
                     if "running" in k})
    (lc, gc, sc), (lh, gh, sh) = res["cuda"], res["cpu"]
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    for a, b in zip(gc, gh):
        if b is None:
            assert a is None
            continue
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-9
    for k in sh:
        torch.testing.assert_close(sc[k], sh[k], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [32, 128])
@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
def test_cuda_b4_backward_matches_plain(cuda_kernels, K, out_size):
    """B4' at the full-width detector's shapes (256x448 R-50-FPN pyramid,
    C=256): the kernel forward within 1e-4 + 1e-4 |want| of the plain
    version, and the four level gradients of a seeded upstream gradient
    equal to autograd through the plain version (1e-4 relative); one
    backward call counted, one launch."""
    gen = torch.Generator(device="cuda").manual_seed(K + out_size[0])
    levels = _pyramid(gen)
    boxes = _boxes(gen, K, 256, 448)
    g = torch.randn(K, 256, *out_size, device="cuda", generator=gen)
    out = {}
    for name, fn in (("kernel", multilevel_roi_align),
                     ("plain", multilevel_roi_align_plain)):
        xs = [t.clone().requires_grad_(True) for t in levels]
        _build.reset_launch_counts()
        y = fn(xs, boxes, out_size, 2)
        grads = torch.autograd.grad(y, xs, g)
        out[name] = (y.detach(), grads, _build.launch_counts()["roi_align"],
                     _build.backward_calls()["roi_align"])
    (yk, gk, lk, bk), (yp, gp, _, _) = out["kernel"], out["plain"]
    assert ((yk - yp).abs() - 1e-4 * yp.abs()).max().item() <= 1e-4
    assert max(b.abs().max().item() for b in gp) > 0
    for a, b in zip(gk, gp):           # a level no box is on has no gradient
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    assert lk == 1 and bk == 1
    with pytest.raises(ValueError, match="boxes must not require"):
        multilevel_roi_align(levels, boxes.clone().requires_grad_(True), out_size)


def _b1_grads(fn, arrs, gX, **kw):
    """X and the five gradients of sum(X * gX) through ``fn``."""
    xs = [a.clone().requires_grad_(True) for a in arrs[:5]]
    X = fn(*xs, *arrs[5:], **kw)
    return X.detach(), torch.autograd.grad(X, xs, gX)


def _within(got, want, rel):
    """Every gradient within ``rel`` of its largest entry."""
    for a, b in zip(got, want):
        assert b.abs().max() > 0
        assert (a - b).abs().max().item() <= rel * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,epsilon,eps_init", [
    ((2, 4, 16, 64, 32, 256), 0.1, None),          # the CPU tests' shapes
    ((2, 4, 16, 64, 32, 256), 0.03, 0.2),
    ((4, 8, 64, 448, 256, 4096), 0.03, None),       # p5_train
    ((4, 16, 128, 448, 256, 4096), 0.05, None),     # p3
    ((4, 32, 256, 448, 256, 4096), 0.05, None),     # p4
    ((2, 64, 512, 64, 32, 256), 0.05, None),        # dC in device memory
    ((1, 64, 800, 64, 32, 256), 0.05, None),        # dC and the history there
    ((3, 5, 19, 37, 24, 300), 0.05, 0.5)])          # unaligned, annealed
def test_cuda_b1_backward_kernel_matches_both_plain_versions(
        cuda_kernels, shape, epsilon, eps_init):
    """B1''s kernel (one fused_pool_cost_match_backward launch, one backward
    call) against its explicit plain version on the same inputs and
    against autograd through the plain forward: X within 2e-4, each
    gradient within 1e-3 of its largest entry; padded rows and columns in
    every case."""
    from dmm_net_tpu_torch.kernels.matcher import pool_cost_match_backward_plain
    gen = torch.Generator(device="cuda").manual_seed(5)
    arrs = _matcher_problem(gen, *shape)
    gX = torch.randn(*shape[:3], device="cuda", generator=gen)
    kw = dict(epsilon=epsilon, iters=30, epsilon_init=eps_init)
    _build.reset_launch_counts()
    Xk, gk = _b1_grads(fused_pool_cost_match, arrs, gX, **kw)
    assert _build.launch_counts()["fused_pool_cost_match_backward"] == 1
    assert _build.backward_calls()["fused_pool_cost_match"] == 1
    Xp, gp = _b1_grads(pool_cost_match_plain, arrs, gX, **kw)
    assert (Xk - Xp).abs().max().item() <= 2e-4
    _within(gk, gp, 1e-3)
    _within(gk, pool_cost_match_backward_plain(*arrs, gX, **kw), 1e-3)


@pytest.mark.cuda
def test_cuda_b1_backward_skips_unneeded_products_and_repeats_bitwise(cuda_kernels):
    """Two backwards on the same inputs give the same bits; with only emb
    and tmpl_feats requiring a gradient (as in the DMM's train step at
    t = 0) the other inputs get none."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    arrs = _matcher_problem(gen, 4, 8, 64, 448, 256, 4096)
    gX = torch.randn(4, 8, 64, device="cuda", generator=gen)
    runs = [_b1_grads(fused_pool_cost_match, arrs, gX, epsilon=0.03)[1]
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    emb, tf = arrs[0].clone().requires_grad_(True), arrs[4].clone().requires_grad_(True)
    X = fused_pool_cost_match(emb, *arrs[1:4], tf, *arrs[5:], epsilon=0.03)
    X.backward(gX)
    assert torch.equal(emb.grad, runs[0][0]) and torch.equal(tf.grad, runs[0][4])
    assert all(a.grad is None for a in arrs[1:4])


@pytest.mark.cuda
def test_cuda_b1_backward_keeps_a_nan_as_its_plain_version(cuda_kernels):
    """A NaN in B1's embedding reaches the five gradients where autograd
    through the plain version puts one, and only there."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    arrs = list(_matcher_problem(gen, 4, 16, 128, 448, 256, 4096))
    arrs[0][1, 3, 5] = float("nan")
    gX = torch.randn(4, 16, 128, device="cuda", generator=gen)
    (_, gk), (_, gp) = (_b1_grads(fn, arrs, gX)
                        for fn in (fused_pool_cost_match, pool_cost_match_plain))
    for a, b in zip(gk, gp):
        assert torch.isnan(b).any()
        assert torch.equal(torch.isnan(a), torch.isnan(b))


@pytest.mark.cuda
def test_cuda_b1_rejects_sizes_beyond_its_kernels(cuda_kernels):
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in [(1, 65, 8, 16, 8, 64), (1, 4, 1025, 16, 8, 64)]:
        with pytest.raises(ValueError, match="outside"):
            fused_pool_cost_match(*_matcher_problem(gen, *shape))


# B1''s sweep geometry as csrc/matcher.cu chooses it (read through
# matcher.sweep_geometry); the next test runs the kernel at each edge.

@pytest.mark.cuda
@pytest.mark.parametrize("M,N,want", [
    (8, 64, (2, 1)),         # p5_train: two warps, 8 pairs a thread
    (16, 128, (4, 1)),       # p3
    (32, 256, (8, 1)),       # p4: one block at its most threads
    (32, 257, (5, 2)),       # past it: a cluster of two
    (16, 512, (16, 1)),
    (16, 513, (9, 2)),
    (8, 1024, (32, 1)),      # 8 rows: one block of 1024 threads
    (64, 256, (8, 1)),
    (64, 800, (7, 4)),
    (64, 1024, (8, 4)),
    (9, 64, (2, 1)),         # 16 rows from M = 9
    (4, 16, (1, 1)),         # one warp: its passes meet no barrier
    (1, 1, (1, 1))])
def test_cuda_b1_sweep_geometry_at_its_edges(cuda_kernels, M, N, want):
    from dmm_net_tpu_torch.kernels.matcher import sweep_geometry
    assert sweep_geometry(M, N) == want


@pytest.mark.cuda
def test_cuda_b1_sweep_geometry_holds_every_size(cuda_kernels):
    """For every M, N the kernel takes: the threads own all N columns, a
    block stays within the most threads that M's rows allow (1024 for 8
    rows, 512 for 16, 256 past), a cluster within 8 blocks, and no smaller
    cluster would do."""
    from dmm_net_tpu_torch.kernels.matcher import _MAX_M, _MAX_N, sweep_geometry
    for M in range(1, _MAX_M + 1):
        most = 1024 if M <= 8 else 512 if M <= 16 else 256
        for N in range(1, _MAX_N + 1):
            warps, cluster = sweep_geometry(M, N)
            assert cluster * warps * 32 >= N
            assert 32 * warps <= most and 1 <= cluster <= 8
            assert cluster == 1 or (cluster - 1) * most < N
    with pytest.raises(ValueError, match="limits"):
        sweep_geometry(65, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,epsilon,iters", [
    ((2, 16, 512, 64, 32, 256), 0.05, 30),    # the most columns one block of 16 rows holds
    ((2, 16, 513, 64, 32, 256), 0.05, 30),    # one more: a cluster of two blocks
    ((2, 32, 256, 64, 32, 256), 0.05, 30),    # p4's block at its most threads
    ((2, 32, 257, 64, 32, 256), 0.05, 30),    # a cluster of two
    ((1, 64, 800, 64, 32, 256), 0.05, 30),    # a cluster of four (B1's forward holds
                                              # C in shared memory: M x N under ~56K)
    ((2, 9, 300, 64, 32, 256), 0.03, 30),     # 16 rows; N > 256, not a multiple of 32
    ((2, 8, 1024, 64, 32, 256), 0.03, 30),    # 8 rows: one block of 32 warps
    ((3, 4, 19, 37, 24, 300), 0.03, 30),      # one warp: no barrier
    ((2, 64, 40, 64, 32, 256), 0.05, 400),    # the duals' history in several chunks
    ((3, 33, 100, 37, 24, 300), 0.05, 0)])    # no iteration; 64 rows, unaligned
def test_cuda_b1_backward_at_the_edges_of_its_geometry(cuda_kernels, shape, epsilon, iters):
    """B1''s sweep where its geometry (the tests above) changes: the
    warps a block takes, a cluster of blocks, columns past 256 and not a
    multiple of 32, the duals' history staged in chunks; X within 2e-4 and
    each gradient within 1e-3 of its largest entry against both plain
    versions, and two backwards bit-equal."""
    from dmm_net_tpu_torch.kernels.matcher import pool_cost_match_backward_plain
    gen = torch.Generator(device="cuda").manual_seed(7)
    arrs = _matcher_problem(gen, *shape)
    gX = torch.randn(*shape[:3], device="cuda", generator=gen)
    kw = dict(epsilon=epsilon, iters=iters)
    Xk, gk = _b1_grads(fused_pool_cost_match, arrs, gX, **kw)
    _, gk2 = _b1_grads(fused_pool_cost_match, arrs, gX, **kw)
    assert all(torch.equal(a, b) for a, b in zip(gk, gk2))
    Xp, gp = _b1_grads(pool_cost_match_plain, arrs, gX, **kw)
    assert (Xk - Xp).abs().max().item() <= 2e-4
    _within(gk, gp, 1e-3)
    _within(gk, pool_cost_match_backward_plain(*arrs, gX, **kw), 1e-3)


def _roi_grads(fn, levels, boxes, g, out_size):
    xs = [t.clone().requires_grad_(True) for t in levels]
    return torch.autograd.grad(fn(xs, boxes, out_size, 2), xs, g)


def _edge_boxes(H=256, W=448):
    """Boxes on each of the four levels, at the image's border and past it,
    and degenerate (under 1e-3 wide and high)."""
    return torch.tensor([[10, 12, 60, 70], [0, 0, 120, 100], [300, 100, 448, 256],
                         [-20, -10, 200, 250], [0, 0, 448, 256], [447, 255, 448, 256],
                         [50, 60, 50.0005, 60.0005], [440, 0, 460, 30],
                         [100, 80, 100.0002, 200], [-200, -200, 600, 500]],
                        device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 10, 32, 128])
@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
def test_cuda_b4_backward_kernel_matches_both_plain_versions(cuda_kernels, K, out_size):
    """B4''s kernel (one roi_align_backward launch, one backward call)
    against its explicit plain version and against autograd through the
    plain forward at the full-width detector's pyramid (C=256), 1e-4
    relative per level; K = 10 is the edge boxes, K = 0 launches nothing
    and gives zeros."""
    from dmm_net_tpu_torch.kernels.roi_align import multilevel_roi_align_backward_plain
    gen = torch.Generator(device="cuda").manual_seed(K + out_size[0])
    levels = _pyramid(gen)
    boxes = _edge_boxes() if K == 10 else _boxes(gen, K, 256, 448)
    g = torch.randn(K, 256, *out_size, device="cuda", generator=gen)
    _build.reset_launch_counts()
    got = _roi_grads(multilevel_roi_align, levels, boxes, g, out_size)
    assert _build.launch_counts()["roi_align_backward"] == (K > 0)
    assert _build.backward_calls()["roi_align"] == 1
    if K == 0:
        assert all(t.shape == f.shape and not t.any() for t, f in zip(got, levels))
        return
    wants = (_roi_grads(multilevel_roi_align_plain, levels, boxes, g, out_size),
             multilevel_roi_align_backward_plain(levels, boxes, g, out_size, 2))
    for want in wants:
        for a, b in zip(got, want):         # a level no box is on has no gradient
            assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-30)


def _one_tile_boxes(gen, K):
    """K boxes on p3 (sides 120-210 px) around one point of the 256x448
    image, so that every one of them reaches the same p3 tiles."""
    side = 120 + torch.rand(K, 1, device="cuda", generator=gen) * 90
    c = torch.tensor([[200.0, 120.0]], device="cuda")
    return torch.cat([c - side / 2, c + side / 2], 1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_tile_300", "image_480x864", "border_and_whole",
                                  "K_37"])
@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
def test_cuda_b4_backward_at_the_edges_of_its_geometry(cuda_kernels, case, out_size):
    """B4''s gather where its geometry changes: 300 boxes on one tile (more
    than a listing chunk of 256), a 480x864 pyramid (other tile counts per
    level), boxes on and past the border and covering a whole level, K not a
    multiple of the chunk; against both plain
    versions (1e-4 relative per level), two backwards bit-equal."""
    from dmm_net_tpu_torch.kernels.roi_align import multilevel_roi_align_backward_plain
    gen = torch.Generator(device="cuda").manual_seed(11)
    image = (480, 864) if case == "image_480x864" else (256, 448)
    levels = _pyramid(gen, C=64, image=image)
    boxes = {"one_tile_300": lambda: _one_tile_boxes(gen, 300),
             "image_480x864": lambda: _boxes(gen, 64, *image),
             "border_and_whole": _edge_boxes,
             "K_37": lambda: _boxes(gen, 37, *image)}[case]()
    g = torch.randn(boxes.shape[0], 64, *out_size, device="cuda", generator=gen)
    got = _roi_grads(multilevel_roi_align, levels, boxes, g, out_size)
    again = _roi_grads(multilevel_roi_align, levels, boxes, g, out_size)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    wants = (_roi_grads(multilevel_roi_align_plain, levels, boxes, g, out_size),
             multilevel_roi_align_backward_plain(levels, boxes, g, out_size, 2))
    for want in wants:
        for a, b in zip(got, want):
            assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-30)


@pytest.mark.cuda
def test_cuda_b4_backward_repeats_bitwise_and_carries_a_nan(cuda_kernels):
    """Two backwards give the same bits (each level pixel sums its boxes in
    box order, no atomics). A NaN in one box's upstream gradient reaches
    that box's taps, and only pixels where the plain version (whose dense
    products spread it over the level's channel) has one."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    levels, boxes = _pyramid(gen), _boxes(gen, 128, 256, 448)
    g = torch.randn(128, 256, 14, 14, device="cuda", generator=gen)
    a, b = (_roi_grads(multilevel_roi_align, levels, boxes, g, (14, 14)) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    k = int(torch.argmax((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])))
    g[k, 7, 3, 4] = float("nan")
    got = _roi_grads(multilevel_roi_align, levels, boxes, g, (14, 14))
    want = _roi_grads(multilevel_roi_align_plain, levels, boxes, g, (14, 14))
    from dmm_net_tpu_torch.kernels.roi_align import fpn_levels
    l = int(fpn_levels(boxes[k:k + 1])[0])
    assert torch.isnan(got[l][7]).any()
    for x, y in zip(got, want):
        assert not (torch.isnan(x) & ~torch.isnan(y)).any()


@pytest.mark.cuda
def test_cuda_b4_backward_rejects_sizes_beyond_its_kernel(cuda_kernels):
    from dmm_net_tpu_torch.kernels.roi_align import _launch_backward
    gen = torch.Generator(device="cuda").manual_seed(3)
    levels, boxes = _pyramid(gen, C=8), _boxes(gen, 4, 256, 448)
    lvl = torch.zeros(4, dtype=torch.int32, device="cuda")
    shapes = [tuple(f.shape) for f in levels]
    for oh, ow, s in [(17, 7, 2), (7, 7, 5)]:
        with pytest.raises(ValueError, match="limits"):
            _launch_backward(shapes, boxes, lvl, torch.zeros(4, 8, oh, ow, device="cuda"),
                             oh, ow, s)
    with pytest.raises(ValueError, match="expected"):
        _launch_backward(shapes, boxes, lvl, torch.zeros(4, 8, 7, 7, device="cuda",
                                                         dtype=torch.float64), 7, 7, 2)


def _dcn_detector(device, **kw):
    from dmm_net_tpu_torch.models.proposal import MaskRCNN
    det = MaskRCNN(deform_stages=("c3", "c4", "c5"), device=device, seed=8, **kw)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for name, p in det.named_parameters():
            if ".offset_conv." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return det


def _detection_batch(H, W, C, seeds, device):
    from dmm_net_tpu_torch.data.synthetic import synthetic_detection_frame
    from dmm_net_tpu_torch.train.proposal_loop import (proposal_batch_to,
                                                       stack_detection_frames)
    return proposal_batch_to(stack_detection_frames(
        [synthetic_detection_frame(seed=s, H=H, W=W, max_objects=4, num_classes=C)
         for s in seeds]), device)


@pytest.mark.cuda
def test_cuda_dcn_detector_matches_cpu(cuda_kernels):
    """The small DCNv2 detector (R-18 64x128, 8 classes, c3..c5
    deformable, non-zero offset predictors) on the card and on the CPU from
    the same weights and inputs: the same detections and batch loss (1e-4)."""
    from dmm_net_tpu_torch.train.proposal_loop import make_proposal_batch_loss
    small = dict(image_size=(64, 128), backbone_name="resnet18", num_classes=8,
                 pre_nms_top_n=64, post_nms_top_n=32, max_detections=16)
    res = {}
    for dev in ("cuda", "cpu"):
        det = _dcn_detector(dev, **small)
        batch = _detection_batch(64, 128, 8, (0, 1), dev)
        with torch.no_grad():
            out = det(batch["images"][:1].permute(0, 3, 1, 2))
        loss, _ = make_proposal_batch_loss(det.trainable_())(batch)
        res[dev] = ({k: v.cpu() for k, v in out.items()}, loss.item())
    (a, la), (c, lc) = res["cuda"], res["cpu"]
    assert c["valid"].any()
    assert torch.equal(a["valid"], c["valid"]) and torch.equal(a["classes"], c["classes"])
    assert (a["boxes"] - c["boxes"]).abs().max() <= 1e-3
    assert (a["scores"] - c["scores"]).abs().max() <= 1e-4
    assert (a["masks"] - c["masks"]).abs().max() <= 1e-4
    assert abs(la - lc) <= 1e-4 * abs(lc)


@pytest.mark.cuda
def test_cuda_dcn_detector_trains_at_full_width(cuda_kernels):
    """The full-width DCNv2 detector (R-50-FPN, 81 classes, 256x448, batch
    2) takes two train steps with every loss part finite, B4 launched and
    B4' called twice per image per step."""
    from dmm_net_tpu_torch.train.proposal_loop import (make_proposal_optimizer,
                                                       make_proposal_train_step)
    det = _dcn_detector("cuda", pre_nms_top_n=64, post_nms_top_n=32,
                        max_detections=16).trainable_()
    step = make_proposal_train_step(det, make_proposal_optimizer(det, 1e-4))
    batch = _detection_batch(256, 448, 81, (11, 12), "cuda")
    _build.reset_launch_counts()
    for _ in range(2):
        m = step(batch)
        assert all(torch.isfinite(v) for v in m.values())
    assert _build.launch_counts()["roi_align"] == 8
    assert _build.backward_calls()["roi_align"] == 8


@pytest.mark.cuda
def test_cuda_mesh_train_step_two_ranks_share_the_card(cuda_kernels):
    """Two ranks on one card (gloo), B1 and B1' on the card, train-mode BN
    with global statistics through remat (chip_smoke.py 10b's small
    configuration): one process's loss, every gradient leaf (to 1e-4 of its
    largest entry) and BN running statistics (1e-5) on the whole batch,
    with valid counts 1 and 2 in the halves."""
    import numpy as np

    import chip_smoke as cs
    import torch_port_ranks as ranks
    from dmm_net_tpu_torch.parallel import launch
    from dmm_net_tpu_torch.train.loop import (batch_to, create_train_state,
                                              make_train_step)

    cfg = cs.mesh_p5_config(small=True)
    batch = cs.mesh_p5_batch(small=True)
    r0, r1 = launch(ranks.dmm_steps, 2, "cuda", cfg.to_dict(), None, batch, 1,
                    "cuda")
    state = create_train_state(cfg, seed=0, device="cuda")
    grads = {}
    update = state.optimizer.update
    state.optimizer.update = lambda gs: (grads.update(zip(
        [n for n, _ in state.model.named_parameters()], gs)), update(gs))
    m = make_train_step(cfg)(state, batch_to(batch, "cuda"))
    assert r0["loss"] == r1["loss"]
    assert abs(r0["loss"][0] - float(m["loss"])) <= 1e-4 * abs(float(m["loss"]))
    for n, g in grads.items():
        g = g.cpu().numpy()
        assert np.abs(r0["grads"][n] - g).max() <= 1e-4 * np.abs(g).max() + 1e-12, n
    for k, v in state.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(r0["bn_stats_1"][k], v.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.cuda
def test_cuda_mesh_engine_two_ranks_share_the_card(cuda_kernels):
    """p3's path (B1, B2) at R-18 64x96 on two ranks sharing the card: the
    whole batch's labels on both ranks, equal to one process's except on
    ties (mismatch < 1e-3), and the refusal of an odd batch."""
    import numpy as np

    import torch_port_ranks as ranks
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.parallel import launch

    cfg = preset("p3_multi_object").override(**{
        "model.backbone": "resnet18", "model.image_size": (64, 96),
        "matching.max_templates": 4, "matching.max_proposals": 8})
    rng = np.random.RandomState(0)
    B, T, H, W = 4, 4, 64, 96
    frames = rng.randint(0, 256, (T, B, H, W, 3)).astype(np.uint8)
    tmpl = (rng.rand(B, 4, H, W) > 0.7).astype(np.float32)
    valid = np.zeros((B, 4), bool)
    valid[:2, :1] = True
    valid[2:, :3] = True
    items = [{"frame": frames[t],
              "prop_boxes": np.tile(np.array([[4, 4, 60, 40]], np.float32),
                                    (B, 8, 1)) + rng.rand(B, 8, 4).astype(np.float32) * 8,
              "prop_masks28": (rng.rand(B, 8, 28, 28) > 0.4).astype(np.float32),
              "prop_valid": rng.rand(B, 8) > 0.2} for t in range(T)]
    r0, r1 = launch(ranks.engine_run, 2, "cuda", cfg.to_dict(), None, items,
                    tmpl, valid, frames[0], 2, "cuda")
    want = InferenceEngine(cfg, seed=0).run_stream_chunked(
        iter(items), tmpl, valid, frames[0], chunk=2)
    np.testing.assert_array_equal(r0["stream"]["labels"], r1["stream"]["labels"])
    assert (r0["stream"]["labels"] != want["labels"]).mean() < 1e-3
    np.testing.assert_allclose(r0["stream"]["assignments"], want["assignments"],
                               atol=5e-2)
    assert r0["refusal"] == "sequence batch 3 not divisible by mesh data axis 2"


@pytest.mark.cuda
def test_cuda_mesh_nccl_across_cards(cuda_kernels):
    """One rank per card over NCCL (two or four cards): the p5_train step at
    full width (float32 backbone, B=4 clips, clip 0 with one valid object)
    against one process on the whole batch on card 0,
    loss and grad norm to 1e-4 relative and every gradient leaf to 1e-4 of
    its largest entry; and the p3 engine's gathered labels against one
    process's (mismatch < 1e-3)."""
    import numpy as np

    import chip_smoke as cs
    import torch_port_ranks as ranks
    from dmm_net_tpu_torch.config import preset
    from dmm_net_tpu_torch.infer.engine import InferenceEngine
    from dmm_net_tpu_torch.parallel import launch

    world = torch.cuda.device_count()
    if world not in (2, 4):
        pytest.skip("needs two or four CUDA devices (the batches hold 4)")
    cfg, batch = cs.mesh_p5_config(f32=True), cs.mesh_p5_batch()
    outs = launch(ranks.dmm_steps, world, "cuda", cfg.to_dict(), None, batch,
                  1, "cuda")
    assert all(o["loss"] == outs[0]["loss"] for o in outs)
    want = cs.mesh_train_run(cfg, batch, 1)
    assert abs(outs[0]["loss"][0] - want["loss"][0]) <= 1e-4 * abs(want["loss"][0])
    assert abs(outs[0]["grad_norm"][0] - want["grad_norm"][0]) <= \
        1e-4 * abs(want["grad_norm"][0])
    for n, g in zip(want["names"], want["grads"]):
        g = g.cpu().numpy()
        assert np.abs(outs[0]["grads"][n] - g).max() <= 1e-4 * np.abs(g).max() + 1e-12, n

    p3, (frames, tmpl, valid, items) = cs.mesh_engine_inputs()
    items = items[:8]
    r = launch(ranks.engine_run, world, "cuda", p3.to_dict(), None, items,
               tmpl, valid, frames[0], 8, "cuda")
    single = InferenceEngine(p3, seed=0).run_stream_chunked(
        iter(items), tmpl, valid, frames[0], chunk=8)
    for o in r:
        assert (o["stream"]["labels"] != single["labels"]).mean() < 1e-3
