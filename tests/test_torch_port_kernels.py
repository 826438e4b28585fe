"""The port's matcher and resolve kernels (dmm_net_tpu_torch/kernels)
against the JAX package's Pallas kernels run in interpret mode and their jnp
references (ROI-Align, kernel B4, is in tests/test_torch_port_proposal.py).

On the CPU each wrapper runs its kernel's plain PyTorch version (the CUDA
kernels cannot run here); tests/test_torch_port_cuda.py holds the CUDA
kernels against those plain versions on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmm_net_tpu.kernels.matcher import fused_cost_match as jax_fcm
from dmm_net_tpu.kernels.matcher import fused_pool_cost_match as jax_fpcm
from dmm_net_tpu.kernels.resolve import (
    _interp_matrix as jax_interp_matrix,
    fused_resolve_upsample as jax_resolve,
    resolve_upsample_jnp,
)
from dmm_net_tpu_torch.kernels import launch_counts, reset_launch_counts
from dmm_net_tpu_torch.kernels.matcher import (cost_match_plain,
                                               fused_cost_match,
                                               fused_pool_cost_match,
                                               pool_cost_match_plain)
from dmm_net_tpu_torch.kernels.roi_align import roi_align
from dmm_net_tpu_torch.kernels.resolve import (_interp_matrix, _pair_taps,
                                               _taps, band_windows,
                                               fused_resolve_upsample,
                                               resolve_upsample_plain,
                                               tile_windows)


def _matcher_problem(seed, B, M, N, P, D, Pc, n_rows, n_cols):
    rng = np.random.RandomState(seed)
    emb = rng.randn(B, P, D).astype(np.float32)
    pm_pool = (rng.rand(B, N, P) > 0.6).astype(np.float32)
    tm_cost = (rng.rand(B, M, Pc) > 0.6).astype(np.float32)
    pm_cost = (rng.rand(B, N, Pc) > 0.6).astype(np.float32)
    tf = rng.randn(B, M, D).astype(np.float32)
    rm = np.zeros((B, M), bool)
    rm[:, :n_rows] = True
    cm = np.zeros((B, N), bool)
    cm[:, :n_cols] = True
    return emb, pm_pool, tm_cost, pm_cost, tf, rm, cm


@pytest.mark.parametrize("shape,eps_init", [
    # (B, M, N, P, D, Pc, valid rows, valid cols): unaligned sizes
    ((2, 5, 19, 37, 24, 300, 3, 11), None),
    ((2, 5, 19, 37, 24, 300, 3, 11), 0.5),
    ((1, 3, 140, 21, 16, 130, 3, 133), None),     # N > 128
])
def test_pool_cost_match_plain_matches_pallas_interpret(shape, eps_init):
    *dims, n_rows, n_cols = shape
    B, M, N, P, D, Pc = dims
    arrs = _matcher_problem(0, B, M, N, P, D, Pc, n_rows, n_cols)
    want = np.asarray(jax_fpcm(*map(jnp.asarray, arrs), epsilon=0.05,
                               iters=30, interpret=True,
                               epsilon_init=eps_init))
    got = fused_pool_cost_match(*map(torch.from_numpy, arrs), epsilon=0.05,
                                iters=30, epsilon_init=eps_init).numpy()
    # f32 sums in another order through 30 Sinkhorn iterations
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert (got[:, n_rows:] == 0).all()
    assert (got[:, :, n_cols:] == 0).all()
    np.testing.assert_allclose(got[:, :n_rows].sum(-1), 1.0, atol=1e-4)


def test_wrappers_take_plain_version_on_cpu_without_launching():
    arrs = _matcher_problem(1, 1, 4, 8, 16, 8, 64, 2, 6)
    t = list(map(torch.from_numpy, arrs))
    reset_launch_counts()
    X = fused_pool_cost_match(*t)
    np.testing.assert_array_equal(X.numpy(), pool_cost_match_plain(*t).numpy())
    lg = torch.randn(1, 3, 8, 8)
    v = torch.ones(1, 3, dtype=torch.bool)
    torch.testing.assert_close(fused_resolve_upsample(lg, v, (32, 32)),
                               resolve_upsample_plain(lg, v, (32, 32)))
    tm, pm, tf, pf, rm, cm = map(torch.from_numpy, _cost_problem(1, B=1, M=3, N=9, n=7))
    np.testing.assert_array_equal(fused_cost_match(tm, pm, tf, pf, rm, cm).numpy(),
                                  cost_match_plain(tm, pm, tf, pf, rm, cm).numpy())
    assert roi_align(torch.randn(4, 8, 8), torch.tensor([[1.0, 1, 5, 6]])).shape \
        == (1, 4, 7, 7)
    assert launch_counts() == {"fused_pool_cost_match": 0,
                               "fused_resolve_upsample": 0,
                               "fused_cost_match": 0, "roi_align": 0,
                               "fused_pool_cost_match_backward": 0,
                               "roi_align_backward": 0}


def _cost_problem(seed, B=2, M=8, N=64, P=256, D=64, m=3, n=20):
    """tests/test_pallas_matcher.py's planted problem: template i copies a
    proposal's mask and a lightly noised copy of its feature, so the optimum
    is well separated."""
    rng = np.random.RandomState(seed)
    tm = np.zeros((B, M, P), np.float32)
    pm = np.zeros((B, N, P), np.float32)
    tf = np.zeros((B, M, D), np.float32)
    pf = np.zeros((B, N, D), np.float32)
    for b in range(B):
        pm[b, :n] = (rng.rand(n, P) > 0.7).astype(np.float32)
        pf[b, :n] = rng.randn(n, D).astype(np.float32)
        pick = rng.permutation(n)[:m]
        tm[b, :m] = pm[b, pick]
        tf[b, :m] = pf[b, pick] + 0.05 * rng.randn(m, D).astype(np.float32)
    rm = np.zeros((B, M), bool)
    rm[:, :m] = True
    cm = np.zeros((B, N), bool)
    cm[:, :n] = True
    return tm, pm, tf, pf, rm, cm


@pytest.mark.parametrize("seed,dims", [
    (0, dict()),                                               # aligned
    (1, dict(B=1, M=5, N=37, P=100, D=48, m=2, n=11)),        # unaligned
    (2, dict(B=1, M=32, N=256, P=256, D=64, m=13, n=70)),     # p4's M, N
])
def test_cost_match_plain_matches_pallas_interpret(seed, dims):
    arrs = _cost_problem(seed, **dims)
    want = np.asarray(jax_fcm(*map(jnp.asarray, arrs), epsilon=0.05, iters=30,
                              iou_weight=0.3, interpret=True))
    got = fused_cost_match(*map(torch.from_numpy, arrs), epsilon=0.05, iters=30,
                           iou_weight=0.3).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    rm, cm = arrs[4], arrs[5]
    assert (got[~rm] == 0).all()
    assert (got.transpose(0, 2, 1)[~cm] == 0).all()


def test_matcher_wrapper_checks_shapes():
    arrs = list(map(torch.from_numpy,
                    _matcher_problem(2, 1, 4, 8, 16, 8, 64, 2, 6)))
    arrs[3] = arrs[3][:, :5]          # prop_masks_cost with the wrong N
    with pytest.raises(ValueError, match="prop_masks_cost"):
        fused_pool_cost_match(*arrs)


@pytest.mark.parametrize("n_in,n_out", [(16, 64), (9, 36), (13, 52), (7, 7),
                                        (28, 112)])
def test_interp_matrix_and_taps(n_in, n_out):
    mat = _interp_matrix(n_in, n_out)
    np.testing.assert_array_equal(mat, jax_interp_matrix(n_in, n_out))
    # the taps rebuild the bf16-rounded matrix exactly
    idx, w = _taps(n_in, n_out)
    rebuilt = np.zeros_like(mat)
    for o in range(n_out):
        for k in range(2):
            rebuilt[idx[o, k], o] += w[o, k]
    want = torch.from_numpy(mat).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(rebuilt, want)
    # so do the neighbour-pair taps the kernel reads
    first, pair = _pair_taps(n_in, n_out)
    assert first.min() >= 0 and first.max() + 1 <= max(n_in - 1, 1)
    rebuilt = np.zeros_like(mat)
    for o in range(n_out):
        for k in range(2):
            rebuilt[min(first[o] + k, n_in - 1), o] += pair[o, k]
    np.testing.assert_array_equal(rebuilt, want)


@pytest.mark.parametrize("h,w,H,W", [(64, 112, 256, 448), (120, 216, 480, 864),
                                     (8, 14, 64, 112), (17, 29, 67, 115),
                                     (7, 7, 7, 7)],
                         ids=["p3", "p3_480p", "8x", "unaligned", "identity"])
@pytest.mark.parametrize("band", [16, 32, 64])
def test_band_windows_hold_every_tap(h, w, H, W, band):
    """Each band of output rows (tile of output columns) reads only input
    rows (columns) inside its window, the window lies inside the input, and
    no window is larger than the size the kernel is given."""
    first = _pair_taps(w, W)[0]
    cases = [(band_windows(h, H, band), _taps(h, H)[0], h),
             (tile_windows(w, W, band), np.stack([first, first + 1], 1), w)]
    for (lo, size), taps, n_in in cases:
        assert lo.shape == (-(-taps.shape[0] // band),) and lo.dtype == np.int32
        assert size <= n_in and (lo >= 0).all() and (lo + size <= n_in).all()
        for k, start in enumerate(lo):
            t = taps[k * band:(k + 1) * band]
            assert (t >= start).all() and (t < start + size).all()
    # at an s-fold upsample a band of n rows reads at most n / s + 2 input
    # rows, and exactly that many at 4x (p3's interior bands)
    for s in (4, 8):
        if (H, W) == (s * h, s * w):
            sizes = band_windows(h, H, band)[1], tile_windows(w, W, band)[1]
            assert max(sizes) <= band // s + 2
            assert s != 4 or sizes == (band // 4 + 2,) * 2


def _logits(seed, B, M, h, w):
    rng = np.random.RandomState(seed)
    lg = (rng.randn(B, M, h, w) * 3.0).astype(np.float32)
    valid = rng.rand(B, M) > 0.3
    valid[:, 0] = True
    return lg, valid


@pytest.mark.parametrize("B,M,h,w,H,W", [(2, 5, 16, 28, 64, 112),
                                         (1, 3, 9, 13, 36, 52),
                                         (1, 32, 16, 28, 64, 112),   # p4's M
                                         (2, 5, 17, 29, 67, 115)])   # non-integer scale
def test_resolve_plain_matches_jnp_and_pallas_interpret(B, M, h, w, H, W):
    lg, valid = _logits(B * 7 + h, B, M, h, w)
    got = resolve_upsample_plain(torch.from_numpy(lg), torch.from_numpy(valid),
                                 (H, W)).numpy()
    want_jnp = np.asarray(resolve_upsample_jnp(jnp.asarray(lg),
                                               jnp.asarray(valid), (H, W)))
    want_pl = np.asarray(jax_resolve(jnp.asarray(lg), jnp.asarray(valid),
                                     (H, W), interpret=True))
    assert got.dtype == np.uint8 and got.shape == (B, H, W)
    assert (got != want_jnp).mean() < 1e-3
    assert (got != want_pl).mean() < 1e-3


def test_resolve_invalid_slots_never_win():
    lg = torch.full((1, 4, 8, 8), 5.0)
    lg[0, 1:] = 50.0                   # invalid slots carry the largest logits
    valid = torch.tensor([[True, False, False, False]])
    lab = fused_resolve_upsample(lg, valid, (16, 16))
    assert set(torch.unique(lab).tolist()) == {1}
    none = fused_resolve_upsample(lg, torch.zeros(1, 4, dtype=torch.bool),
                                  (16, 16))
    assert (none == 0).all()
