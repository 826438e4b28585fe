"""The plain versions of the two backward kernels, B1' (the fused matcher's
backward: the Sinkhorn's reverse sweep and the cost's tail) and B4' (the
multi-level ROI-Align's gradient with respect to the four levels), against
the JAX package and against autograd through the port's plain forwards.

On the CPU ``_PoolCostMatch.backward`` runs ``pool_cost_match_backward_plain``
and ``_MultilevelRoiAlign.backward`` runs ``multilevel_roi_align_backward_plain``;
on the card each launches its kernel, which tests/test_torch_port_cuda.py and
chip_smoke.py (phases 7a and 9a) hold against these plain versions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmm_net_tpu.kernels.matcher import fused_pool_cost_match as jax_fpcm
from dmm_net_tpu.models.proposal.maskrcnn import \
    _multilevel_roi_align as jax_multilevel_roi_align
from dmm_net_tpu_torch.kernels import (backward_calls, launch_counts,
                                       reset_launch_counts)
from dmm_net_tpu_torch.kernels.matcher import (fused_pool_cost_match,
                                               pool_cost_match_backward_plain)
from dmm_net_tpu_torch.kernels.roi_align import (fpn_levels, multilevel_roi_align,
                                                 multilevel_roi_align_backward_plain,
                                                 multilevel_roi_align_plain)
from dmm_net_tpu_torch.ops.matching import sinkhorn_duals
from dmm_net_tpu_torch.ops.pool_cost import pool_cost_sinkhorn
from tests.test_torch_port_proposal import _nchw, _rel, multilevel_problem


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module's tests run, so that the test
    runner's workers do not oversubscribe the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B1_NAMES = ("emb", "prop_masks_pool", "tmpl_masks_cost", "prop_masks_cost",
            "tmpl_feats")


def _b1_problem(seed=0, B=2, M=4, N=16, P=64, D=32, Pc=256):
    """tests/test_torch_port_train_kernel.py's inputs: soft cost masks (so
    every mask input has a gradient), 3 of 4 rows and 10 of 16 columns
    valid, and an upstream gradient W."""
    rng = np.random.RandomState(seed)
    emb = rng.randn(B, P, D).astype(np.float32)
    pm_pool = (rng.rand(B, N, P) > 0.6).astype(np.float32)
    tm_cost = rng.rand(B, M, Pc).astype(np.float32)
    pm_cost = rng.rand(B, N, Pc).astype(np.float32)
    tf = rng.randn(B, M, D).astype(np.float32)
    rm = np.zeros((B, M), bool)
    rm[:, :3] = True
    cm = np.zeros((B, N), bool)
    cm[:, :10] = True
    W = rng.randn(B, M, N).astype(np.float32)
    return [emb, pm_pool, tm_cost, pm_cost, tf, rm, cm], W


@pytest.fixture(scope="module")
def jax_b1_grads():
    """jax.grad of sum(X * W) through the JAX fused kernel (interpret mode;
    its custom VJP differentiates the jnp reference), jitted once per
    schedule."""
    (emb, ppool, tm, pm, tf, rm, cm), W = _b1_problem()
    fns = {}

    def grads(epsilon, eps_init):
        if (epsilon, eps_init) not in fns:
            def loss(*floats):
                X = jax_fpcm(*floats, jnp.asarray(rm), jnp.asarray(cm),
                             epsilon=epsilon, iters=30, epsilon_init=eps_init,
                             interpret=True)
                return jnp.sum(X * W)
            fns[epsilon, eps_init] = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))
        return [np.asarray(g) for g in fns[epsilon, eps_init](
            *map(jnp.asarray, (emb, ppool, tm, pm, tf)))]

    return grads


@pytest.mark.parametrize("epsilon,eps_init", [(0.1, None), (0.03, 0.2)])
def test_b1_backward_plain_matches_jax_fused_grads(jax_b1_grads, epsilon, eps_init):
    """The explicit plain B1' equals JAX's gradients at atol 1e-5, as
    autograd through the plain version does
    (tests/test_torch_port_train_kernel.py)."""
    arrs, W = _b1_problem()
    got = pool_cost_match_backward_plain(*map(torch.from_numpy, arrs),
                                         torch.from_numpy(W), epsilon=epsilon,
                                         iters=30, epsilon_init=eps_init)
    for name, g, w in zip(B1_NAMES, got, jax_b1_grads(epsilon, eps_init)):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=name)


def _b1_case(case):
    """float64 inputs of one edge case; the upstream gradient last."""
    arrs, W = _b1_problem(1)
    arrs = [a.astype(np.float64) if a.dtype == np.float32 else a for a in arrs]
    emb, ppool, tm, pm, tf, rm, cm = arrs
    kw = dict(epsilon=0.05, iters=30, epsilon_init=None)
    if case == "column_cap":               # 4 valid columns: the cap binds on some
        cm[:, 4:] = False
    elif case == "no_valid_pair":          # element 1: valid rows, no valid column
        cm[1] = False
    elif case == "no_valid_row":
        rm[1] = False
    elif case == "empty_pooling_mask":     # proposal 2 covers no embedding pixel
        ppool[0, 2] = 0.0
    elif case == "annealed":
        kw.update(epsilon=0.03, epsilon_init=0.5)
    elif case == "no_iterations":
        kw.update(iters=0)
    elif case == "small_epsilon":
        kw.update(epsilon=0.01, iters=50)
    return arrs, W.astype(np.float64), kw


B1_CASES = ["padded", "column_cap", "no_valid_pair", "no_valid_row", "empty_pooling_mask",
            "annealed", "no_iterations", "small_epsilon"]


@pytest.mark.parametrize("case", B1_CASES)
def test_b1_backward_plain_matches_autograd_in_float64(case):
    """The explicit plain B1' against autograd through the plain forward's
    function (``ops.pool_cost.pool_cost_sinkhorn``, which
    ``pool_cost_match_plain`` runs in float32), both in float64, within
    1e-10 of each gradient's largest entry. Every case has padded rows and
    columns; "column_cap" also checks that the column cap binds on some
    valid column and not on others, so both branches of its gradient are
    taken ("padded": it binds on every one). The clip of the logits at 30
    cannot bind: the final f is a row log-sum-exp over the same g, so
    f + g - C <= 0 on every valid pair (checked here); its branch follows
    autograd's rule."""
    arrs, W, kw = _b1_case(case)
    t = [torch.from_numpy(a) for a in arrs]
    xs = [a.clone().requires_grad_(True) for a in t[:5]]
    X = pool_cost_sinkhorn(*xs, *t[5:], kw["epsilon"], kw["iters"], 0.3,
                           kw["epsilon_init"]).X
    want = torch.autograd.grad(X, xs, torch.from_numpy(W))
    got = pool_cost_match_backward_plain(*t, torch.from_numpy(W), **kw)
    for name, g, w in zip(B1_NAMES, got, want):
        assert g.dtype == torch.float64, name
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 1e-10 * scale, name
    rm, cm = t[5], t[6]
    pair = rm[..., :, None] & cm[..., None, :]
    if case in ("no_valid_pair", "no_valid_row"):
        assert not pair[1].any() and all(not g[1].any() for g in got)
    if case == "empty_pooling_mask":
        assert got[0].abs().max() > 0 and not got[1][0, 2].isnan().any()
    if case in ("padded", "column_cap"):
        C = pool_cost_sinkhorn(*t[:5], rm, cm, kw["epsilon"], kw["iters"], 0.3).C
        f, g = sinkhorn_duals(C, rm, cm, kw["epsilon"], kw["iters"])
        assert (g[cm] == 0).any() and (g[cm] < 0).any() == (case == "column_cap")
        L = (f[..., :, None] + g[..., None, :] - C) / kw["epsilon"]
        assert L[pair].max() <= 1e-9


def test_b1_function_runs_the_plain_backward_on_the_cpu():
    """fused_pool_cost_match's backward on CPU tensors is the explicit plain
    version, bit for bit, with no kernel launch and no backward call
    counted; only inputs that require a gradient get one."""
    arrs, W = _b1_problem(2)
    t = [torch.from_numpy(a) for a in arrs]
    emb, tf = t[0].clone().requires_grad_(True), t[4].clone().requires_grad_(True)
    reset_launch_counts()
    X = fused_pool_cost_match(emb, *t[1:4], tf, *t[5:], epsilon=0.05)
    X.backward(torch.from_numpy(W))
    want = pool_cost_match_backward_plain(*t, torch.from_numpy(W), epsilon=0.05,
                                          needs=(True, False, False, False, True))
    assert want[1] is None and want[2] is None and want[3] is None
    assert torch.equal(emb.grad, want[0]) and torch.equal(tf.grad, want[4])
    assert not any(launch_counts().values()) and not any(backward_calls().values())


@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
def test_b4_backward_plain_matches_jax_vjp(out_size):
    """The explicit plain B4' equals jax.vjp of the reference's
    _multilevel_roi_align (1e-5 relative per level) on boxes that take every
    level, cross the border and fall under one cell."""
    maps, boxes = multilevel_problem(0)
    cot = np.random.RandomState(1).randn(len(boxes), *out_size, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda m: jax_multilevel_roi_align(m, jnp.asarray(boxes),
                                                        out_size),
                     {k: jnp.asarray(v) for k, v in maps.items()})
    (want,) = vjp(jnp.asarray(cot))
    levels = [_nchw(maps[f"p{l}"])[0] for l in (2, 3, 4, 5)]
    assert torch.bincount(fpn_levels(torch.from_numpy(boxes)), minlength=4).min() > 0
    got = multilevel_roi_align_backward_plain(levels, torch.from_numpy(boxes),
                                              _nchw(cot), out_size)
    for l, g in zip((2, 3, 4, 5), got):
        w = np.asarray(want[f"p{l}"])[0]
        assert np.abs(w).max() > 0
        assert _rel(np.moveaxis(g.numpy(), 0, -1), w) < 1e-5, l


@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
def test_b4_backward_plain_matches_jax_vjp_on_one_busy_tile(out_size):
    """The explicit plain B4' equals jax.vjp of the reference's
    _multilevel_roi_align (1e-5 relative per level) where 37 boxes (not a
    multiple of the kernel's listing chunk) of sides 120-210 px around one
    point all reach the same p3 tiles: the gather's busiest case."""
    rng = np.random.RandomState(5)
    maps = {f"p{l}": rng.randn(1, 256 >> l, 512 >> l, 8).astype(np.float32)
            for l in (2, 3, 4, 5)}
    side = 120 + 90 * rng.rand(37, 1)
    boxes = np.concatenate([[200.0, 120.0] - side / 2, [200.0, 120.0] + side / 2],
                           1).astype(np.float32)
    cot = rng.randn(len(boxes), *out_size, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda m: jax_multilevel_roi_align(m, jnp.asarray(boxes),
                                                        out_size),
                     {k: jnp.asarray(v) for k, v in maps.items()})
    (want,) = vjp(jnp.asarray(cot))
    levels = [_nchw(maps[f"p{l}"])[0] for l in (2, 3, 4, 5)]
    assert (fpn_levels(torch.from_numpy(boxes)) == 1).sum() >= 30
    got = multilevel_roi_align_backward_plain(levels, torch.from_numpy(boxes),
                                              _nchw(cot), out_size)
    for l, g in zip((2, 3, 4, 5), got):
        w = np.asarray(want[f"p{l}"])[0]
        if not np.abs(w).max() > 0:
            assert not g.any(), l
            continue
        assert _rel(np.moveaxis(g.numpy(), 0, -1), w) < 1e-5, l


def _b4_boxes(case):
    """Boxes on each of the four levels of a 64x96 image (p2 16x24): inside,
    across and at the border, and degenerate (under 1e-3 wide and high)."""
    if case == "no_boxes":
        return torch.zeros(0, 4)
    rows = [[3, 4, 20, 30], [0, 0, 96, 64], [10, 5, 200, 180], [-5, -5, 60, 50],
            [40, 20, 41, 21], [95, 63, 96, 64], [30, 30, 30.0005, 30.0005],
            [-300, -300, 400, 400], [0, 60, 96, 64.0002], [120, 90, 150, 110],
            [-100, -80, 200, 170]]
    return torch.tensor(rows, dtype=torch.float32)


@pytest.mark.parametrize("case", ["every_level", "no_boxes"])
@pytest.mark.parametrize("out_size", [(3, 2), (7, 7)])
def test_b4_backward_plain_matches_autograd_in_float64(case, out_size):
    """The explicit plain B4' against autograd through the plain forward,
    both in float64, within 1e-12 of each level's largest entry; no boxes
    give zeros."""
    rng = np.random.RandomState(3)
    levels = [torch.tensor(rng.randn(3, 64 >> l, 96 >> l), dtype=torch.float64)
              for l in (2, 3, 4, 5)]
    boxes = _b4_boxes(case)
    if case == "every_level":
        assert torch.bincount(fpn_levels(boxes), minlength=4).min() > 0
    g = torch.tensor(rng.randn(len(boxes), 3, *out_size), dtype=torch.float64)
    got = multilevel_roi_align_backward_plain(levels, boxes, g, out_size)
    xs = [f.clone().requires_grad_(True) for f in levels]
    y = multilevel_roi_align_plain(xs, boxes, out_size)
    want = torch.autograd.grad(y, xs, g, allow_unused=True)
    for a, f, w in zip(got, levels, want):
        assert a.shape == f.shape and a.dtype == torch.float64
        if w is None or case == "no_boxes":
            assert not a.any()
            continue
        assert w.abs().max() > 0
        assert (a - w).abs().max().item() <= 1e-12 * w.abs().max().item()


def test_b4_function_runs_the_plain_backward_on_the_cpu():
    """multilevel_roi_align's backward on CPU tensors is the explicit plain
    version, bit for bit, with no kernel launch and no backward call
    counted."""
    maps, boxes = multilevel_problem(2)
    levels = [_nchw(maps[f"p{l}"])[0].requires_grad_(True) for l in (2, 3, 4, 5)]
    g = torch.from_numpy(np.random.RandomState(4).randn(
        len(boxes), 8, 7, 7).astype(np.float32))
    reset_launch_counts()
    got = torch.autograd.grad(multilevel_roi_align(levels, torch.from_numpy(boxes),
                                                   (7, 7)), levels, g)
    want = multilevel_roi_align_backward_plain(levels, torch.from_numpy(boxes), g,
                                               (7, 7))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(launch_counts().values()) and not any(backward_calls().values())
