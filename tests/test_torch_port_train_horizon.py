"""Both trainers held against the JAX package over a whole schedule, by
teacher forcing: JAX trains once; before each of its steps k the port is
loaded with JAX's state k (parameters, BN statistics, Adam's moments and
count), takes one step on batch k, and is compared with JAX's state
k + 1. Errors cannot build up from step to step this way, so a difference
that appears only at some count shows at that count.

- The DMM (train/loop.py): the example's config
  (examples/train_and_eval_synthetic.py) at test width, R-18 at 64x64,
  ``TrainConfig(lr=3e-4, warmup_steps=4, total_steps=20)`` run for 24
  steps over 3 distinct batches, cycled as the example cycles them: the
  lr-0 first update, the warmup, the cosine to its end and counts past
  ``total_steps``, on both sides of the global-norm clip.
- The detector (train/proposal_loop.py with train_proposal.py's
  ``optax.adamw(lr, 1e-5)``): 8 steps of batch 2 over 4 distinct frames,
  so the two batches cycle four times.

At every step: the loss and the pre-clip gradient norm (the DMM's) to
1e-5 relative, the detector's loss, parts and gradient norm to 1e-4 (as
its reference steps are held); for every parameter leaf its update (state
k + 1 minus state k) within 1e-4 of JAX's update, and Adam's first and
second moments within 1e-4 of JAX's, leaf by leaf; the BN statistics'
change likewise. Updates, not parameters: at lr 3e-4 an update is far
below 1e-4 of a parameter's norm. The norm is the sum of absolute values
over the leaf: a float32 parameter holds its update only to its own
spacing (one ulp of a BN scale near 1 is ~3e-3 of a 3e-5 update), and
where the two updates differ by far less than that, one element now and
then still rounds to the neighbouring float (a one-ulp difference, with a
chance in proportion to the true difference). Summed absolute values
weigh such an element by its expected share; a root of squares weighs one
of them in a 128-element leaf at ~2.5e-4 whatever the true difference.

A step where a ReLU input sits within rounding of zero is a float32
knife edge: a change of the weights by 1e-7 of themselves (about one
float32 spacing) moves some gradient leaf by 1e-3 or more, in JAX as in
the port, and no float32 implementation can be held to 1e-4 there. Both
runs start where none of their steps is one. The DMM takes the seeded
draws of the other port tests (``_randomize``), its loss weights halved
so that the run crosses the clip both ways: from flax's own init at this
width the c4 blocks' gradients are tiny and two of the 24 steps were
knife edges, and with the loss weights at 0.2, 0.25 or 0.3 of the
example's one step was. The detector takes the port's seeded init
(chip_smoke.py's 9c weights); from the gradient test's conditioned draws
JAX's own gradient sat on such an edge at one step.

The JAX state's way into the port is a helper of this file: parameters and
statistics through the weight bridge, optax's mu / nu / count into AdamW's
exp_avg / exp_avg_sq / step by the same leaf map, and the count into the
LambdaLR's last epoch.

As in tests/test_torch_port_train_step.py, both JAX models run the plain
7x7 stem (``s2d_stem=False``): the space-to-depth stem rounds otherwise
and breaks max-pool ties on flat colours differently."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import dmm_net_tpu.models.dmm as jax_dmm
import dmm_net_tpu.models.proposal.maskrcnn as jax_maskrcnn
from dmm_net_tpu.config import (Config, DataConfig, MatchingConfig,
                                ModelConfig, TrainConfig)
from dmm_net_tpu.data.synthetic import synthetic_clip_batch
from dmm_net_tpu.data.synthetic import synthetic_detection_frame as jax_frame
from dmm_net_tpu.models.dmm import DMMNet as JaxDMMNet
from dmm_net_tpu.models.dmm import init_frame_state as jax_init_state
from dmm_net_tpu.train.loop import TrainState as JaxTrainState
from dmm_net_tpu.train.loop import make_optimizer
from dmm_net_tpu.train.loop import make_train_step as jax_make_train_step
from dmm_net_tpu.train.proposal_loop import \
    make_proposal_batch_loss as jax_batch_loss
from dmm_net_tpu_torch.config import config_from_dict
from dmm_net_tpu_torch.models.proposal import MaskRCNN
from dmm_net_tpu_torch.train.loop import (Optimizer, batch_to,
                                          create_train_state, make_train_step,
                                          warmup_cosine_lr)
from dmm_net_tpu_torch.train.proposal_loop import (make_proposal_optimizer,
                                                   make_proposal_train_step,
                                                   proposal_batch_to,
                                                   stack_detection_frames)
from dmm_net_tpu_torch.weights import convert_flax_variables, to_flax_variables
from test_torch_port_detector_train import _SMALL
from test_torch_port_engine import _randomize

DMM_STEPS, DMM_BATCHES = 24, 3
DET_STEPS, DET_FRAMES, DET_LR, DET_SEED = 8, 4, 1e-4, 3
REL = 1e-4          # a leaf's error over JAX's, in summed absolute values
LOSS_REL = 1e-5
DET_LOSS_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module's tests run: the test runner
    puts several workers on the machine's cores, and PyTorch's default of
    one thread per core then oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plain_stems():
    """Both JAX models on the plain 7x7 stem (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_dmm, jax_maskrcnn):
            full = mod.backbone_by_name
            mp.setattr(mod, "backbone_by_name",
                       lambda *a, _f=full, **k: _f(*a, **{**k, "s2d_stem": False}))
        yield


def _copy(tree):
    """A host copy of a JAX tree (the DMM's train step donates its state)."""
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def _named(tree, model):
    """A params-like flax tree -> {port parameter name: numpy array}, its
    names those of ``model``'s parameters."""
    out = {k: v.numpy() for k, v in convert_flax_variables({"params": tree}).items()}
    assert set(out) == {n for n, _ in model.named_parameters()}
    return out


def _l1(x):
    return float(np.abs(x).sum())


def check_close(name, got, want, rel=REL):
    """|got - want| <= rel * |want| in summed absolute values (zero where
    JAX's is zero, up to 1e-12)."""
    want = np.asarray(want, np.float64)
    err = _l1(np.asarray(got, np.float64) - want)
    bound = rel * _l1(want) + 1e-12
    assert err <= bound, f"{name}: error {err:.3e} > {bound:.3e}"


def check_change(name, got, before, after, rel=REL):
    """A change held to JAX's: (got - before) against (after - before)."""
    before = np.asarray(before, np.float64)
    check_close(name, np.asarray(got, np.float64) - before,
                np.asarray(after, np.float64) - before, rel)


def load_adam_state(adamw, named, mu, nu, count):
    """optax's Adam moments and count into the port's AdamW state, leaf by
    leaf through the weight bridge's names."""
    for name, p in named:
        adamw.state[p] = {"step": torch.tensor(float(count)),
                          "exp_avg": torch.from_numpy(mu[name].copy()),
                          "exp_avg_sq": torch.from_numpy(nu[name].copy())}


def snapshot(params, mu, nu, count, model, batch_stats=None):
    """One JAX state under the port's names, copied (the JAX train step
    donates its input state): parameters, moments, count, BN statistics."""
    out = {k: _named(_copy(t), model) for k, t in
           (("params", params), ("mu", mu), ("nu", nu))}
    out["count"] = int(count)
    out["bn"] = ({} if batch_stats is None else
                 {k: v.numpy() for k, v in convert_flax_variables(
                     {"batch_stats": _copy(batch_stats)}).items()})
    return out


def load_snapshot(model, adamw, named, snap):
    """A snapshot into the port's model and AdamW (its BN statistics too
    when it has them, and then strictly)."""
    sd = {n: torch.from_numpy(v.copy()) for n, v in snap["params"].items()}
    sd.update({n: torch.from_numpy(v.copy()) for n, v in snap["bn"].items()})
    model.load_state_dict(sd, strict=bool(snap["bn"]))
    load_adam_state(adamw, named, snap["mu"], snap["nu"], snap["count"])


def check_adam_step(where, named, adamw, s0, s1):
    """Every leaf's update, and its moments after the step, against JAX's
    (snapshots before and after it)."""
    for name, p in named:
        st = adamw.state[p]
        check_change(f"{where} update {name}", p.detach().numpy(),
                     s0["params"][name], s1["params"][name])
        check_close(f"{where} mu {name}", st["exp_avg"].numpy(), s1["mu"][name])
        check_close(f"{where} nu {name}", st["exp_avg_sq"].numpy(), s1["nu"][name])


def _bn_stats(model):
    return {k: v.clone().numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


# ---------------------------------------------------------------------------
# the DMM
# ---------------------------------------------------------------------------

def horizon_config() -> Config:
    """examples/train_and_eval_synthetic.py's config at test width (R-18,
    64x64, feature and decoder widths 16) on a 20-step schedule with a
    4-step warmup, its loss weights halved."""
    return Config(
        name="train_horizon",
        model=ModelConfig(backbone="resnet18", backbone_dtype="float32",
                          feature_dim=16, decoder_dim=16, decoder_obj_dim=16,
                          image_size=(64, 64), template_update="aggregation"),
        matching=MatchingConfig(max_templates=4, max_proposals=8,
                                sinkhorn_iters=15, epsilon=0.03),
        data=DataConfig(dataset="synthetic", batch_size=2, clip_length=3),
        train=TrainConfig(lr=3e-4, warmup_steps=4, total_steps=20,
                          loss_bce_weight=0.5, loss_iou_weight=0.25))


def _adam_state(opt_state):
    """optax chain(clip, adamw(schedule)) state -> (count, mu, nu), the
    schedule's count held equal to Adam's."""
    kinds = (optax.ScaleByAdamState, optax.ScaleByScheduleState)
    leaves = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, kinds)) if isinstance(s, kinds)]
    adam = [s for s in leaves if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1 and len(leaves) == 2
    counts = {int(s.count) for s in leaves}
    assert counts == {int(adam[0].count)}, counts
    return int(adam[0].count), adam[0].mu, adam[0].nu


def test_dmm_steps_match_jax_over_the_schedule(plain_stems):
    """JAX's DMM trains 24 steps from seeded weights (module docstring) on
    3 synthetic_clip_batch batches, cycled; before each of its steps the
    port takes the same step from JAX's state and is held to JAX's next
    state. Two states are held at a time."""
    jcfg = horizon_config()
    batches = [synthetic_clip_batch(seed=s, batch=2, T=3, H=64, W=64,
                                    num_objects=2, num_proposals=8,
                                    pad_objects=4) for s in range(DMM_BATCHES)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jmodel = JaxDMMNet(jcfg, train=True)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jb[0]["frames"][:, 0],
        jb[0]["prop_masks"][:, 0], jb[0]["prop_valid"][:, 0],
        jnp.zeros((2, 4, jcfg.model.feature_dim)), jb[0]["tmpl_valid"],
        jax_init_state(jcfg, jb[0]["tmpl_masks"]))
    variables = _randomize(shapes, 11)
    tx = make_optimizer(jcfg)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), tx=tx,
                          apply_fn=jmodel.apply)
    jax_step = jax_make_train_step(jcfg)

    cfg = config_from_dict(jcfg.to_dict())
    port = create_train_state(cfg, seed=0, device="cpu")
    model, opt = port.model, port.optimizer
    step = make_train_step(cfg)
    named = list(model.named_parameters())
    port_batches = [batch_to(b, "cpu") for b in batches]

    def snap(st):
        count, mu, nu = _adam_state(st.opt_state)
        return snapshot(st.params, mu, nu, count, model, st.batch_stats)

    s0, norms, moved = snap(state), [], []
    for k in range(DMM_STEPS):
        assert s0["count"] == k
        load_snapshot(model, opt.adamw, named, s0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # "step() before optimizer.step()"
            opt.schedule.last_epoch = s0["count"] - 1
            opt.schedule.step()
        got = step(port, port_batches[k % DMM_BATCHES])
        state, want = jax_step(state, jb[k % DMM_BATCHES])
        want = {key: float(v) for key, v in want.items()}
        s1 = snap(state)
        assert abs(float(got["loss"]) - want["loss"]) <= LOSS_REL * want["loss"], k
        assert (abs(float(got["grad_norm"]) - want["grad_norm"])
                <= LOSS_REL * want["grad_norm"]), k
        assert opt.count == s1["count"] == k + 1
        check_adam_step(f"step {k}", named, opt.adamw, s0, s1)
        got_bn = _bn_stats(model)
        assert set(s1["bn"]) == set(got_bn) == set(s0["bn"])
        for name in got_bn:
            check_change(f"step {k} {name}", got_bn[name], s0["bn"][name],
                         s1["bn"][name])
        norms.append(want["grad_norm"])
        moved.append(bool(np.any(s1["params"]["feat_proj.weight"]
                                 != s0["params"]["feat_proj.weight"])))
        s0 = s1
    norms = np.array(norms)
    assert (norms >= 1).any() and (norms < 1).any(), norms    # both sides of the clip
    # lr 0 at count 0 and from count total_steps on
    assert [k for k in range(DMM_STEPS) if moved[k]] == list(
        range(1, jcfg.train.total_steps)), moved


@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 4, 20), (3e-4, 20, 2500),
                                             (3e-4, 20, 4000)])
def test_schedule_is_optax_at_every_count(lr, warmup, total):
    """warmup_cosine_lr equals optax's warmup_cosine_decay_schedule (jitted,
    as the train step runs it) to two float32 spacings of the peak lr at
    every count from 0 to 10% past the end, for this file's schedule and
    the two day-one recipes' (the fallback's 2500 steps and the flagship
    DMM's 4000, both warmup 20)."""
    cfg = Config(train=TrainConfig(lr=lr, warmup_steps=warmup, total_steps=total))
    counts = np.arange(int(total * 1.1) + 1)
    want = np.asarray(jax.jit(jax.vmap(optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(total, warmup + 1))))(jnp.asarray(counts)))
    got = np.array([warmup_cosine_lr(config_from_dict(cfg.to_dict()), int(c))
                    for c in counts], np.float32)
    # XLA's float32 cos and division round otherwise than numpy's by an ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.float32(lr)))


def _ulps_off(got, want):
    """Each element's distance from optax's, in float32 spacings."""
    return (np.abs(got.astype(np.float64) - want)
            / np.spacing(np.abs(want).astype(np.float32)))


def check_against_optax(where, got, want):
    """Parameters in [0.5, 2) after an update against optax's: every
    element within one float32 spacing, and at most 1e-3 of them not
    bit-equal (XLA rounds some of the update's own operations otherwise:
    measured 3e-5 to 3e-4). torch.optim.AdamW's order leaves 1% to 13% of
    them off, by up to 3 spacings, within 3 steps."""
    off = _ulps_off(got, want)
    assert off.max() <= 1, (where, off.max())
    assert (off > 0).mean() <= 1e-3, (where, (off > 0).mean())


@pytest.mark.parametrize("trainer", ["dmm", "detector"])
def test_optimizers_update_as_optax(trainer):
    """The cause the horizon tests found: torch.optim.AdamW scales each
    parameter by 1 - lr * weight_decay in a rounding of its own, which in
    float32 is 1 at the trainers' lr x weight decay (3e-4 x 1e-5, 1e-4 x
    1e-5), so the decay vanished, and it forms the moments by ``lerp``;
    optax adds the decay to the Adam step before the lr scales it. Three
    updates of 65536 parameters in [0.5, 2) with gradients from 1e-10 to
    1e-2 by the port's optimizers (the DMM's ``Optimizer`` at a warmup-free
    schedule, the detector's ``make_proposal_optimizer``), against optax's
    adamw in float32, and the moments to 1e-6 (summed absolute values)."""
    rng = np.random.RandomState(0)
    n = 65536
    p0 = rng.uniform(0.5, 2.0, n).astype(np.float32)
    grads = [(rng.randn(n) * 10.0 ** rng.uniform(-10, -2, n)).astype(np.float32)
             for _ in range(3)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    if trainer == "dmm":
        cfg = config_from_dict(Config(train=TrainConfig(
            lr=3e-4, warmup_steps=0, total_steps=100)).to_dict())
        opt = Optimizer([param], cfg)
        adamw = opt.adamw
        tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 3e-4, 0, 100),
                         weight_decay=cfg.train.weight_decay)

        def update(g):
            opt.update([torch.from_numpy(g)])
    else:
        holder = torch.nn.Module()
        holder.p = param
        adamw = make_proposal_optimizer(holder, DET_LR)
        tx = optax.adamw(DET_LR, weight_decay=1e-5)

        def update(g):
            param.grad = torch.from_numpy(g)
            adamw.step()
    want, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tx_update = jax.jit(tx.update)
    for i, g in enumerate(grads):
        u, state = tx_update(jnp.asarray(g), state, want)
        want = optax.apply_updates(want, u)
        update(g)
        check_against_optax(f"{trainer} step {i}", param.detach().numpy(),
                            np.asarray(want))
        st = adamw.state[param]
        check_close(f"{trainer} mu {i}", st["exp_avg"].numpy(), state[0].mu, 1e-6)
        check_close(f"{trainer} nu {i}", st["exp_avg_sq"].numpy(), state[0].nu, 1e-6)


@pytest.mark.parametrize("count", [1, 19, 20, 2499, 3999, 100000])
def test_adamw_at_late_counts(count):
    """The port's adamw against optax's from the same float32
    moments at large counts (the recipes run 2500 and 4000 steps), with
    gradients of every scale."""
    rng = np.random.RandomState(count)
    n = 65536
    p = rng.uniform(0.5, 2.0, n).astype(np.float32)
    g = (rng.randn(n) * 10.0 ** rng.uniform(-10, -1, n)).astype(np.float32)
    mu = (rng.randn(n) * np.abs(g)).astype(np.float32)
    nu = (rng.uniform(0.1, 2.0, n) * g * g).astype(np.float32)
    tx = optax.adamw(3e-4, weight_decay=1e-5)
    state = tx.init(jnp.asarray(p))
    state = (optax.ScaleByAdamState(count=jnp.asarray(count, jnp.int32),
                                    mu=jnp.asarray(mu), nu=jnp.asarray(nu)),
             *state[1:])
    u, state = jax.jit(tx.update)(jnp.asarray(g), state, jnp.asarray(p))
    want = np.asarray(optax.apply_updates(jnp.asarray(p), u))
    holder = torch.nn.Module()
    holder.q = q = torch.nn.Parameter(torch.from_numpy(p.copy()))
    opt = make_proposal_optimizer(holder, 3e-4)          # adamw(lr, 1e-5)
    opt.state[q] = {"step": torch.tensor(float(count)),
                    "exp_avg": torch.from_numpy(mu.copy()),
                    "exp_avg_sq": torch.from_numpy(nu.copy())}
    q.grad = torch.from_numpy(g)
    opt.step()
    check_against_optax(f"count {count}", q.detach().numpy(), want)
    check_close(f"mu {count}", opt.state[q]["exp_avg"].numpy(), state[0].mu, 1e-6)
    check_close(f"nu {count}", opt.state[q]["exp_avg_sq"].numpy(), state[0].nu, 1e-6)


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------

def test_detector_steps_match_jax_over_the_batches(plain_stems):
    """JAX's detector (train_proposal.py's step: value and grad of
    make_proposal_batch_loss, optax.adamw(lr, 1e-5)) trains 8 steps of
    batch 2 over 4 frames from the port's seeded init, as chip_smoke.py's
    9c reference steps take it; before each of its steps the port takes
    the same step from JAX's state and is held to JAX's next state. AdamW
    runs on the raveled parameters, where it is the same elementwise update
    as on the tree (one small compile for ~200 leaves)."""
    port = MaskRCNN(**_SMALL, device="cpu").trainable_()
    variables = to_flax_variables(MaskRCNN(**_SMALL, device="cpu", seed=DET_SEED))
    jmodel = jax_maskrcnn.MaskRCNN(**_SMALL)
    frames = [jax_frame(seed=s, H=64, W=128, max_objects=4, num_classes=8)
              for s in range(DET_FRAMES)]
    batches = [stack_detection_frames(frames[i:i + 2])
               for i in range(0, DET_FRAMES, 2)]
    bs = variables["batch_stats"]
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jax_batch_loss(jmodel, bs)(p, b), has_aux=True))
    tx = optax.adamw(DET_LR, weight_decay=1e-5)

    @jax.jit
    def update(grads, opt_state, params):
        u, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, u), opt_state, optax.global_norm(grads)

    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    cuts = np.cumsum([x.size for x in leaves])[:-1]

    def unravel(flat):
        return jax.tree_util.tree_unflatten(treedef, [
            np.asarray(v).reshape(x.shape) for v, x in zip(np.split(flat, cuts), leaves)])

    def snap(flat, opt_state):
        adam = opt_state[0]
        return snapshot(unravel(flat), unravel(np.asarray(adam.mu)),
                        unravel(np.asarray(adam.nu)), adam.count, port)

    opt = make_proposal_optimizer(port, DET_LR)
    step = make_proposal_train_step(port, opt)
    named = list(port.named_parameters())
    port_batches = [proposal_batch_to(b, "cpu") for b in batches]
    port.load_state_dict(convert_flax_variables(variables, port))
    bn = _bn_stats(port)
    flat = np.concatenate([np.ravel(x) for x in leaves])
    opt_state = tx.init(flat)
    s0, metrics = snap(flat, opt_state), []
    for k in range(DET_STEPS):
        assert s0["count"] == k
        load_snapshot(port, opt, named, s0)
        got = step(port_batches[k % 2])
        (loss, parts), grads = value_and_grad(
            unravel(flat), {n: jnp.asarray(v) for n, v in batches[k % 2].items()})
        flat_g = np.concatenate([np.ravel(x) for x in
                                 jax.tree_util.tree_leaves(jax.device_get(grads))])
        flat, opt_state, norm = update(flat_g, opt_state, flat)
        flat = np.asarray(flat)
        want = {"loss": float(loss), "grad_norm": float(norm),
                **{n: float(v) for n, v in parts.items()}}
        s1 = snap(flat, opt_state)
        for key, w in want.items():
            assert abs(float(got[key]) - w) <= DET_LOSS_REL * abs(w), (k, key)
        check_adam_step(f"step {k}", named, opt, s0, s1)
        got_bn = _bn_stats(port)
        assert all(np.array_equal(got_bn[n], bn[n]) for n in bn)   # frozen BN
        metrics.append(want)
        s0 = s1
    for key in ("rpn_cls", "rpn_reg", "box_cls", "box_reg", "mask"):   # exercised
        assert all(any(m[key] > 0 for m in metrics[b::2]) for b in range(2)), key
