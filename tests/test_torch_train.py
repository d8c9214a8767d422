"""The port's training step on the CPU against the JAX package's.

- train-mode BatchNorm: the output and the updated running statistics of a
  ``PointwiseMLP`` against flax's ``model.apply(train=True,
  mutable=["batch_stats"])``; the running variance takes the biased batch
  variance, as flax's does;
- the optimizer: the same gradients through the port's Adam / SGD and
  StepLR and through ``make_optimizer``'s optax chain, across a StepLR
  boundary, parameters equal to 1e-6;
- the augmentations: the port's *apply* functions fed JAX's own draws (made
  from the keys the JAX functions split), equal to 1e-6, and both branches
  of ``_prepare_inputs(train=True)``;
- one train step of ``pointnet2_cls_ssg`` and ``translation`` (here) and of
  ``sign_msg`` and ``pointnet_cls`` (``test_torch_train_loop.py``, which
  calls ``check_train_step_against_jax``) against JAX ``make_train_step`` on the same perturbed
  variables and batch: loss, every gradient and the BatchNorm running
  statistics to rtol = atol = 1e-4, in float64 on both sides, the
  parameters after the Adam step to 1e-5 except where Adam's step follows
  rounding noise: the biases that feed a BatchNorm (``pre_bn_biases``),
  whose true gradient is 0, and gradients under 1e-6; those are held to
  one step of the learning rate.

Dropout is turned off on both sides (JAX's only inside the test, by
monkeypatching ``flax.linen.Dropout.__call__``): flax and PyTorch draw
their masks from different generators. The port's dropout on supplied
uniforms is held to flax's formula separately.
"""

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointnet_like_pose_estimation_tpu.data import augment as jax_aug
from pointnet_like_pose_estimation_tpu.models import get_model_spec as jax_model_spec
from pointnet_like_pose_estimation_tpu.nn.layers import PointwiseMLP as JaxPointwiseMLP
from pointnet_like_pose_estimation_tpu.train import loop as jax_loop
from pointnet_like_pose_estimation_tpu.train import steps as jax_steps
from pointnet_like_pose_estimation_tpu.train.config import TrainConfig as JaxTrainConfig
from pointnet_like_pose_estimation_tpu.train.state import make_optimizer as jax_make_optimizer
from pointnet_like_pose_estimation_tpu_torch.data import augment as aug
from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.nn import Dropout, PointwiseMLP, pre_bn_biases
from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, make_optimizer, make_train_step
from pointnet_like_pose_estimation_tpu_torch.train.steps import _prepare_inputs
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import from_flax_variables
from test_torch_registry import perturbed_variables

B, N, NUM_CLASSES, TOL = 3, 128, 7, 1e-4


def _raw_batch(seed):
    """Random raw clouds (not normalised) and targets of every task."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x = (x / np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]).astype(np.float32)
    return {
        "points": x + rng.uniform(-0.3, 0.3, (B, 1, 3)).astype(np.float32),
        "labels": rng.integers(0, NUM_CLASSES, B).astype(np.int32),
        "rot": rng.uniform(0, 90, (B, 3)).astype(np.float32),
        "tran": rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32),
        "sign": np.where(rng.random(B) > 0.5, 1.0, -1.0).astype(np.float32),
        "width": rng.uniform(0.02, 0.1, (B, 1)).astype(np.float32),
    }


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}
    out["labels"] = out["labels"].long()
    return out


def _jax_draws(key, points):
    """The unit uniforms ``_prepare_inputs`` draws from ``key``, made with
    the keys it splits, in the port's ``draw_augment`` layout."""
    k1, k2, k3 = jax.random.split(key, 3)
    ka, kb = jax.random.split(k1)
    Bn, Nn, C = points.shape
    draws = {"ratio": jax.random.uniform(ka, (Bn, 1)), "drop": jax.random.uniform(kb, (Bn, Nn)),
             "scale": jax.random.uniform(k2, (Bn, 1, 1)), "shift": jax.random.uniform(k3, (Bn, 1, C))}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """xdist runs several workers on the machine's cores; torch's own thread
    pool in each of them would oversubscribe the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


# --- train-mode BatchNorm -------------------------------------------------------------------


def test_train_mode_batchnorm_matches_flax_and_updates_with_the_biased_variance():
    """One train-mode forward of a PointwiseMLP over [2, 5, 4, 6] inputs
    (40 rows a channel, so the unbiased variance would be 40/39 of the
    biased one): output, running mean and running variance against flax."""
    rng = np.random.default_rng(0)
    x = (1.5 * rng.standard_normal((2, 5, 4, 6)) + 0.7).astype(np.float32)
    jmodel = JaxPointwiseMLP([8, 5])
    variables = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)))
    for leaf in ("mean", "var"):
        for bn in variables["batch_stats"].values():
            bn[leaf] = (bn[leaf] + rng.uniform(0.2, 0.8, bn[leaf].shape)).astype(np.float32)
    want, updates = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tmodel = PointwiseMLP(6, [8, 5])
    tmodel.load_state_dict(from_flax_variables(variables), strict=True)
    got = tmodel.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = from_flax_variables({"batch_stats": jax.tree_util.tree_map(np.asarray, updates["batch_stats"])})
    for name, value in stats.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(tmodel.state_dict()[name].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    # and the variance that went in is the biased one
    h = torch.from_numpy(x).reshape(-1, 6) @ tmodel.dense_0.weight.t() + tmodel.dense_0.bias
    running = torch.from_numpy(variables["batch_stats"]["bn_0"]["var"])
    biased = 0.9 * running + 0.1 * h.var(dim=0, unbiased=False)
    np.testing.assert_allclose(tmodel.bn_0.running_var.numpy(), biased.detach().numpy(), rtol=1e-5, atol=1e-5)


def test_dropout_on_supplied_uniforms_is_flaxs_formula():
    """Kept where the uniform is at least the rate, scaled by 1/(1-rate);
    eval mode and a rate of 0 pass the input through; train mode without
    uniforms raises."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    u = torch.from_numpy(rng.random((4, 16)).astype(np.float32))
    drop = Dropout(0.4, 16).train()
    drop.uniforms = u
    want = np.where(u.numpy() >= 0.4, x.numpy() / np.float32(0.6), 0.0)
    np.testing.assert_array_equal(drop(x).numpy(), want)
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout(0.0, 16).train()(x), x)
    with pytest.raises(RuntimeError, match="no uniforms"):
        Dropout(0.4, 16).train()(x)


def test_dead_tnet_runs_in_train_mode_as_in_jax(no_jax_dropout):
    """``compat_dead_tnet``: one train-mode forward updates the dead T-Net's
    BatchNorm statistics as the JAX head does (eval skips it; its output is
    discarded either way)."""
    from pointnet_like_pose_estimation_tpu.models.heads import VanillaHead as JaxVanillaHead
    from pointnet_like_pose_estimation_tpu_torch.models import VanillaHead

    rng = np.random.default_rng(12)
    x = np.concatenate([rng.standard_normal((B, N, 3)), np.eye(NUM_CLASSES)[rng.integers(0, 7, B)][:, None]
                        .repeat(N, 1)], -1).astype(np.float32)
    jmodel = JaxVanillaHead(out_dim=3, compat_dead_tnet=True)
    variables = _numpy(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False))
    with jax.enable_x64(True):      # float64, for the reason test_train_step_... gives
        want, updates = jmodel.apply(_f64(variables), jnp.asarray(x, jnp.float64), train=True,
                                     mutable=["batch_stats"])
        want, updates = np.asarray(want), _numpy(updates)
    head = VanillaHead(3 + NUM_CLASSES, out_dim=3, compat_dead_tnet=True)
    head.load_state_dict(from_flax_variables(variables), strict=True)
    head = head.double().train()
    for m in head.modules():
        if isinstance(m, Dropout):
            m.eval()
    with torch.no_grad():
        got = head(torch.from_numpy(x).double())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    stats = from_flax_variables({"batch_stats": updates["batch_stats"]})
    assert any(k.startswith("dead_tnet.") for k in stats)
    for k, value in stats.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(head.state_dict()[k].numpy(), value.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=k)


# --- optimizer ------------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizer_matches_optax_across_a_steplr_boundary(optimizer):
    """The same gradients for 5 steps, one step an epoch, StepLR every 2
    epochs (so the rate changes twice): parameters equal to 1e-6. One
    parameter gets a zero gradient, which L2 decay must still move."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,), "dead": (2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (np.zeros(s) if k == "dead" else rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    # the classifiers' learning rate: optax forms Adam's bias corrections in
    # float32 (1 - 0.999 is 1.3e-5 off), PyTorch in double, so a large rate
    # would part the two by more than rounding
    kw = dict(optimizer=optimizer, learning_rate=1e-3, weight_decay=0.01, lr_step_epochs=2, lr_gamma=0.5)

    tx = jax_make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched = make_optimizer(TrainConfig(**kw), tparams.values())
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        sched.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert not np.allclose(tparams["dead"].detach().numpy(), params["dead"])
    assert sched.get_last_lr()[0] == pytest.approx(1e-3 * 0.5 ** 2)


# --- augmentations --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["point_dropout", "scale", "shift", "jitter", "shuffle", "train_augment"])
def test_augmentation_apply_matches_jax_on_its_draws(name):
    key = jax.random.PRNGKey(7)
    points = _raw_batch(4)["points"]
    jp = jnp.asarray(points)
    tp = torch.from_numpy(points)
    if name == "point_dropout":
        want = jax_aug.random_point_dropout(key, jp)
        ka, kb = jax.random.split(key)
        got = aug.point_dropout(tp, torch.from_numpy(np.asarray(jax.random.uniform(ka, (B, 1)))),
                                torch.from_numpy(np.asarray(jax.random.uniform(kb, (B, N)))))
        assert 0 < int((got == tp[:, :1]).all(-1).sum()) < B * N      # some points dropped
    elif name == "scale":
        want = jax_aug.random_scale(key, jp)
        got = aug.scale(tp, torch.from_numpy(np.asarray(jax.random.uniform(key, (B, 1, 1)))))
    elif name == "shift":
        want = jax_aug.random_shift(key, jp)
        got = aug.shift(tp, torch.from_numpy(np.asarray(jax.random.uniform(key, (B, 1, 3)))))
    elif name == "jitter":
        want = jax_aug.jitter(key, jp)
        got = aug.jitter(tp, torch.from_numpy(np.asarray(jax.random.normal(key, jp.shape))))
    elif name == "shuffle":
        want = jax_aug.shuffle_points(key, jp)
        got = aug.shuffle_points(tp, torch.from_numpy(np.asarray(jax.random.permutation(key, N))))
    else:
        want = jax_aug.train_augment(key, jp)
        got = aug.train_augment(tp, _jax_draws(key, points))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_augmentation_draws_come_from_the_generator():
    """Same seed, same draws; the draws have the shapes JAX draws; the
    random_* forms are draw then apply."""
    points = torch.from_numpy(_raw_batch(5)["points"])
    a = aug.draw_augment(torch.Generator().manual_seed(3), points)
    b = aug.draw_augment(torch.Generator().manual_seed(3), points)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "ratio": (B, 1), "drop": (B, N), "scale": (B, 1, 1), "shift": (B, 1, 3)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(float(v.min()) >= 0.0 and float(v.max()) < 1.0 for v in a.values())
    pairs = [(aug.random_point_dropout, lambda g, p: aug.point_dropout(p, *aug.draw_point_dropout(g, p))),
             (aug.random_scale, lambda g, p: aug.scale(p, aug.draw_scale(g, p))),
             (aug.random_shift, lambda g, p: aug.shift(p, aug.draw_shift(g, p))),
             (aug.random_jitter, lambda g, p: aug.jitter(p, aug.draw_jitter(g, p))),
             (aug.random_shuffle_points, lambda g, p: aug.shuffle_points(p, aug.draw_shuffle(g, p)))]
    for random_form, draw_then_apply in pairs:
        got = random_form(torch.Generator().manual_seed(4), points)
        assert torch.equal(got, draw_then_apply(torch.Generator().manual_seed(4), points))
        assert got.shape == points.shape and not torch.equal(got, points)
    s = aug.scale_factor(a["scale"])
    assert bool(((s >= aug.SCALE_LO) & (s < aug.SCALE_HI)).all())


@pytest.mark.parametrize("name,consistent", [("pointnet2_cls_ssg", False), ("translation", False),
                                             ("translation", True), ("width", True)])
def test_prepare_inputs_for_training_matches_jax(name, consistent):
    """Both branches: the reference one (dropout -> scale -> shift, targets
    untouched) and ``augment_consistent_labels`` (tran and width move with
    the cloud); the centroid before the normalisation."""
    kw = dict(num_points=N, augment_consistent_labels=consistent)
    jcfg, tcfg = JaxTrainConfig.for_model(name, **kw), TrainConfig.for_model(name, **kw)
    batch = _raw_batch(6)
    key = jax.random.PRNGKey(11)
    want_inputs, want_target = jax_steps._prepare_inputs(
        jax_model_spec(name), jcfg, key, {k: jnp.asarray(v) for k, v in batch.items()}, train=True)
    got_inputs, got_target = _prepare_inputs(get_model_spec(name), tcfg, _torch_batch(batch), train=True,
                                             draws=_jax_draws(key, batch["points"]))
    assert len(got_inputs) == len(want_inputs)
    for g, w in zip(got_inputs, want_inputs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_target.numpy(), np.asarray(want_target), rtol=1e-6, atol=1e-6)
    if consistent:
        assert not np.allclose(got_target.numpy(), batch[{"translation": "tran", "width": "width"}[name]])


# --- one train step -------------------------------------------------------------------------


def _recording(tx):
    """``tx`` behind a pass-through transformation that keeps the gradients
    it is given in its state (``opt_state[0]``)."""

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def check_train_step_against_jax(name):
    """Both steps run in float64 (JAX under ``jax.enable_x64``, the port's
    model ``.double()``), where only their semantics can part them: at
    batch 3 a train-mode BatchNorm of the head normalises three values a
    channel, with flax's ``E[x^2] - E[x]^2``, and in float32 the gradients
    of either package are up to a few percent from its own float64 ones, so
    the two cannot be held to 1e-4 in float32. The classifiers' log-softmax
    and the sign head's sigmoid are float32 in both packages.

    ``make_train_step`` runs with jit disabled. Point dropout repeats each
    cloud's first point, so a max over a group meets exact ties; compiled,
    the JAX step's gradient of those maxima differs from the same step run
    one op at a time by up to hundreds (measured on SA1 of
    ``pointnet2_cls_ssg``), while its forward is equal to the last bit.
    The port agrees with the step run one op at a time. Its gradients are
    read from the step itself, kept by a pass-through transformation in
    front of the package's optimizer (``_recording``)."""
    jmodel, variables = perturbed_variables(name)
    batch = _raw_batch(8)
    with jax.enable_x64(True):
        jcfg = JaxTrainConfig.for_model(name, num_points=N, batch_size=B)
        jspec = jax_model_spec(name)
        _, _, state = jax_loop.build_state(jcfg)
        v64 = _f64(variables)
        tx = _recording(state.tx)
        state = state.replace(params=v64["params"], batch_stats=v64["batch_stats"], tx=tx,
                              opt_state=tx.init(v64["params"]))
        jbatch = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype)
                  for k, v in batch.items()}
        _, aug_key, _ = jax.random.split(state.rng, 3)          # as make_train_step splits
        draws = _jax_draws(aug_key, batch["points"])
        with jax.disable_jit():
            new_state, metrics = jax_steps.make_train_step(jspec, jcfg)(state, jbatch)
        jgrads = _numpy(new_state.opt_state[0])
        metrics = _numpy(metrics)
        new_vars = _numpy({"params": new_state.params, "batch_stats": new_state.batch_stats})
    assert draws["drop"].dtype == torch.float64

    tcfg = TrainConfig.for_model(name, num_points=N, batch_size=B)
    model = build_model(name, NUM_CLASSES)
    model.load_state_dict(from_flax_variables(variables), strict=True)
    model = model.double()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt, _ = make_optimizer(tcfg, model.parameters())
    tbatch = {k: v.double() if v.is_floating_point() else v for k, v in _torch_batch(batch).items()}
    out = make_train_step(get_model_spec(name), tcfg)(model, opt, tbatch,
                                                      draws={"augment": draws, "dropout": None})

    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(out["metric"]), float(metrics["metric"]), rtol=TOL, atol=TOL)
    want_grads = from_flax_variables({"params": jgrads})
    params = dict(model.named_parameters())
    assert set(want_grads) == set(params)
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), rtol=TOL, atol=TOL, err_msg=k)
    want = from_flax_variables(new_vars)
    got = model.state_dict()
    noisy = pre_bn_biases(model)
    lr, wd = tcfg.learning_rate, tcfg.weight_decay
    at_floor = total = 0
    for k, value in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), value.numpy(), rtol=TOL, atol=TOL, err_msg=k)
            continue
        # Adam's first step is lr * g / (|g| + 1e-8): it follows the digits of
        # g only near the rounding floor. The pre-BN biases (true gradient 0)
        # and any element whose gradient with decay is under 1e-6 (the float32
        # log-softmax and sigmoid round at about 1e-7) are held to one step
        # of the learning rate from the start on each side, the rest to 1e-5.
        floor = np.abs(want_grads[k].numpy() + wd * before[k].numpy()) < 1e-6
        if k in noisy:
            floor[...] = True
        else:
            at_floor, total = at_floor + int(floor.sum()), total + floor.size
        for side in (got[k].numpy(), value.numpy()):
            np.testing.assert_allclose(side[floor], before[k].numpy()[floor], rtol=0, atol=lr * 1.0001,
                                       err_msg=k)
        np.testing.assert_allclose(got[k].numpy()[~floor], value.numpy()[~floor], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert at_floor < 0.01 * total, f"{at_floor} of {total} parameters at the rounding floor"
    # every parameter moved (L2 decay alone moves those the loss does not reach)
    assert all(not torch.equal(before[k], p.detach()) for k, p in params.items())
    if name == "pointnet_cls":      # the orthogonality regularizer reaches both T-Nets
        assert float(model.encoder.tnet_feature.out.weight.grad.abs().sum()) > 0
        assert float(model.encoder.tnet_input.out.weight.grad.abs().sum()) > 0


# sign_msg and pointnet_cls run in tests/test_torch_train_loop.py, so that
# xdist (--dist loadfile) spreads the JAX steps over two workers
@pytest.mark.parametrize("name", ["pointnet2_cls_ssg", "translation"])
def test_train_step_matches_jax_make_train_step(name, no_jax_dropout):
    check_train_step_against_jax(name)
