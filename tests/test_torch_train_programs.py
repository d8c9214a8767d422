"""The port's training programs on the CPU (``train/steps.py`` ``TrainStep``
and ``EpochRunner``, ``train/loop.py``'s eval program, ``utils/programs.py``
``StepProgramCache``) against the JAX package's jitted ones, at a small size
(batch 3, 128 points).

- The eval program over a padded split of 7 clouds (no multiple of the
  batch) against JAX ``make_device_eval_runner``'s sums, in segments of 2
  batches and a tail, for a classifier, ``sign_msg`` and a regression head:
  counts equal, floats to ``TOL``.
- The epoch runner against JAX ``make_device_epoch_runner`` in segments
  of 2 steps and a tail (``translation``: 5 steps, two segments and a tail;
  ``translation_msg``, which runs FPS and the ball query: 3 steps, a
  segment and a tail), on the same permutation, augmentation off and dropout off on
  both sides (JAX's by monkeypatching ``flax.linen.Dropout.__call__``): the
  epoch's mean loss and metric, the parameters and the BatchNorm statistics
  to ``TOL``, in float64 on both sides as ``tests/test_torch_train.py`` runs
  its steps, the JAX step one op at a time for the SA model (compiled, its
  gradient of the maxima over ball-query pads, which repeat a point,
  differs). The models are pose heads, float64 end to end: a classifier's
  log-softmax is float32 in both packages, and over several steps its
  rounding noise moves a ReLU across 0 on one side and not the other
  (``pointnet2_cls_ssg``: 2e-6 apart after two steps, 2.5e-4 after three).
  The SA model trains with SGD: Adam's step is the learning rate times the
  sign of the gradient where the gradient is small, and the biases before
  a BatchNorm hold only rounding noise (``tests/test_torch_train.py``), so
  that its Adam epoch parts them by a learning rate a step (1.2e-4 after
  three steps).
- A training program on the CPU runs its step exactly once a call: the
  first call one optimizer step, one set of draws and the FPS and
  ball-query calls of one step, every later call as many; the programmed
  step and epoch equal the eager ones bit for bit.
- The learning rate is a tensor that StepLR updates in place, held
  against optax across StepLR boundaries and through a checkpoint round
  trip (a float rate, as older checkpoints hold, and a tensor one).
"""

import copy
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointnet_like_pose_estimation_tpu.data import dataset as jax_dataset
from pointnet_like_pose_estimation_tpu.models import get_model_spec as jax_model_spec
from pointnet_like_pose_estimation_tpu.train import loop as jax_loop
from pointnet_like_pose_estimation_tpu.train import steps as jax_steps
from pointnet_like_pose_estimation_tpu.train.config import TrainConfig as JaxTrainConfig
from pointnet_like_pose_estimation_tpu.train.state import make_optimizer as jax_make_optimizer
from pointnet_like_pose_estimation_tpu_torch.data.dataset import PoseDataset
from pointnet_like_pose_estimation_tpu_torch.kernels import ball_group
from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.nn import Dropout
from pointnet_like_pose_estimation_tpu_torch.ops import sampling
from pointnet_like_pose_estimation_tpu_torch.train import (
    TrainConfig,
    draw_step,
    make_epoch_runner,
    make_optimizer,
    make_train_step,
)
from pointnet_like_pose_estimation_tpu_torch.train import loop
from pointnet_like_pose_estimation_tpu_torch.train import steps as port_steps
from pointnet_like_pose_estimation_tpu_torch.train.state import restore_optimizer
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import from_flax_variables
from pointnet_like_pose_estimation_tpu_torch.utils.programs import StepProgramCache
from test_torch_registry import perturbed_variables
from test_torch_train import _f64, _numpy, _raw_batch, _torch_batch, no_jax_dropout, one_torch_thread  # noqa: F401

B, N, NUM_CLASSES, TOL = 3, 128, 7, 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def split():
    """(7 test clouds, 21 train clouds) of 128 points, built by the JAX package."""
    fields = jax_dataset.build_dataset(4, seed=11, n_points=N)
    return jax_dataset.load_dataset(fields, "test"), jax_dataset.load_dataset(fields, "train")


def _port_model(name, variables):
    model = build_model(name, NUM_CLASSES)
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model


# --- the eval program -------------------------------------------------------------------------


def test_padded_split_matches_jax(split):
    """The padded batches and their masks are JAX ``_device_eval_batches``'."""
    test, _ = split
    nb, data, valid = jax_loop._device_eval_batches(test, B)
    batches = loop._device_eval_batches(PoseDataset(**dataclasses.asdict(test)), B, CPU)
    assert len(batches) == nb == 3
    for i, batch in enumerate(batches):
        np.testing.assert_array_equal(batch["valid"].numpy(), np.asarray(valid[i]))
        for k in ("points", "labels", "rot", "tran", "sign", "width"):
            np.testing.assert_array_equal(batch[k].numpy(), np.asarray(data[k][i]), err_msg=k)


@pytest.mark.parametrize("name", ["pointnet2_cls_ssg", "sign_msg", "translation"])
def test_eval_program_matches_jax_device_eval_runner(split, name):
    """7 clouds at batch 3 (two pad rows, masked): the port's sums against
    those of JAX's runner in segments of 2 batches and a tail of 1. One
    program serves the three batches: made at the first, replayed twice."""
    test, _ = split
    kw = dict(num_points=N, batch_size=B, epoch_chunk=2)
    jcfg, tcfg = JaxTrainConfig.for_model(name, **kw), TrainConfig.for_model(name, **kw)
    _, variables = perturbed_variables(name)
    _, _, state = jax_loop.build_state(jcfg)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    nb, data, valid = jax_loop._device_eval_batches(test, B)
    want = jax.device_get(jax_steps.make_device_eval_runner(jax_model_spec(name), jcfg, nb)(state, data, valid))

    model = _port_model(name, variables)
    batches = loop._device_eval_batches(PoseDataset(**dataclasses.asdict(test)), B, CPU)
    got = loop._eval_sums(get_model_spec(name), tcfg, model, batches, CPU)
    assert set(got) == set(want)
    for k in ("n", "per_class_count", "per_class_correct"):
        if k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert float(got["n"]) == len(test)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=TOL, atol=TOL, err_msg=k)
    programs = loop.eval_programs(model, CPU)
    assert (programs.captures, programs.replays, len(programs)) == (1, nb - 1, 1)
    # a second pass replays the same program; a copy of the model owns none
    again = loop._eval_sums(get_model_spec(name), tcfg, model, batches, CPU)
    assert all(np.array_equal(again[k], got[k]) for k in got)
    assert (programs.captures, programs.replays) == (1, 2 * nb - 1)
    assert len(loop.eval_programs(copy.deepcopy(model), CPU)) == 0


# --- the epoch runner -------------------------------------------------------------------------


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


@pytest.mark.parametrize("name,clouds,optimizer,op_by_op", [("translation_msg", 10, "sgd", True),
                                                              ("translation", 16, "adam", False)])
def test_epoch_runner_matches_jax_device_epoch_runner(split, monkeypatch, no_jax_dropout, name, clouds,
                                                      optimizer, op_by_op):
    """``clouds`` train clouds at batch 3 (one dropped): JAX runs segments
    of 2 steps and a tail of 1. Both take JAX's permutation."""
    _, train = split
    ds = PoseDataset(**{k: v[:clouds] for k, v in dataclasses.asdict(train).items()})
    num_steps = len(ds) // B
    assert num_steps % 2 == 1
    kw = dict(num_points=N, batch_size=B, epoch_chunk=2, augment=False, optimizer=optimizer)
    _, variables = perturbed_variables(name)
    host = loop._host_arrays(ds)
    with jax.enable_x64(True):
        jcfg = JaxTrainConfig.for_model(name, **kw)
        _, _, state = jax_loop.build_state(jcfg)
        v64 = _f64(variables)
        state = state.replace(params=v64["params"], batch_stats=v64["batch_stats"],
                              opt_state=state.tx.init(v64["params"]))
        perm = np.asarray(jax.random.permutation(jax.random.split(state.rng)[1], len(ds))[: num_steps * B])
        jdata = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype) for k, v in host.items()}
        runner = jax_steps.make_device_epoch_runner(jax_model_spec(name), jcfg, num_steps)
        if op_by_op:
            with jax.disable_jit():
                new_state, means = runner(state, jdata)
        else:
            new_state, means = runner(state, jdata)
        means = _numpy(means)
        want = from_flax_variables(_numpy({"params": new_state.params, "batch_stats": new_state.batch_stats}))

    monkeypatch.setattr(port_steps, "_draw_perm", lambda gen, n, count: torch.from_numpy(perm.copy()))
    tcfg = TrainConfig.for_model(name, **kw)
    model = _no_dropout(_port_model(name, variables)).double()
    opt, _ = make_optimizer(tcfg, model.parameters())
    data = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in host.items()}
    sums, done = make_epoch_runner(get_model_spec(name), tcfg, num_steps)(model, opt, data, torch.Generator())
    assert done == num_steps
    np.testing.assert_allclose(float(sums[0]) / done, float(means["loss"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(sums[1]) / done, float(means["metric"]), rtol=TOL, atol=TOL)
    got = model.state_dict()
    for k, value in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), value.numpy(), rtol=TOL, atol=TOL, err_msg=k)


# --- a training program on the CPU ------------------------------------------------------------


def _counting(monkeypatch):
    """Calls of FPS and of the ball query, wherever the SA levels make them."""
    calls = {"fps": 0, "ball_query": 0}
    fps, ball = sampling.fps, ball_group.ball_query_multi

    def counted_fps(*a, **k):
        calls["fps"] += 1
        return fps(*a, **k)

    def counted_ball(*a, **k):
        calls["ball_query"] += 1
        return ball(*a, **k)

    monkeypatch.setattr(sampling, "fps", counted_fps)
    monkeypatch.setattr(ball_group, "ball_query_multi", counted_ball)
    return calls


def test_training_program_runs_its_step_once_a_call(monkeypatch):
    """pointnet2_cls_ssg: a first call is one step (one Adam step, one set
    of draws, 2 FPS and 2 ball-query calls), and so is every later call; the
    programmed steps equal the same steps run eagerly from a copy."""
    calls = _counting(monkeypatch)
    name = "pointnet2_cls_ssg"
    cfg = TrainConfig.for_model(name, num_points=N, batch_size=B)
    spec = get_model_spec(name)
    model = _port_model(name, perturbed_variables(name)[1])
    opt, _ = make_optimizer(cfg, model.parameters())
    twin = copy.deepcopy(model)
    twin_opt, _ = make_optimizer(cfg, twin.parameters())
    batch = _torch_batch(_raw_batch(8))
    gen, twin_gen = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    step = make_train_step(spec, cfg)
    programs = step.cache(CPU)
    for i in range(3):
        before = dict(calls)
        got = step(model, opt, batch, gen)
        assert {k: calls[k] - before[k] for k in calls} == {"fps": 2, "ball_query": 2}
        assert [int(s["step"]) for s in opt.state.values()] == [i + 1] * len(opt.state)
        assert (programs.captures, programs.replays) == (1, i)
        want = step.eager(twin, twin_opt, batch, twin_gen)
        assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["metric"], want["metric"])
        assert torch.equal(gen.get_state(), twin_gen.get_state())           # one set of draws a call
    for (k, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad), k
    assert all(torch.equal(a, b) for a, b in zip(model.buffers(), twin.buffers()))


def test_programmed_epoch_equals_the_eager_epoch(monkeypatch):
    """rotation_ssg with augmentation and dropout: 2 epochs of 3 steps each,
    programmed and eager from copies with the same generator state, equal
    bit for bit; each epoch 3 steps' FPS calls, no more."""
    calls = _counting(monkeypatch)
    name = "rotation_ssg"
    cfg = TrainConfig.for_model(name, num_points=N, batch_size=B)
    spec = get_model_spec(name)
    model = _port_model(name, perturbed_variables(name)[1])
    twin = copy.deepcopy(model)
    opt, twin_opt = make_optimizer(cfg, model.parameters())[0], make_optimizer(cfg, twin.parameters())[0]
    batches = [_torch_batch(_raw_batch(seed)) for seed in (1, 2, 3)]
    data = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
    gen, twin_gen = torch.Generator().manual_seed(6), torch.Generator().manual_seed(6)
    runner = make_epoch_runner(spec, cfg, 3)
    for _ in range(2):
        before = calls["fps"]
        sums, done = runner(model, opt, data, gen)
        assert calls["fps"] - before == 2 * 3
        want, want_done = runner.eager(twin, twin_opt, data, twin_gen)
        assert done == want_done == 3 and torch.equal(sums, want)
        assert torch.equal(gen.get_state(), twin_gen.get_state())
    for (k, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), k
    assert runner.step.cache(CPU).captures == 1


def test_draws_into_static_tensors_are_draw_steps():
    """The epoch runner's draws, made into its tensors, are the numbers
    draw_step gives from the same generator state."""
    cfg = TrainConfig.for_model("pointnet2_cls_ssg", num_points=N, batch_size=B)
    model = build_model("pointnet2_cls_ssg", NUM_CLASSES)
    batch = _torch_batch(_raw_batch(1))
    want = draw_step(cfg, model, batch, torch.Generator().manual_seed(9))
    got = draw_step(cfg, model, batch, torch.Generator().manual_seed(123))
    port_steps._draw_into(got, torch.Generator().manual_seed(9))
    assert list(got["dropout"]) == list(want["dropout"]) and len(got["dropout"]) == 2
    for part in ("augment", "dropout"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)


def test_step_program_cache_runs_once_and_remakes_over_replaced_tensors():
    calls = []
    w = torch.ones(3)
    held = {"w": w}

    def fn(x):
        calls.append(1)
        held["w"].add_(x)
        return held["w"] * 2

    cache = StepProgramCache("cpu")
    bound = lambda: [held["w"]]  # noqa: E731
    out = cache(("f",), fn, (torch.ones(3),), bound)
    assert torch.equal(out, torch.full((3,), 4.0)) and len(calls) == 1
    cache(("f",), fn, (torch.ones(3),), bound)
    assert len(calls) == 2 and (cache.captures, cache.replays, cache.remade) == (1, 1, 0)
    held["w"] = torch.zeros(3)                      # the tensor the program was made on is replaced
    cache(("f",), fn, (torch.ones(3),), bound)
    assert len(calls) == 3 and (cache.captures, cache.replays, cache.remade) == (2, 1, 1)
    assert torch.equal(held["w"], torch.ones(3))
    with pytest.raises(ValueError, match="the program takes"):
        cache(("f",), fn, (torch.ones(4),), bound)
    assert len(copy.deepcopy(cache)) == 0


# --- the learning rate --------------------------------------------------------------------------


def _round_trip(opt, sched, cfg, params, saved_rate):
    """The optimizer and scheduler through a checkpoint's bytes into a fresh
    pair built by make_optimizer, whose rate tensor must stay its own."""
    buf = io.BytesIO()
    torch.save({"optimizer": opt.state_dict(), "scheduler": sched.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    if saved_rate == "float":                       # as checkpoints written before the tensor rate
        for group in saved["optimizer"]["param_groups"]:
            group["lr"] = float(group["lr"])
    new_opt, new_sched = make_optimizer(cfg, params)
    rate = new_opt.param_groups[0]["lr"]
    restore_optimizer(new_opt, saved["optimizer"])
    new_sched.load_state_dict(saved["scheduler"])
    assert new_opt.param_groups[0]["lr"] is rate and float(rate) == float(opt.param_groups[0]["lr"])
    return new_opt, new_sched


@pytest.mark.parametrize("saved_rate", ["tensor", "float"])
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_tensor_learning_rate_matches_optax_across_steplr_and_a_round_trip(optimizer, saved_rate):
    """6 steps, one an epoch, StepLR every 2 epochs, the optimizer restored
    from a checkpoint after the third: the rate stays one tensor that
    StepLR fills in place, and the parameters equal optax's to 1e-6."""
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(6)]
    kw = dict(optimizer=optimizer, learning_rate=1e-3, weight_decay=0.01, lr_step_epochs=2, lr_gamma=0.5)
    tx = jax_make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    cfg = TrainConfig(**kw)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched = make_optimizer(cfg, tparams.values())
    rate = opt.param_groups[0]["lr"]
    assert isinstance(rate, torch.Tensor) and rate.dtype == torch.float32
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        sched.step()
        assert opt.param_groups[0]["lr"] is rate
        np.testing.assert_allclose(float(rate), 1e-3 * 0.5 ** ((i + 1) // 2), rtol=1e-6)
        if i == 2:
            opt, sched = _round_trip(opt, sched, cfg, tparams.values(), saved_rate)
            rate = opt.param_groups[0]["lr"]
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-6, err_msg=k)
