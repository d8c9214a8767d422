"""The port's evaluation path on the CPU against the JAX package's:
``evaluate`` key by key on one small ``PoseDataset`` built once by the JAX
package, for one model per task; ``make_eval_step``; the ``eval`` command
on a checkpoint written by the JAX package; the two committed MSG
checkpoints at full width; ``PipelineConfig.classifier``; the device rule.

Floats agree to rtol = atol = 1e-4 (float32 products summed in another
order); accuracies, classes and hard signs are equal.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_like_pose_estimation_tpu.data import dataset as jax_dataset
from pointnet_like_pose_estimation_tpu.models import get_model_spec as jax_model_spec
from pointnet_like_pose_estimation_tpu.train import loop as jax_loop
from pointnet_like_pose_estimation_tpu.train.config import TrainConfig as JaxTrainConfig
from pointnet_like_pose_estimation_tpu.train.steps import make_eval_step as jax_make_eval_step
from pointnet_like_pose_estimation_tpu_torch import cli
from pointnet_like_pose_estimation_tpu_torch.data.dataset import PoseDataset
from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.train import (
    TrainConfig,
    evaluate,
    load_checkpoint,
    make_eval_step,
)
from pointnet_like_pose_estimation_tpu_torch.train.loop import _ckpt_dir
from pointnet_like_pose_estimation_tpu_torch.train.steps import _prepare_inputs
from pointnet_like_pose_estimation_tpu_torch.utils.checkpoint import from_flax_variables
from test_torch_registry import perturbed_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, TOL = 128, 1e-4
# one model per task; rotation_ssg and sign_msg run FPS and the ball query on 10 channels
MODELS = ["pointnet_cls", "rotation_ssg", "sign_msg", "translation", "width"]


@pytest.fixture(scope="module")
def test_split():
    """7 test clouds (one per class) of 128 points, built by the JAX package."""
    fields = jax_dataset.build_dataset(4, seed=11, n_points=N)
    return jax_dataset.load_dataset(fields, "test")


def _cfgs(name, **kw):
    kw = dict(num_points=N, batch_size=3, **kw)
    return JaxTrainConfig.for_model(name, **kw), TrainConfig.for_model(name, **kw)


def _pair(name, jcfg):
    """(JAX state, port model) holding the same perturbed variables."""
    _, variables = perturbed_variables(name)
    _, _, state = jax_loop.build_state(jcfg)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    model = build_model(name, jcfg.num_classes)
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return state, model


def _assert_results_match(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(np.asarray(got[key], np.float64), np.asarray(value, np.float64),
                                   rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("name", MODELS)
def test_evaluate_matches_jax_evaluate(test_split, name):
    """7 clouds at batch 3: both packages pad the last batch to 3 and mask
    the pad; every key of the result is equal."""
    jcfg, tcfg = _cfgs(name, loss_kind="L1_loss" if name == "width" else "L2_loss")
    state, model = _pair(name, jcfg)
    want = jax_loop.evaluate(jcfg, state, test_split)
    got = evaluate(tcfg, model, PoseDataset(**dataclasses.asdict(test_split)), device="cpu")
    _assert_results_match(got, want)
    if get_model_spec(name).task in ("classify", "sign"):
        assert got["per_class_acc"] == want["per_class_acc"]


@pytest.mark.parametrize("name", ["pointnet_cls", "sign", "translation"])
def test_eval_step_matches_jax(test_split, name):
    jcfg, tcfg = _cfgs(name, compat_first3_mean=name == "translation")
    state, model = _pair(name, jcfg)
    batch = next(jax_dataset.iter_batches(test_split, 5))
    valid = np.array([1, 1, 0, 1, 1], np.float32)
    want = jax_make_eval_step(jax_model_spec(name), jcfg)(
        state, {**{k: jnp.asarray(v) for k, v in batch.items()}, "valid": jnp.asarray(valid)})
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tbatch["labels"] = tbatch["labels"].long()
    got = make_eval_step(get_model_spec(name), tcfg)(model.eval(), {**tbatch, "valid": torch.from_numpy(valid)})
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=TOL, atol=TOL, err_msg=key)


def test_training_inputs_are_not_ported_and_say_so(test_split):
    """The train branch of ``_prepare_inputs`` is ported and asks for the
    step's draws; a multi-host run that cannot form its process group (no
    ``torchrun`` environment) raises, and a compute dtype other than
    float32 and bfloat16 raises."""
    from pointnet_like_pose_estimation_tpu_torch.train import train

    batch = {"points": torch.zeros(2, 8, 3), "labels": torch.zeros(2, dtype=torch.long)}
    with pytest.raises(ValueError, match="needs its draws"):
        _prepare_inputs(get_model_spec("pointnet_cls"), TrainConfig(), batch, train=True)
    ds = PoseDataset(**dataclasses.asdict(test_split))
    with pytest.raises(ValueError, match="expected, but not set"):
        train(TrainConfig(data_parallel=True, multihost=True), ds, device="cpu")
    with pytest.raises(ValueError, match="unknown compute dtype"):
        train(TrainConfig(dtype="float16"), ds, device="cpu")


def test_eval_command_reads_a_jax_checkpoint(test_split, tmp_path, capsys):
    """``cli eval`` on ``<log-dir>/pose/<experiment>/checkpoints/best.msgpack``
    written by the JAX package's ``save_checkpoint``."""
    name = "rotation"
    jcfg, _ = _cfgs(name, log_dir=str(tmp_path), experiment="exp")
    state, _ = _pair(name, jcfg)
    assert _ckpt_dir(TrainConfig.for_model(name, log_dir=str(tmp_path), experiment="exp")) == jax_loop._ckpt_dir(jcfg)
    jax_loop.save_checkpoint(os.path.join(jax_loop._ckpt_dir(jcfg), "best.msgpack"), state, 4, 1.5)
    rot = test_split.rot.copy()
    rot[:, 2] *= np.where(test_split.sign == 0, 1.0, test_split.sign)
    fields = {k: getattr(test_split, k) for k in ("points", "labels", "tran", "width")}
    data = tmp_path / "ds.npz"
    # two clouds per class, the first the train split, the second the test split
    np.savez(data, num_per_class=np.asarray(2),
             **{k: np.repeat(v, 2, axis=0) for k, v in {**fields, "rot": rot}.items()})
    want = jax_loop.evaluate(jcfg, state, test_split)
    cli.main(["eval", "--model", name, "--data", str(data), "--batch-size", "3",
              "--log-dir", str(tmp_path), "--experiment", "exp", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("checkpoint_epoch") == 4
    _assert_results_match(got, want)


def test_evaluate_and_eval_command_default_to_the_card(test_split, tmp_path):
    """No card here: the default device raises, it does not fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    cfg = TrainConfig.for_model("width", batch_size=3)
    ds = PoseDataset(**dataclasses.asdict(test_split))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate(cfg, build_model("width"), ds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["generate", "--num-per-class", "1", "--out", str(tmp_path / "x.npz")])
    with pytest.raises(ValueError, match="unknown compute dtype"):
        evaluate(dataclasses.replace(cfg, dtype="float16"), build_model("width"), ds, device="cpu")


@pytest.mark.parametrize(
    "name,experiment",
    [("sign_msg", "r5_sign_msg"), ("translation_msg", "r5_translation_msg_bf16")],
)
def test_committed_msg_checkpoints_match_jax_at_full_width(name, experiment):
    """The committed checkpoints, 4 clouds of 1024 points, float32 on both
    sides (the bf16 run stored its parameters as float32)."""
    path = os.path.join(ROOT, "log", "pose", experiment, "checkpoints", "best.msgpack")
    jcfg = JaxTrainConfig.for_model(name)
    _, jmodel, state = jax_loop.build_state(jcfg)
    state, meta = jax_loop.load_checkpoint(path, state)
    model, tmeta = load_checkpoint(path, build_model(name))
    assert tmeta == meta
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 1024, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    onehot = np.zeros((4, 1024, 7), np.float32)
    onehot[np.arange(4), :, [0, 2, 4, 6]] = 1.0
    inputs = [np.concatenate([x, onehot], -1)]
    if name == "translation_msg":
        inputs.append(rng.standard_normal((4, 3)).astype(np.float32))
    want = jmodel.apply({"params": state.params, "batch_stats": state.batch_stats},
                        *map(jnp.asarray, inputs), train=False)
    with torch.no_grad():
        got = model.eval()(*map(torch.from_numpy, inputs))
    if name == "sign_msg":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("classifier", ["pointnet2_cls_msg", "pointnet_cls"])
def test_pipeline_serves_with_another_classifier(classifier):
    """``PipelineConfig.classifier``: the port's pipeline against the JAX
    one holding the same variables, on clusters of 300 points tiled to 256."""
    from pointnet_like_pose_estimation_tpu.pipeline import GraspPipeline as JaxPipeline
    from pointnet_like_pose_estimation_tpu.pipeline import PipelineConfig as JaxConfig
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    names = {"classifier": classifier, "rotation": "rotation", "sign": "sign",
             "translation": "translation", "width": "width"}
    jmodels, tmodels = {}, {}
    for key, name in names.items():
        jmodel, variables = perturbed_variables(name, seed=3)
        jmodels[key] = (jmodel, variables)
        tmodels[key] = build_model(name)
        tmodels[key].load_state_dict(from_flax_variables(variables), strict=True)
    jax_pipe = JaxPipeline(JaxConfig(num_points=256, classifier=classifier), jmodels)
    port = GraspPipeline(PipelineConfig(num_points=256, classifier=classifier), tmodels, device="cpu")
    clusters = (0.05 * np.random.default_rng(9).standard_normal((2, 300, 3))).astype(np.float32)
    got, want = port.infer_clusters(clusters), jax_pipe.infer_clusters(clusters)
    np.testing.assert_array_equal(got["pred_class"], np.asarray(want["pred_class"]))
    for key in ("log_probs", "rotation_deg", "sign_prob", "translation", "width"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=TOL, atol=TOL, err_msg=key)
    with pytest.raises(ValueError, match="does not classify raw clouds"):
        GraspPipeline.from_random(PipelineConfig(classifier="pose_classify"), device="cpu")
