"""A run with its timed path broken underneath comes out not correct, and
so does the lower-precision control, while the sound run keeps to the limits.
Each drives the harness on the CPU at a size a test holds (the look for a
card skipped): the cell's own driver, judge and limits."""

import pytest
import torch

from harness.runner import Run, execute, result_line

SMALL = {
    "clusters_k32": {"requests": 1, "clusters": 4, "points": 1100, "warmup": 1, "check": 2},
    "frames_300k": {"table_points": 20000, "rate": 2, "check": 2, "scene_seconds": 1.0, "warm_frames": 2},
    "train_ssg_b24": {"batch_size": 4, "per_class": 2},
}
SECONDS = {"clusters_k32": 1.0, "frames_300k": 1.0, "train_ssg_b24": 1.0}


def _correct(cell: str, program_dtype: str | None = None) -> bool:
    run = Run(cell, 2**31 + 77, SECONDS[cell], False, device="cpu", overrides=SMALL[cell],
              program_dtype=program_dtype)
    return result_line(run, execute(run), "cpu", 1, "none")["correct"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    assert _correct(cell)


def _alter(key):
    """``GraspPipeline._infer`` with one answer changed where it is made."""
    from pointnet_like_pose_estimation_tpu_torch.pipeline.infer import GraspPipeline

    infer = GraspPipeline._infer

    def altered(self, xyz):
        out = dict(infer(self, xyz))
        if key == "pred_class":
            out[key] = (out[key] + 1) % self.cfg.num_classes
        else:
            out[key] = out[key] * 1.01
        return out

    return altered


@pytest.mark.parametrize("cell", ["clusters_k32", "frames_300k"])
@pytest.mark.parametrize("key", ["pred_class", "width", "rotation_deg"])
def test_an_altered_answer_is_not_correct(cell, key, monkeypatch):
    from pointnet_like_pose_estimation_tpu_torch.pipeline.infer import GraspPipeline

    monkeypatch.setattr(GraspPipeline, "_infer", _alter(key))
    assert not _correct(cell)


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert not _correct("train_ssg_b24")


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from pointnet_like_pose_estimation_tpu_torch.models import losses

    def half(log_probs, labels):
        B = log_probs.shape[0] // 2
        return -log_probs[:B].gather(1, labels[:B, None].long()).mean()

    monkeypatch.setattr(losses, "nll_loss", half)
    assert not _correct("train_ssg_b24")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails_a_limit_the_program_keeps(cell):
    """The program's own bfloat16 path in place of the float32 the
    configuration states, judged against the float32 reference."""
    assert not _correct(cell, program_dtype="bfloat16")
