"""The port's spans (``utils/profiling.py`` ``span``) on the CPU: a request
and a train step record their stages under ``torch.profiler``, nested and
in order; with no profiler running no span records anything; the
profiler's flag that turns the spans on follows its start and stop; a span
is a host range and no ``record_function`` annotation; ``idle_by_span``
gives each idle piece to the innermost span open over it."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, make_epoch_runner, make_optimizer
from pointnet_like_pose_estimation_tpu_torch.utils.profiling import SPANS, idle_by_span

PREFIXES = ("serve.", "program.", "train.")
REQUEST = ["serve.upload", "program.replay", "serve.copy_back"]


@pytest.fixture(scope="module")
def pipe():
    p = GraspPipeline.from_random(PipelineConfig(num_points=512), seed=3, device="cpu")
    p.infer_clusters(_clusters(0))          # the bucket's program is made here, not in a profile
    return p


def _clusters(seed, K=2, M=600):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (K, 1, 3)) + 0.05 * rng.standard_normal((K, M, 3))).astype(np.float32)


def _ranges(prof) -> list:
    """The profile's port spans, ``(start, end, name)``, by start."""
    out = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events() if e.name.startswith(PREFIXES)]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def _inside(ranges, outer) -> list:
    """The names of the spans that start and end inside ``outer``, in order."""
    return [r[2] for r in ranges if r is not outer and outer[0] <= r[0] and r[1] <= outer[1]]


def _epoch(steps=3, B=2, N=64):
    cfg = TrainConfig.for_model("rotation", num_points=N, batch_size=B)
    model = build_model("rotation", cfg.num_classes)
    opt, _ = make_optimizer(cfg, model.parameters())
    rng = np.random.default_rng(0)
    M = steps * B + 1
    data = {"points": torch.from_numpy(rng.standard_normal((M, N, 3)).astype(np.float32)),
            "labels": torch.from_numpy(rng.integers(0, cfg.num_classes, M)),
            "rot": torch.from_numpy(rng.uniform(0, 90, (M, 3)).astype(np.float32)),
            "tran": torch.zeros(M, 3), "sign": torch.ones(M), "width": torch.full((M, 1), 0.05)}
    runner = make_epoch_runner(get_model_spec("rotation"), cfg, steps)
    return lambda: runner(model, opt, data, torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def requests(pipe):
    """The profile of two requests."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.infer_clusters(_clusters(1, K=3))
        pipe.infer_clusters(_clusters(2))
    return prof


@pytest.fixture(scope="module")
def epoch():
    """The profile of an epoch of 3 steps (its program made in an epoch before)."""
    run = _epoch()
    run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, steps = run()
    assert steps == 3
    return prof


def test_a_request_records_its_stages_in_order(requests):
    ranges = _ranges(requests)
    assert [r[2] for r in ranges] == 2 * REQUEST
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))     # one after another, none nested


def test_a_step_records_its_draws_and_replay(epoch):
    ranges = _ranges(epoch)
    steps = [r for r in ranges if r[2] == "train.step"]
    assert len(steps) == 3 and len(ranges) == 3 * 3
    for r in steps:
        assert _inside(ranges, r) == ["train.draws", "program.replay"]


def test_no_span_records_without_a_profiler(pipe, monkeypatch):
    """No range of the port's is ever made while no profiler records."""
    def refuse(name, *a, **k):
        raise AssertionError(f"{name} opened with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    out = pipe.infer_clusters(_clusters(4))
    assert out["rotation_matrix"].shape == (2, 3, 3)
    epoch = _epoch()
    assert epoch()[1] == 3 and epoch()[1] == 3


def test_the_profiler_flag_follows_start_and_stop():
    """``span`` reads this private flag: a torch that drops or renames it
    fails here rather than leaving the spans off."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert torch.autograd.profiler._is_profiler_enabled is True
    finally:
        prof.stop()
    assert torch.autograd.profiler._is_profiler_enabled is False


@pytest.mark.parametrize("path", ["requests", "epoch"])
def test_every_recorded_name_is_in_spans(request, path):
    names = {r[2] for r in _ranges(request.getfixturevalue(path))}
    assert names and names <= set(SPANS)


@pytest.mark.parametrize("path", ["requests", "epoch"])
def test_a_span_is_no_user_annotation(request, path):
    """A ``record_function`` range (a user annotation) is drawn on the
    device's timeline over the kernels it launched, where a reader of the
    timeline counts it as work; a span is a host range alone."""
    spans = [e for e in request.getfixturevalue(path).events() if e.name in SPANS]
    assert spans and not any(e.is_user_annotation for e in spans)


def test_idle_by_span_counts_a_cpu_profile(requests):
    """On the CPU nothing runs on a card: the window, first span to last,
    is idle, split by the spans, with nothing outside them but the gap
    between the two requests."""
    got = idle_by_span(requests.events())
    assert {k: v["count"] for k, v in got.items() if k} == {n: 2 for n in REQUEST}
    ranges = _ranges(requests)
    window = (ranges[-1][1] - ranges[0][0]) / 1e6
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(window)
    for name in REQUEST:
        s = [(r[1] - r[0]) / 1e6 for r in ranges if r[2] == name]
        assert got[name]["host_s"] == pytest.approx(sum(s))
        assert got[name]["least_s"] == pytest.approx(min(s))
        assert got[name]["idle_s"] == pytest.approx(sum(s))


def _event(name, start, end, cuda=False, annotation=False):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU,
                                 is_user_annotation=annotation)


# a step 0-100 us holding its draws 10-30 and the replay 40-90; kernels on the card 20-50 and 60-70
STEP = [_event("train.step", 0, 100), _event("train.draws", 10, 30), _event("program.replay", 40, 90),
        _event("kernel_a", 20, 50, cuda=True), _event("kernel_b", 60, 70, cuda=True)]


@pytest.mark.parametrize("events, window, idle", [
    # idle 0-20 (step's own 0-10, draws 10-20), 50-60 and 70-90 (replay), 90-100 (step's own)
    (STEP, None, {"train.step": 20, "train.draws": 10, "program.replay": 30}),
    # a window wider than the spans: the idle outside them goes to None
    (STEP, (-15, 110), {None: 25, "train.step": 20, "train.draws": 10, "program.replay": 30}),
    # a record_function range of the caller's, and its annotation on the card, is no work
    (STEP + [_event("caller", 0, 100, annotation=True), _event("caller", 20, 70, cuda=True, annotation=True)],
     None, {"train.step": 20, "train.draws": 10, "program.replay": 30}),
    # a kernel that runs over the window's start and end is clipped to it
    (STEP + [_event("kernel_c", -5, 5, cuda=True), _event("kernel_d", 95, 120, cuda=True)],
     None, {"train.step": 10, "train.draws": 10, "program.replay": 30}),
], ids=["innermost", "outside", "annotation", "clipped"])
def test_idle_by_span_gives_idle_to_the_innermost_span(events, window, idle):
    got = idle_by_span(events, window)
    assert {k: round(v["idle_s"] * 1e6, 6) for k, v in got.items() if v["idle_s"]} == idle
    assert got["train.step"]["count"] == 1 and got["train.step"]["host_s"] == pytest.approx(100e-6)


def test_idle_by_span_of_a_profile_without_spans():
    assert idle_by_span([_event("kernel_a", 0, 10, cuda=True)]) == {}
    assert idle_by_span([_event("kernel_a", 0, 10, cuda=True)], (0, 20)) == {
        None: {"count": 0, "host_s": 0.0, "least_s": float("inf"), "idle_s": pytest.approx(10e-6)}}
