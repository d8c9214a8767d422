"""Where a grasp request's and an evaluation pass's time goes on the GPU,
for the PyTorch port.

Serves requests of 4 and 32 clusters of 2048 points through
GraspPipeline.from_checkpoints (the five committed checkpoints) under
torch.profiler, and prints for each size: the host-clock time per request,
the device busy share (summed kernel time over wall time: one stream, so
kernels do not overlap), and the device time by kernel, grouped into the
port's two CUDA kernels, matrix products, and everything else. Then the
same for one pass of train/loop.py evaluate over 140 seeded test clouds at
batch 24, for an SSG classifier, an MSG head and a vanilla head from the
committed checkpoints.

Run on a machine with a card: python3 scripts/profile_torch_serving.py

    python3 scripts/profile_torch_serving.py --train pointnet2_cls_ssg [B ...]

profiles train steps instead (train/steps.py make_train_step, weights
initialised from seed 0, batches drawn on the card from the train split of
a seeded dataset of 80 clouds a class, 560 in all, resident there) at each
batch size B (24 and 256 by default): device time of one step by kernel
group (the CUDA kernels, matrix products, gather and scatter, the
reductions (sums, BatchNorm statistics, max), the optimizer, other
elementwise),
launches, and the device busy share.

Each train step is a replay of its training program (a CUDA graph,
train/steps.py) but the first; then one epoch of the epoch runner on the
resident split (train/steps.py make_epoch_runner; divide by its steps).

    python3 scripts/profile_torch_serving.py --train-against build/parent [B ...]

runs that train profile of pointnet2_cls_ssg with the package of another
checkout (say the parent commit unpacked by ``git archive``) and with this
one, in the order other, this, this, other, each in a process of its own
(``--train-root DIR [B ...]`` is one such turn).

    python3 scripts/profile_torch_serving.py --train-dp pointnet2_cls_ssg [B ...]

profiles, at each batch size, the same train step and then the
data-parallel step (parallel/train_parallel.py) in a world of one on NCCL,
its collectives in a group of their own.

    python3 scripts/profile_torch_serving.py --latency-against build/parent

times, without the profiler, the request latency (host clock around
``infer_clusters`` ending in a synchronize, median and least of 30 requests
after 5 warm-up ones, at 4 and 32 clusters of 2048 points) and one
``normalize_cloud`` of ``[32, 1024, 3]`` (device time between two events, and
host clock) with the package of another checkout of the repository (say the
parent commit unpacked by ``git archive``) and with this one, each in a
process of its own, in the order other, this, this, other, within one run on
one card. The checkpoints are this checkout's in every turn.

    python3 scripts/profile_torch_serving.py --profile-against build/parent

runs the requests' and evaluation passes' profile above with the package of
the other checkout and with this one, in the same order, each in a process of
its own (``--profile-root DIR`` is one such turn).
"""

import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package comes from this checkout, or from the one named by --root
PACKAGE_ROOT = (os.path.abspath(sys.argv[2]) if sys.argv[1:2] in (["--root"], ["--profile-root"], ["--train-root"])
                else ROOT)
sys.path.insert(0, PACKAGE_ROOT)

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

CHECKPOINTS = {
    "classifier": "log/classification/r3_pointnet2_cls_ssg/checkpoints/best.msgpack",
    "rotation": "log/pose/r3_rotation/checkpoints/best.msgpack",
    "sign": "log/pose/r3_sign/checkpoints/best.msgpack",
    "translation": "log/pose/r3_translation_ref/checkpoints/best.msgpack",
    "width": "log/pose/r3_width_ref/checkpoints/best.msgpack",
}
EVAL_MODELS = {"pointnet2_cls_ssg": "classification/r3_pointnet2_cls_ssg",
               "sign_msg": "pose/r5_sign_msg", "rotation": "pose/r3_rotation"}
REQUESTS = 5


def group(name: str) -> str:
    if any(t in name for t in ("fps_register", "fps_dist_kernel", "fps_cluster_kernel")):
        return "fps (CUDA kernel)"
    if "ball_query_kernel" in name:
        return "ball_query (CUDA kernel)"
    if any(t in name for t in ("gemm", "Gemm", "sm90_xmma", "cutlass", "addmm")):
        return "matrix products"
    return "other"


def train_group(name: str) -> str:
    """``group`` with its "other" split the way a train step spends it."""
    g = group(name)
    if g != "other":
        return g
    if "bn_relu_" in name:
        return "bn_relu (CUDA kernels: train-mode BatchNorm + ReLU)"
    if any(t in name for t in ("gather", "scatter", "index")):
        return "gather / scatter (index_points and its backward)"
    if "reduce" in name.lower():
        return "reductions (sums, BatchNorm statistics, max over groups)"
    if "multi_tensor_apply" in name:
        return "optimizer (foreach Adam)"
    if "nccl" in name.lower():
        return "collectives (NCCL)"
    return "other elementwise"


def profiled(fn, reps: int, grouping=group) -> dict:
    """``fn`` ``reps`` times under torch.profiler, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = (dev_us / 1e3 / reps, ev.count // reps)
    device_ms = sum(t for t, _ in kernels.values())
    groups = {}
    for name, (t, n) in kernels.items():
        g = groups.setdefault(grouping(name), [0.0, 0])
        g[0] += t
        g[1] += n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "call_ms": wall_ms / reps,
        "device_ms_per_call": device_ms if kernels else "not measured",
        "device_busy_share": device_ms / (wall_ms / reps) if kernels else "not measured",
        "groups_ms_and_launches": groups,
        "top_kernels_ms_and_launches": {k[:90]: v for k, v in top},
    }


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def clusters_of(rng, K):
    return (rng.uniform(-0.5, 0.5, (K, 1, 3))
            + 0.05 * rng.standard_normal((K, 2048, 3))).astype(np.float32)


def latency() -> None:
    """Request latency and the time of one normalize_cloud, no profiler,
    with the package under PACKAGE_ROOT; one JSON line."""
    from pointnet_like_pose_estimation_tpu_torch.ops import normalize_cloud

    paths = {k: os.path.join(ROOT, v) for k, v in CHECKPOINTS.items()}
    pipe = GraspPipeline.from_checkpoints(PipelineConfig(), paths)
    rng = np.random.default_rng(0)
    report = {"card": card_line(), "root": PACKAGE_ROOT}
    for K in (4, 32):
        clusters = clusters_of(rng, K)
        times = []
        for i in range(35):
            t0 = time.perf_counter()
            pipe.infer_clusters(clusters)
            torch.cuda.synchronize()
            if i >= 5:
                times.append(1e3 * (time.perf_counter() - t0))
        report[f"request K={K} M=2048"] = {"median_ms": statistics.median(times), "min_ms": min(times)}
    x = torch.from_numpy(clusters_of(rng, 32)[:, :1024]).cuda()
    for _ in range(5):
        normalize_cloud(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(100):
        normalize_cloud(x)
    end.record()
    end.synchronize()
    report["normalize_cloud [32,1024,3]"] = {
        "device_ms": start.elapsed_time(end) / 100, "host_ms": 1e3 * (time.perf_counter() - t0) / 100}
    print(json.dumps(report), flush=True)


def train_profile(name: str, batch_sizes: list[int], data_parallel: bool = False) -> None:
    """Train steps of ``name`` under torch.profiler at each batch size; with
    ``data_parallel``, each followed by the DP step in a world of one."""
    from pointnet_like_pose_estimation_tpu_torch import parallel
    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.train import (
        TrainConfig,
        build_state,
        make_epoch_runner,
        make_train_step,
    )
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _device_data

    data = _device_data(load_dataset(build_dataset(80, seed=0), "train"), torch.device("cuda"))
    n = data["labels"].shape[0]
    steps = {"train step": make_train_step, "epoch": None}
    if data_parallel:
        parallel.init_process_group("cuda")
        mesh = parallel.make_mesh()
        steps["DP step (NCCL, world 1)"] = lambda spec, cfg: parallel.make_parallel_train_step(spec, cfg, mesh)
    report = {}
    for B in batch_sizes:
        for kind, make_step in steps.items():
            cfg = TrainConfig.for_model(name, batch_size=B)
            spec, state = build_state(cfg)
            if make_step is None:                   # an epoch of the runner on the resident split
                run_epoch = make_epoch_runner(spec, cfg, n // B)

                def one():
                    run_epoch(state.model, state.optimizer, data, state.generator)

                kind = f"epoch ({n // B} steps)"
            else:
                step = make_step(spec, cfg)

                def one():
                    idx = torch.randint(0, n, (B,), generator=state.generator, device="cuda")
                    step(state.model, state.optimizer, {k: v[idx] for k, v in data.items()}, state.generator)

            key = f"{kind} {name} B={B}"
            report[key] = profiled(one, REQUESTS, train_group)
            print(json.dumps({key: report[key]}, indent=1), flush=True)
            one = state = step = run_epoch = None   # and the step's graph pool with them
            gc.collect()
            torch.cuda.empty_cache()
    if data_parallel:
        torch.distributed.destroy_process_group()
    print(json.dumps({"card": card_line(), "profile": report}))


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_serving: no CUDA device")
    if sys.argv[1:2] in (["--train"], ["--train-dp"]):
        return train_profile(sys.argv[2], [int(b) for b in sys.argv[3:]] or [24, 256],
                             data_parallel=sys.argv[1] == "--train-dp")
    if sys.argv[1:2] == ["--train-root"]:
        print(json.dumps({"package": PACKAGE_ROOT}), flush=True)
        return train_profile("pointnet2_cls_ssg", [int(b) for b in sys.argv[3:]] or [24, 256])
    if sys.argv[1:2] == ["--train-against"]:
        me = [sys.executable, os.path.abspath(__file__), "--train-root"]
        sys.exit(max(subprocess.run([*me, root, *sys.argv[3:]]).returncode
                     for root in (sys.argv[2], ROOT, ROOT, sys.argv[2])))
    if sys.argv[1:2] in (["--latency-against"], ["--profile-against"]):
        turn = "--root" if sys.argv[1] == "--latency-against" else "--profile-root"
        me = [sys.executable, os.path.abspath(__file__), turn]
        sys.exit(max(subprocess.run([*me, root]).returncode
                     for root in (sys.argv[2], ROOT, ROOT, sys.argv[2])))
    if sys.argv[1:2] == ["--root"]:
        return latency()
    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, evaluate, load_checkpoint

    paths = {k: os.path.join(ROOT, v) for k, v in CHECKPOINTS.items()}
    pipe = GraspPipeline.from_checkpoints(PipelineConfig(), paths)
    rng = np.random.default_rng(0)
    report = {}
    for K in (4, 32):
        clusters = clusters_of(rng, K)
        report[f"K={K} M=2048"] = profiled(lambda: pipe.infer_clusters(clusters), REQUESTS)
        print(json.dumps({f"K={K} M=2048": report[f"K={K} M=2048"]}, indent=1), flush=True)

    test = load_dataset(build_dataset(80, seed=0), "test")
    for name, experiment in EVAL_MODELS.items():
        model, _ = load_checkpoint(
            os.path.join(ROOT, "log", experiment, "checkpoints", "best.msgpack"), build_model(name))
        cfg = TrainConfig.for_model(name, batch_size=24)
        key = f"evaluate {name}, {len(test)} clouds"
        report[key] = profiled(lambda: evaluate(cfg, model, test), REQUESTS)
        print(json.dumps({key: report[key]}, indent=1), flush=True)
    print(json.dumps({"card": card_line(), "package": PACKAGE_ROOT, "profile": report}))


if __name__ == "__main__":
    main()
