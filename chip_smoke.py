#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. the card, as nvidia-smi and torch report it;
2. build every CUDA kernel from csrc/ (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card, on seeded
   clouds, with exact integer equality: FPS on its register path at C = 3
   and C = 10, on its cluster path for 4 clouds of 5000 points and on its
   shared-memory path for 12 of them and at C = 6; the ball query at
   3, 7 and 10 channels, one to five scales, N and S off the tile sizes, a
   cloud too large for shared memory and empty balls. Then its time at the
   shapes one request of 32 clusters of 2048 points gives it, for the ball
   query also at the MSG levels and at the 10 spliced channels of a pose
   head, for FPS also in microseconds per step beside the path fps_plan
   picks (the head's C = 10 calls must take a register path). A kernel's time is the
   device time of a call (launches captured in a CUDA graph and replayed
   between two events), beside its bound; for the ball query the time of a
   call launched from Python in a loop stands beside it; and FPS's shared
   path, off the main path, timed beside its plain version at
   SHARED_FPS_SHAPES; the fused train-mode BatchNorm + ReLU against the
   plain pair at SA1's shapes (forward bit for bit, gradients within
   BN_RELU_GRAD_TOL) and its forward and backward timed at every pair of
   SSG's train step at B = 24 beside the plain pair (library_ms); the kNN
   query at the nine shapes of a 32-cluster Point Transformer request
   (bench_port/harness/bounds_pt.py knn_calls), with tied distances,
   against its plain version (indices equal) and timed beside its bound;
   Point Transformer's one-pass attention on the 13 layers' own inputs of
   one 32-cluster request, against its plain version in float32 and in
   float64 (PT_ATTENTION_ERR), and timed beside its bound;
4. serve requests through GraspPipeline.from_checkpoints on the five
   committed checkpoints: the replay clusters of tests/fixtures and three
   seeded batches (M > 1024, M < 1024, and one more M > 1024 in the bucket
   of the first). Each request is a replay of its bucket's program (a CUDA
   graph, utils/programs.py): its launch counts are the program's
   launches per run times its runs (a capture's warm-up runs too), and the
   counts must show both kernels ran, and one replay traced by
   torch.profiler must run on the card the 3 FPS and 2 ball-query kernels
   its capture recorded; every output is held against the
   program's function run eagerly on the card on the same inputs
   (integers equal, floats within PROGRAM_TOL), the same pipeline on the
   CPU and the replay request against the recorded JAX outputs
   (pred_class equal, floats within rtol = atol = 1e-3: TF32 is off, so
   only summation order and last-bit FPS ties differ). Then latency per
   request of a replay and of the eager function, in turns, at 4 and 32
   clusters, peak device memory, and the programs' captures, capture time,
   replays and pool. Then one request of 32 clusters of 2048 points on
   Point Transformer (PipelineConfig(classifier="point_transformer_cls"),
   seeded weights), a replay of a captured program, with every counter set
   to 0 just before it: it must count the 5 FPS, 9 kNN, 13 attention
   passes and the eval BatchNorm + ReLU launches and the grouped bytes its
   program records,
   one replay traced by torch.profiler must run those kernels, and its
   outputs are held against its function run eagerly on the card;
5. the fused set-abstraction kernel: its MMA fragment layout on one
   16x8x8 tile against a float64 product; then against its plain version
   at the shapes of the four SA calls of the two executors (B = 8), with
   empty balls, with S no multiple of the centroid tile and with K no
   multiple of 8: selected neighbours exact, features within FUSED_TOL
   (the products are error-compensated TF32 on the tensor cores, so the
   features are no longer equal bit for bit); then the same two checks
   and its time at the path's own calls (B = 32, N = 1024, the executors'
   folded weights) beside the f32 bound and the tensor-core bound, and no
   share of a bound may read over 100%;
6. the fused eval executors (models/fast_infer.py), each forward a
   replay of its (B, N) program: the SSG one on the committed r3
   classifier (two seeded batches in one bucket), the MSG one on seeded
   weights with nontrivial BatchNorm. The launch counts must show 2
   fused-SA and 2 FPS launches and no ball query per run of a program;
   outputs are held against the executor's function run eagerly on the
   card (PROGRAM_TOL), the unfused models on the card and the executors on
   the CPU (pred equal, log_probs within TOL), the replay classes against
   the recorded JAX ones. Then latency and peak device memory of the
   executor's replay, its eager function and the unfused model at B = 32
   and 256.

7. the evaluation path (cli.py generate and eval, data/dataset.py
   build_dataset, train/loop.py evaluate): a seeded dataset built on the
   card by the generate command, then every model of EVAL_MODELS evaluated
   at batch 24 and full width, from the committed checkpoints or seeded
   weights, with the launch counts checked and the results held against
   the same code on the CPU; the eval command on every committed
   checkpoint, held against evaluate; a request through a pipeline with
   the MSG classifier; eval throughput per model, through the eval program
   (train/loop.py: one CUDA graph a model and batch shape, captured at the
   first batch) beside the same batches run eagerly, whose figures it must
   equal.

8. the training path (cli.py train, train/loop.py train, train/steps.py
   make_train_step): one train step of pointnet2_cls_ssg, sign_msg,
   pointnet_cls and rotation_ssg at batch 24 on the card against the same
   step on the CPU, from the committed checkpoints (seeded weights with
   nontrivial BatchNorm for the last two), on the same batch of the
   generated dataset with
   the same augmentation and dropout draws (made once on the CPU); the
   card's step is a replay of its training program (captured at a first
   call, after which the model and optimizer are put back to the start in
   place), held also against the eager step on the card (loss, metric, BN
   statistics, gradients by TRAIN_TOL and TIED_GRADIENTS): loss,
   metric and the updated BatchNorm statistics within TRAIN_TOL, every
   gradient within TRAIN_TOL element by element (relative, and absolute
   times the model's largest gradient element) or, where a max over a
   group routes it otherwise (TIED_GRADIENTS, named per model), within
   twice the largest gap measured, relative to its norm; the card's
   Linear layers computing in float32; the
   parameters after the Adam step within TRAIN_TOL but for those at Adam's
   rounding floor (pre-BN biases, gradients smaller than twice the two
   sides' difference), held to one step of the learning rate; FPS and the
   ball query launched twice a
   pointnet2_cls_ssg and rotation_ssg step, once a sign_msg step and never
   a pointnet_cls step. Then the train command
   end to end on the generated dataset: pointnet2_cls_ssg and the vanilla
   rotation head for 2 epochs, each resumed from latest.pt for a third,
   history.json with epochs 0, 1, 2, the classifier's loss falling, the
   eval command on best.pt equal to evaluate (every epoch's steps and eval
   batches replays of their programs, the FPS launches exactly one run a
   call; the fused BatchNorm + ReLU launched on the train path); one replay
   of a train step under torch.profiler, which must run on the card the 2
   FPS and 2 ball-query kernels and the 9 fused BatchNorm + ReLU forwards
   its capture recorded, and no plain pair;
   then training clouds/s and peak device memory of
   pointnet2_cls_ssg at batch 24 and 256 (CUDA events over spans of 2 s or
   more, median of 3, batches gathered on the card from the resident
   split), in float32 and bfloat16 in turns, the eager step and then the
   programmed one, with each training cache's captures, capture seconds,
   replays and pool MB.

9. bfloat16 (BatchNorm in float32): one bf16 train step of
   pointnet2_cls_ssg on the card against the CPU's bf16 and f32 steps
   (BF16_* bounds), its Linear layers computing in bf16 and its gradients
   nearer the CPU's bf16 step than its f32 one; evaluate of the committed r5_pn2_ssg_bf16 checkpoint in
   bf16 against the CPU and its eval throughput beside f32; a bf16 request
   from the r3 checkpoints against the eager run on the card and the CPU,
   and request latency (replay and eager) at 4 and 32 clusters in f32 and
   bf16.

10. the raw-frame path (cli.py infer, GraspPipeline.__call__ and stream,
   pipeline/preprocess.py): cli infer on the replay scene on the card
   against --device cpu; the 28k and 300k synthetic frames (FRAME_SEEDS
   seeds each) served against the CPU, the cleaned points equal bit for
   bit, and against the scene program's function run eagerly on the card
   (PROGRAM_TOL), each frame's launches its program's per run times its
   runs; a frame whose RANSAC draws hold a triple that repeats a point is
   lost, as the reference loses it, and is checked to be; latency by stage
   (clip, clean, DBSCAN, infer as a replay and as the eager function) of
   the first frame served and __call__ latency on its captured program;
   then a camera's stream of one scene, each frame distinct (its own depth
   noise and dropped points): CAMERA_FRAMES frames through __call__ of a
   fresh pipeline, each held against the eager run on the card, with the
   captures they cause, which frames paid one and the frame latency with
   them included (median, p90, max), the distinct program keys beside the
   JAX package's; then stream's served frames/s over two windows of new
   frames of that camera, with the frames lost and the captures in each,
   against the 33 ms budget.

11. the data phase (ROADMAP items 6 and 11): FPS past the shared path's
   57,856 points on the kernel's cluster path (one cloud over a
   thread-block cluster) at FPS_GLOBAL_SHAPES, and on its global path
   (distances in device memory) one point above the cluster's limit,
   against its plain version, indices equal, each with the path fps_plan
   picks and the time of a call in a CUDA graph beside its bound; then, with the launch
   counts set to 0: a frame with an object of 70,000 points served on the
   card against --device cpu (the plane removal alone, classes equal, floats
   within TOL, the clusters kept) and with the radius clean on the card
   (the scene program, its truncation FPS on the cluster path inside the
   graph, against the eager run), its stages timed; ModelNet's uniform resampling of 10,000-point clouds
   with normals on the card against the CPU, bit for bit, and one epoch of
   pointnet2_cls_ssg on it; the reference's txt layout written from a
   dataset built on the card, read back by load_reference_layout equal to a
   plain np.loadtxt reader, and one epoch of rotation on it; cli sweep
   (14 jobs of one epoch, every figure finite, a second call that trains
   nothing, another --epochs refused); a request of 4 clusters timed by
   utils.profiling.sustained_time beside the smoke's own loop.

12. the parallel phase (ROADMAP item 10, parallel/): ranks spawned from
   this script on the one card, joined through a FileStore under
   build/chip_smoke_parallel, every rank's exit code and report checked.
   World size 1 on NCCL: one DP train step of pointnet2_cls_ssg at batch 24
   from the r3 checkpoint against the single-process step on the card on
   the same draws (the train phase's rule: loss, metric, BN statistics
   within TRAIN_TOL, gradients element by element or by TIED_GRADIENTS),
   with the launch counts set to 0 just before it and read just after (FPS
   and the ball query twice each) and its collective traffic; training
   clouds/s of the DP and the single step at B = 24 and 256, in turns.
   Two ranks on gloo sharing the card: the same step on 12 rows a rank
   against the single step; sharded FPS at 1 x 300,000 -> 512 equal to the
   FPS kernel (its cluster path), ms a step beside the kernel's; the sharded
   groupings at SSG SA1 and MSG SA1 (24 x 1024 -> 512) equal to the
   kernels' outputs; a point-sharded forward of the r3 classifier (two
   dispatches, classes equal, log-probs within SHARDED_FORWARD_TOL); one TP
   step of rotation on {"data": 1, "model": 2} against the single step
   (loss within TP_LOSS_RTOL, BN statistics within TP_STATS_*). Then
   torchrun --nproc-per-node 1 ... cli train --data-parallel for 2 epochs
   and resumed for a third, cli eval of its best.pt equal to evaluate; and
   MultiHeadParallel on the r3 checkpoints equal to infer_clusters, its
   latency beside it at 4 and 32 clusters.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINTS = {
    "classifier": "log/classification/r3_pointnet2_cls_ssg/checkpoints/best.msgpack",
    "rotation": "log/pose/r3_rotation/checkpoints/best.msgpack",
    "sign": "log/pose/r3_sign/checkpoints/best.msgpack",
    "translation": "log/pose/r3_translation_ref/checkpoints/best.msgpack",
    "width": "log/pose/r3_width_ref/checkpoints/best.msgpack",
}
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_clusters.npz")
TOL = 1e-3
# the fused kernel against its plain version: three-product TF32 on the
# tensor cores, summed in f32 in another order than the plain product
FUSED_TOL = 1e-4
# the MMA self-test: one 16x8x8 tile against the float64 product
MMA_TOL = 1e-5
# a program's replay (a CUDA graph) against its function run eagerly on the
# card on the same inputs: the same kernels on the same data, so the floats
# are expected bit for bit; the gap measured is printed
PROGRAM_TOL = 1e-5
# Point Transformer's one-pass attention against float64: its distance over
# the plain float32 version's, both float32 sums in other orders (the
# kernel's chains of FMAs against cuBLAS's blocked products)
PT_ATTENTION_ERR = 10.0
# the train step on the card against the CPU: loss, metric, BN statistics,
# parameters, and every gradient element where the tensor allows. A gradient
# element is held to TRAIN_TOL relative and TRAIN_TOL times the model's
# largest gradient element (at least 1) absolute: an element is a sum over the
# batch of terms of that size, and where they cancel its float32 rounding is
# set by the terms, not by the sum. Only rotation_ssg's scale is above 1 (its
# loss is about 1,300): head.fc_2.weight, 6.1e-6 apart by relative L2, misses
# 1e-4 absolute by 1.6e-4 at an element that cancels to well under 1; the
# pre-BN biases, whose true gradient is 0, hold only rounding noise there.
TRAIN_TOL = 1e-4
# model -> (gradient tensors, by name or name prefix, held by their relative
# L2 error instead of TRAIN_TOL element by element; that bound). A max over
# a group passes its gradient to one member; where the two largest values of
# a group lie within the two devices' rounding of each other (cuBLAS and the
# CPU sum a product in other orders), each device may pick another, and the
# tensors upstream of that max part. Any other tensor that misses TRAIN_TOL
# fails the run. Each bound is twice the largest gap measured (H100 against
# the CPU, this script's batch and tests/test_torch_cuda.py's):
# - sign_msg, its 128-neighbour scale (8e-5 of those maxima within 1e-5
#   relative on the CPU): 1.1e-3 to 2.3e-3;
# - pointnet_cls, the encoder up to its last BatchNorm (maxima over 1024
#   points of 1024 channels in both T-Nets and the encoder): up to 7.3e-3,
#   where the CPU's own float32 step lies 4e-3 to 1e-2 from its float64 step;
# - rotation_ssg on seeded weights (loss about 1,300): the SA levels below
#   the global max, 4.5e-4 to 7.1e-3.
TIED_GRADIENTS = {
    "sign_msg": (("sa1.mlp_2.dense_0.weight", "sa1.mlp_2.dense_1.weight", "sa1.mlp_2.dense_2.weight",
                  "sa1.mlp_2.bn_0.weight", "sa1.mlp_2.bn_1.bias"), 4.6e-3),
    "pointnet_cls": (("encoder.tnet_input.", "encoder.conv1.", "encoder.tnet_feature.", "encoder.conv2.",
                      "encoder.conv3."), 1.5e-2),
    "rotation_ssg": (("sa1.", "sa2.", "sa_global.mlp.dense_0.", "sa_global.mlp.bn_0.", "sa_global.mlp.dense_1.",
                      "sa_global.mlp.bn_1."), 1.5e-2),
}
# One bfloat16 train step on the card against the same step on the CPU. The
# card's and the CPU's bfloat16 products accumulate in other orders and round
# to neighbouring bfloat16 values, so, as in tests/test_torch_bf16.py
# (the port against JAX): loss within BF16_LOSS_TOL, BatchNorm statistics
# (float32) within BF16_STATS_TOL, all gradients together within
# BF16_GRAD_REL_L2 of the CPU's bfloat16 ones and nearer them than the
# CPU's float32 ones, and every gradient tensor's
# relative L2 gap from the CPU's float32 step within twice the CPU's own
# bfloat16 gap, or within BF16_GRAD_FLOOR where that is smaller. The floor
# is about twice the largest gap measured on the H100, 2.6e-2 at the output
# layer's bias (head.fc_2.bias), whose gradient is a sum over the batch of
# bfloat16 terms that cancel to a few percent of their size; every other
# tensor stayed within 1e-2 or twice the CPU's gap. BF16_GRAD_REL_L2 lies
# between the card's measured 0.114 and the CPU's own bfloat16-to-float32
# gap, 0.225, so that a card step that ran in float32 fails it; the step
# also checks that the card's Linear layers gave bfloat16.
BF16_LOSS_TOL, BF16_STATS_TOL, BF16_GRAD_REL_L2, BF16_GRAD_FLOOR = 5e-3, 5e-3, 0.17, 5e-2
# published H100 SXM peaks (NVIDIA data sheet): HBM rate, f32 outside the
# tensor cores, dense TF32 on them
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# (B, N, C, S) of FPS's shared path, timed beside its plain version
SHARED_FPS_SHAPES = ((9, 8192, 3, 256), (32, 8192, 10, 256))
# (radii, ks) of the set-abstraction levels of the SSG and MSG models
SSG_SA1, SSG_SA2 = ((0.2,), (32,)), ((0.4,), (64,))
MSG_SA1, MSG_SA2 = ((0.1, 0.2, 0.4), (16, 32, 128)), ((0.2, 0.4, 0.8), (32, 64, 128))
# (level, rows, widths) of the SSG classifier's shared MLPs in a train step
# at B = 24: each Linear's output [rows, width] goes through a train-mode
# BatchNorm + ReLU
SSG_B24_BN = (("SA1", 24 * 512 * 32, (64, 64, 128)), ("SA2", 24 * 128 * 64, (128, 128, 256)),
              ("SA3", 24 * 128, (256, 512, 1024)))
# the fused BatchNorm + ReLU's gradients against the plain pair's on the
# card, relative to each tensor's norm (the forward is held bit for bit)
BN_RELU_GRAD_TOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def unit_clouds(rng, B, N):
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    return x / np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]


def spliced_clouds(rng, B, N, P):
    """Unit clouds; for P > 3 a one-hot class, one per cloud, on the
    channels after the coordinates, as the pose heads see them."""
    import torch

    x = unit_clouds(rng, B, N)
    if P > 3:
        onehot = np.zeros((B, N, P - 3), np.float32)
        onehot[np.arange(B), :, rng.integers(0, P - 3, B)] = 1.0
        x = np.concatenate([x, onehot], axis=-1)
    return torch.from_numpy(x)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(fn, reps: int) -> float:
    """Device time of one call of a kernel wrapper: ``reps`` calls captured
    in one CUDA graph and replayed between two events, so that the host's
    time to enqueue a launch (tens of microseconds through Python) does not
    hide a kernel that takes less."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fps_path(N, C, B) -> str:
    """The name of the FPS kernel's path that ``fps_plan`` picks."""
    from pointnet_like_pose_estimation_tpu_torch.kernels import fps as F

    code = F.fps_plan(N, C, B)[1]
    return {F.SHARED_PATH: "shared", F.CLUSTER_PATH: "cluster", F.GLOBAL_PATH: "global"}.get(
        code, f"register C={C}")


def fps_bound_ms(B, N, C, S):
    nbytes = 4 * (B * N * C + B + B * S)
    ops = B * S * N * (3 * C + 1)                 # sub, mul, add per channel; min
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def scanned_points(points, centroids, radii, ks, one_pass: bool = False) -> int:
    """Points a ball scan in index order visits on this data: up to the
    K-th in-ball point, or all N, per centroid and scale. With ``one_pass``
    one scan serves every scale of a centroid, so it needs the largest of
    the scales' counts, not their sum."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.ops import square_distance

    N = points.shape[1]
    d2 = square_distance(centroids, points)
    per_scale = []
    for r, k in zip(radii, ks):
        r2 = float(np.float32(r * r))
        count = torch.cumsum((d2 <= r2).int(), dim=-1)
        per_scale.append(torch.clamp((count < k).sum(-1) + 1, max=N))
    per_scale = torch.stack(per_scale)
    return int(per_scale.amax(0).sum() if one_pass else per_scale.sum())


def ball_query_bound_ms(points, centroids, radii, ks):
    """Bytes: points, centroids and indices once. Operations: 2P once per
    point for |p|^2, and 2P+2 per (centroid, point) pair the scan of this
    data needs: P multiplies and P-1 adds for the inner product (the factor
    -2 folds into the centroid), the two norms added, the compare. One scan
    serves all scales, so per centroid the pairs run up to the K-th in-ball
    point of the scale that needs the most."""
    B, N, P = points.shape
    S = centroids.shape[1]
    nbytes = 4 * (B * N * P + B * S * P + B * S * sum(ks))
    pairs = scanned_points(points, centroids, radii, ks, one_pass=True)
    ops = pairs * (2 * P + 2) + B * N * 2 * P
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fused_sa_bound_ms(ptsfeat, centroids, radii, ks, layer_widths):
    """Bytes: ptsfeat, centroids, weights and output once. Operations: the
    ball scan this data needs (12 per point visited), then per neighbour
    row and layer 2*Cin*Cout for the product and 2*Cout for bias and relu,
    and one max per row and output channel."""
    B, N, P = ptsfeat.shape
    S = centroids.shape[1]
    row_ops, n_weights = 0, 0
    for K, widths in zip(ks, layer_widths):
        cin, per_row = P, 0
        for cout in widths:
            per_row += 2 * cin * cout + 2 * cout
            n_weights += cin * cout + cout
            cin = cout
        row_ops += K * (per_row + widths[-1])
    c_total = sum(ws[-1] for ws in layer_widths)
    nbytes = 4 * (B * N * P + B * S * 3 + n_weights + B * S * c_total)
    ops = B * S * row_ops + 12 * scanned_points(ptsfeat[..., :3], centroids, radii, ks)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fused_sa_tc_bound_ms(ptsfeat, centroids, ks, layer_widths) -> float:
    """The tensor-core bound of the kernel's arithmetic: three TF32 products
    for each f32 product of the MLP (2*Cin*Cout per neighbour row and
    layer), over the dense TF32 peak. A first layer of three channels is
    left out: the kernel runs it as f32 multiply-adds, not on the tensor
    cores."""
    B, _, P = ptsfeat.shape
    per_cloud = 0
    for K, widths in zip(ks, layer_widths):
        cin = P
        for cout in widths:
            if cin != 3:
                per_cloud += K * 2 * cin * cout
            cin = cout
    return 1e3 * 3 * B * centroids.shape[1] * per_cloud / TF32_FLOP_PER_S


def path_calls(rng, device):
    """The FPS and ball-query calls that are timed: the launches of one
    request of 32 clusters of 2048 points, the MSG levels on the same
    clouds, and SA1 and SA2 of a three-level pose head on the clouds spliced
    with a one-hot class (10 channels, all of them coordinates). Returns
    ``(fps_calls, ball_query_calls)``."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.data.augment import splice_onehot
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
    from pointnet_like_pose_estimation_tpu_torch.ops import index_points, normalize_cloud

    raw = torch.from_numpy(
        (rng.uniform(-0.5, 0.5, (32, 1, 3)) + 0.05 * rng.standard_normal((32, 2048, 3)))
        .astype(np.float32)).to(device)
    xyz = normalize_cloud(index_points(raw, fps(raw, 1024)))
    c1 = index_points(xyz, fps(xyz, 512))
    c2 = index_points(c1, fps(c1, 128))
    labels = torch.from_numpy(rng.integers(0, 7, 32)).to(device)
    xyz10 = splice_onehot(xyz, labels, 7)
    c10 = index_points(xyz10, fps(xyz10, 512))
    c10_2 = index_points(c10, fps(c10, 128))
    fps_calls = [("resample", raw, 1024), ("SA1", xyz, 512), ("SA2", c1, 128),
                 ("head SA1, C = 10", xyz10, 512), ("head SA2, C = 10", c10, 128)]
    bq_calls = [("SSG SA1", xyz, c1, *SSG_SA1), ("SSG SA2", c1, c2, *SSG_SA2),
                ("MSG SA1", xyz, c1, *MSG_SA1), ("MSG SA2", c1, c2, *MSG_SA2),
                ("head SA1, P = 10, SSG scale", xyz10, c10, *SSG_SA1),
                ("head SA1, P = 10, MSG scales", xyz10, c10, *MSG_SA1),
                ("head SA2, P = 10, SSG scale", c10, c10_2, *SSG_SA2),
                ("head SA2, P = 10, MSG scales", c10, c10_2, *MSG_SA2)]
    return fps_calls, bq_calls


def kernel_phase(device) -> list[dict]:
    """Exactness at the path, MSG and empty-ball shapes; times at the
    shapes of one request of 32 clusters of 2048 points."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import (
        ball_query_multi,
        ball_query_plan,
        ball_query_reference,
    )
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps, fps_plan, fps_reference
    from pointnet_like_pose_estimation_tpu_torch.ops import index_points

    rng = np.random.default_rng(0)
    err = {"fps": 0.0, "ball_query": 0.0}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape, f"{name} {what}: shape/dtype")
        diff = float((got.long() - want.long()).abs().max())
        err[name] = max(err[name], diff)
        check(diff == 0, f"{name} {what}: kernel differs from its plain version (max {diff})")
        log(f"  {name} {what}: exact")

    # the register path at C = 3 and 10, the cluster path for few clouds above it, the shared
    # path for many clouds above it and at C = 6
    for B, N, C, S, start in [(8, 1024, 3, 512, 0), (8, 512, 3, 128, 0), (8, 2048, 3, 1024, 0),
                              (8, 4096, 3, 1024, "per-cloud"), (4, 5000, 3, 512, "per-cloud"),
                              (12, 5000, 3, 512, "per-cloud"), (4, 1000, 6, 256, 0),
                              (4, 1024, 10, 512, 0), (8, 512, 10, 128, 0), (4, 2048, 10, 1024, 0)]:
        pts = torch.from_numpy(np.concatenate(
            [unit_clouds(rng, B, N), rng.standard_normal((B, N, C - 3)).astype(np.float32)], -1)
        ).to(device)
        st = torch.from_numpy(rng.integers(1, N, B).astype(np.int32)).to(device) if start else 0
        same("fps", fps(pts, S, st), fps_reference(pts, S, st),
             f"B={B} N={N} C={C} S={S} start={'per-cloud' if start else 0} plan={fps_plan(N, C, B)} "
             f"({fps_path(N, C, B)} path)")

    # what, B, N, P, S, radii, ks, empty; the one-hot channels of P = 10 differ per cloud
    cases = [
        ("SA1", 8, 1024, 3, 512, SSG_SA1[0], SSG_SA1[1], False),
        ("SA2", 8, 512, 3, 128, SSG_SA2[0], SSG_SA2[1], False),
        ("MSG SA1", 8, 1024, 3, 512, MSG_SA1[0], MSG_SA1[1], False),
        ("MSG SA2", 8, 512, 3, 128, MSG_SA2[0], MSG_SA2[1], False),
        ("P = 10, SSG scale", 8, 1024, 10, 512, SSG_SA1[0], SSG_SA1[1], False),
        ("P = 10, MSG scales", 8, 1024, 10, 512, MSG_SA1[0], MSG_SA1[1], False),
        ("P = 10, SA2, SSG scale", 8, 512, 10, 128, SSG_SA2[0], SSG_SA2[1], False),
        ("P = 10, SA2, MSG scales", 8, 512, 10, 128, MSG_SA2[0], MSG_SA2[1], False),
        ("P = 7 (any-P instance), two scales", 4, 300, 7, 77, (0.3, 0.6), (8, 24), False),
        ("five scales", 2, 512, 3, 64, (0.1, 0.2, 0.3, 0.4, 0.5), (4, 8, 16, 32, 64), False),
        ("N = 1000", 8, 1000, 3, 512, MSG_SA1[0], MSG_SA1[1], False),
        ("ragged S = 100", 8, 1024, 3, 100, SSG_SA1[0], SSG_SA1[1], False),
        ("cloud above shared memory", 2, 40000, 3, 64, (0.05, 0.1), (16, 32), False),
        ("600 neighbours, one thread a centroid", 2, 4096, 3, 40, (0.3,), (600,), False),
        ("empty balls", 8, 1024, 3, 512, SSG_SA1[0], SSG_SA1[1], True),
        ("empty balls, three scales", 8, 1024, 3, 512, MSG_SA1[0], MSG_SA1[1], True),
    ]
    for what, B, N, P, S, radii, ks, empty in cases:
        pts = spliced_clouds(rng, B, N, P).to(device)
        idx = torch.from_numpy(np.stack([rng.permutation(N)[:S] for _ in range(B)])).to(device)
        cent = index_points(pts, idx) + (4.0 if empty else 0.0)
        got = ball_query_multi(pts, cent, radii, ks)
        same("ball_query", got, ball_query_reference(pts, cent, radii, ks),
             f"{what} N={N} P={P} S={S} radii={radii} ks={ks} plan={tuple(ball_query_plan(N, P, ks))}")
        if empty:
            check(bool((got == N - 1).all()), "empty balls: output is not N-1")

    # the shared path off the main path (more than 8 clouds of 4097-57,856
    # points, or C outside 3 and 10): its time and its plain version's
    for B, N, C, S in SHARED_FPS_SHAPES:
        pts = torch.from_numpy(np.concatenate(
            [unit_clouds(rng, B, N), rng.standard_normal((B, N, C - 3)).astype(np.float32)], -1)).to(device)
        check(fps_path(N, C, B) == "shared", f"fps {B} x {N} x {C}: {fps_path(N, C, B)} path, not shared")
        bound, by = fps_bound_ms(B, N, C, S)
        row = {"shape": [B, N, C, S], "ms": cuda_graph_ms(lambda: fps(pts, S), 5),
               "plain_ms": cuda_ms(lambda: fps_reference(pts, S), 1), "bound_ms": bound, "bound_by": by}
        log(f"  time fps shared path {json.dumps(row)}")

    fps_calls, bq_calls = path_calls(rng, device)

    entries = []
    shapes = []
    for what, pts, S in fps_calls:
        B, N, C = pts.shape
        if C == 10:
            check(fps_plan(N, C, B)[1] > 0, f"fps {what}: plan {fps_plan(N, C, B)} is not a register path")
        bound, by = fps_bound_ms(B, N, C, S)
        ms = cuda_graph_ms(lambda: fps(pts, S), 10)
        shapes.append({"call": what, "shape": [B, N, C, S], "plan": list(fps_plan(N, C, B)),
                       "path": fps_path(N, C, B), "ms": ms,
                       "plain_ms": cuda_ms(lambda: fps_reference(pts, S), 1),
                       "bound_ms": bound, "bound_by": by, "us_per_step": 1e3 * ms / S})
    entries.append(("fps", "pointnet_like_pose_estimation_tpu_torch/kernels/csrc/fps.cu",
                    "pointnet_like_pose_estimation_tpu/kernels/fps.py:35", shapes,
                    "32 clusters x 2048 points, and the SA1 and SA2 calls of a head on the spliced cloud"))
    shapes = []
    for what, pts, cent, radii, ks in bq_calls:
        bound, by = ball_query_bound_ms(pts, cent, radii, ks)
        ms = cuda_graph_ms(lambda: ball_query_multi(pts, cent, radii, ks), 20)
        host_ms = cuda_ms(lambda: ball_query_multi(pts, cent, radii, ks), 50)
        check(ms >= bound, f"ball_query {what}: {ms} ms reads over 100% of its bound {bound} ms")
        shapes.append({"call": what, "shape": [*pts.shape, cent.shape[1], *ks], "ms": ms,
                       "ms_with_host_enqueue": host_ms,
                       "plain_ms": cuda_ms(lambda: ball_query_reference(pts, cent, radii, ks), 3),
                       "bound_ms": bound, "bound_by": by})
    entries.append(("ball_query", "pointnet_like_pose_estimation_tpu_torch/kernels/csrc/ball_group.cu",
                    "pointnet_like_pose_estimation_tpu/kernels/ball_group.py:44", shapes,
                    "one call at each of the eight shapes, 32 clouds"))

    return [kernel_entry(name, source, replaces, err[name], shapes, per)
            for name, source, replaces, shapes, per in entries] + [bn_relu_entry(device), bn_relu_eval_entry(device),
                                                                   bn_relu_eval_gather_entry(device), knn_entry(device),
                                                                   pt_attention_entry(device)]


def bn_relu_entry(device) -> dict:
    """The fused train-mode BatchNorm + ReLU (kernels/bn_relu.py) against
    the plain pair, torch.relu of BatchNormF32 through autograd, on the card
    at the SA1 shapes (output and running statistics bit for bit, dx and the
    parameters' gradients by BN_RELU_GRAD_TOL of their norms, two calls the
    same bits), then the time of its forward (with its torch.var_mean) and
    backward at every pair of SSG's train step at B = 24 (a call in a CUDA
    graph) beside its bound (each input read once and each output written
    once at the HBM rate), its plain version and the plain pair (library_ms,
    which the port no longer calls in training)."""
    import copy

    import torch

    from pointnet_like_pose_estimation_tpu_torch.kernels import bn_relu as fused
    from pointnet_like_pose_estimation_tpu_torch.nn import BatchNormF32

    def pair(R, C):
        g = torch.Generator(device=device).manual_seed(R + C)
        x = (torch.randn(R, C, generator=g, device=device) * (torch.rand(C, generator=g, device=device) + 0.1)
             + torch.randn(C, generator=g, device=device))
        bn = BatchNormF32(C).to(device)
        with torch.no_grad():
            bn.weight.copy_(torch.rand(C, generator=g, device=device) + 0.5)
            bn.bias.copy_(torch.rand(C, generator=g, device=device) - 0.5)
        return x, torch.randn(R, C, generator=g, device=device), bn

    def run(x, dy, bn, plain):
        bn = copy.deepcopy(bn)
        x = x.clone().requires_grad_()
        y = torch.relu(bn(x)) if plain else fused.bn_relu(x, bn)
        grads = torch.autograd.grad(y, [x, bn.weight, bn.bias], dy)
        return dict(zip(("y", "dx", "grad_weight", "grad_bias", "running_mean", "running_var"),
                        (y.detach(), *grads, bn.running_mean, bn.running_var)))

    err = 0.0
    with uncounted():
        for C in SSG_B24_BN[0][2][1:]:
            x, dy, bn = pair(SSG_B24_BN[0][1], C)
            got, want = run(x, dy, bn, False), run(x, dy, bn, True)
            again = run(x, dy, bn, False)
            torch.cuda.synchronize()
            what = f"bn_relu SA1 [{x.shape[0]}, {C}]"
            check(all(torch.equal(got[k], again[k]) for k in got), f"{what}: two calls differ")
            check(all(torch.equal(got[k], want[k]) for k in ("y", "running_mean", "running_var")),
                  f"{what}: the forward is not the plain pair's bit for bit")
            gaps = {k: float((got[k] - want[k]).double().norm() / want[k].double().norm())
                    for k in ("dx", "grad_weight", "grad_bias")}
            for k, gap in gaps.items():
                check(gap <= BN_RELU_GRAD_TOL, f"{what}: {k} {gap} of its norm from the plain pair")
            err = max(err, *gaps.values())
            log(f"  {what}: the forward equals the plain pair's bit for bit; gradients against it, relative to "
                f"the norm: {json.dumps(gaps)}; two calls equal bit for bit")

        shapes = []
        for level, R, widths in SSG_B24_BN:
            for i, C in enumerate(widths):
                x, dy, bn = pair(R, C)
                w, b = bn.weight.detach(), bn.bias.detach()
                rm, rv = bn.running_mean, bn.running_var
                var, mean = torch.var_mean(x, dim=0, unbiased=False)
                rstd = torch.rsqrt(var + bn.eps)
                xg = x.clone().requires_grad_()

                def fused_fwd():
                    fused.BatchNormReLU.apply(x, w, b, rm, rv, bn.momentum, bn.eps)

                def plain_fwd():
                    torch.relu(bn(x))

                def plain_both():
                    torch.autograd.grad(torch.relu(bn(xg)), [xg, bn.weight, bn.bias], dy)

                with torch.no_grad():
                    ms_fwd, lib_fwd = cuda_graph_ms(fused_fwd, 10), cuda_graph_ms(plain_fwd, 10)
                ms_bwd = cuda_graph_ms(lambda: fused._backward_kernel(x, dy, mean, rstd, w, b), 10)
                lib_bwd = cuda_graph_ms(plain_both, 10) - lib_fwd
                plain = {"forward": cuda_ms(lambda: fused.forward_reference(x, mean, rstd, w, b), 3),
                         "backward": cuda_ms(lambda: fused.backward_reference(x, dy, mean, rstd, w, b), 3)}
                nbytes = 4 * R * C
                for what, ms, lib, moved in (("forward", ms_fwd, lib_fwd, 2), ("backward", ms_bwd, lib_bwd, 3)):
                    bound = 1e3 * moved * nbytes / HBM_BYTES_PER_S
                    check(ms >= bound, f"bn_relu {level} {what}: {ms} ms reads over 100% of its bound {bound} ms")
                    shapes.append({"call": f"{level} bn_{i} {what}", "shape": [R, C], "ms": ms,
                                   "plain_ms": plain[what], "library_ms": lib,
                                   "bound_ms": bound, "bound_by": "bytes"})
    entry = kernel_entry("bn_relu", "pointnet_like_pose_estimation_tpu_torch/kernels/csrc/bn_relu.cu",
                         "none: XLA fused the JAX package's BatchNorm and ReLU on the TPU", err, shapes,
                         "one train step of pointnet2_cls_ssg at B = 24: its nine shared-MLP pairs, "
                         "forward and backward")
    entry["library_ms"] = sum(s["library_ms"] for s in shapes)
    return entry


def eval_pair_shapes(device) -> dict:
    """The eval-mode BatchNorm + ReLU pairs of one request of 32 clusters
    of 2048 points, by model set: ``{"ssg": {(kind, shape): count}, "msg":
    ...}``, kind ``eval`` (``[R, C]``) or ``pooled`` (``[G, K, C]``), taken
    from the calls of an eager request on seeded models."""
    import collections

    from pointnet_like_pose_estimation_tpu_torch.nn import layers
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    configs = {"ssg": PipelineConfig(),
               "msg": PipelineConfig(classifier="pointnet2_cls_msg", rotation="rotation_msg", sign="sign_msg",
                                     translation="translation_msg")}
    clusters = blobs(np.random.default_rng(4), 32, 2048)
    found = {}
    saved = layers.bn_relu_eval, layers.bn_relu_eval_pool
    for name, cfg in configs.items():
        seen = collections.Counter()

        def spy(kind, fn):
            def call(x, bn):
                seen[(kind, tuple(x.shape[-1:] if kind == "eval" else x.shape[-2:]),
                      int(np.prod(x.shape[:-1 if kind == "eval" else -2])))] += 1
                return fn(x, bn)
            return call

        layers.bn_relu_eval, layers.bn_relu_eval_pool = spy("eval", saved[0]), spy("pooled", saved[1])
        try:
            with uncounted():
                eager_request(GraspPipeline.from_random(cfg, seed=5, device=device), clusters)
        finally:
            layers.bn_relu_eval, layers.bn_relu_eval_pool = saved
        found[name] = {(kind, (lead, *tail)): n for (kind, tail, lead), n in seen.items()}
    return found


def bn_relu_eval_entry(device) -> dict:
    """The eval BatchNorm + ReLU passes (kernels/bn_relu.py bn_relu_eval,
    bn_relu_eval_pool) at every shape of a 32-cluster request of both
    serving cells' models: each against the plain pair (torch.relu of
    BatchNormF32 in eval mode, and .amax(dim=-2) after a pooled one) bit for
    bit, then its time (a call in a CUDA graph; the calls cycle over copies
    of the input that together pass 256 MB, five times the L2 cache, so
    that each reads device memory and the writes reach it, as in a request)
    beside its bound (x read once, the output written once, at the HBM
    rate), its plain version and the plain pair (library_ms, which the port
    no longer calls in serving). The entry's times are one SSG request's
    (each shape times its pairs); ``msg_request`` holds the MSG request's."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.kernels import bn_relu as fused
    from pointnet_like_pose_estimation_tpu_torch.nn import BatchNormF32

    counts = eval_pair_shapes(device)
    shapes, err = [], 0
    with uncounted():
        for kind, shape in sorted(set(counts["ssg"]) | set(counts["msg"])):
            g = torch.Generator(device=device).manual_seed(sum(shape))
            C = shape[-1]
            rows = int(np.prod(shape[:-1]))
            x = (torch.randn(rows, C, generator=g, device=device) * (torch.rand(C, generator=g, device=device) + 0.1)
                 + 0.3 * torch.randn(C, generator=g, device=device)).reshape(shape)
            bn = BatchNormF32(C).to(device).eval()
            with torch.no_grad():
                bn.weight.uniform_(0.5, 1.5, generator=g)
                bn.bias.normal_(0.0, 0.2, generator=g)
                bn.running_mean.normal_(0.0, 0.3, generator=g)
                bn.running_var.uniform_(0.5, 2.0, generator=g)
            bn.requires_grad_(False)
            args = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
            copies = [x] + [x.clone() for _ in range(-(-256 * 2**20 // (4 * x.numel())) - 1)]
            turn = iter(range(2**62))

            def cold():
                return copies[next(turn) % len(copies)]

            if kind == "eval":
                kernel, reference = (lambda: fused.bn_relu_eval(cold(), bn)), (lambda: fused.eval_reference(x, *args))
                library = lambda: torch.relu(bn(cold()))
                nbytes = 8 * x.numel()
            else:
                kernel = lambda: fused.bn_relu_eval_pool(cold(), bn)
                reference = lambda: fused.eval_max_reference(x, *args)
                library = lambda: torch.relu(bn(cold())).amax(dim=-2)
                nbytes = 4 * (x.numel() + shape[0] * C)
            reps = max(10, len(copies))
            with torch.inference_mode():
                got, want = kernel(), library()
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            check(differ == 0, f"bn_relu_eval {kind} {list(shape)}: {differ} elements differ from the plain pair")
            err = max(err, differ)
            del got, want
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            ms = cuda_graph_ms(kernel, reps)
            check(ms >= bound, f"bn_relu_eval {kind} {list(shape)}: {ms} ms reads over 100% of its bound {bound} ms")
            shapes.append({"call": kind, "shape": list(shape), "ms": ms, "plain_ms": cuda_ms(reference, 3),
                           "library_ms": cuda_graph_ms(library, reps), "bound_ms": bound, "bound_by": "bytes",
                           "ssg_pairs": counts["ssg"].get((kind, shape), 0),
                           "msg_pairs": counts["msg"].get((kind, shape), 0)})
        log("  bn_relu_eval: every shape of both requests equals the plain pair bit for bit")
    entry = kernel_entry("bn_relu_eval", "pointnet_like_pose_estimation_tpu_torch/kernels/csrc/bn_relu.cu",
                         "none: XLA fused the JAX package's eval BatchNorm, ReLU and max on the TPU", float(err),
                         shapes, "one clusters_k32 request (32 clusters x 2048 points): its 20 eval and 7 pooled "
                         "pairs; msg_request: one clusters_msg_k32 request's 30 and 23")
    for key, into in (("ssg_pairs", entry), ("msg_pairs", entry.setdefault("msg_request", {}))):
        for field in ("ms", "plain_ms", "bound_ms", "library_ms"):
            into[field] = sum(s[key] * s[field] for s in shapes)
    log(f"  bn_relu_eval a request: SSG {json.dumps({k: entry[k] for k in ('ms', 'bound_ms', 'library_ms')})}, "
        f"MSG {json.dumps(entry['msg_request'])}")
    return entry


def bn_relu_eval_gather_entry(device) -> dict:
    """The gathered eval pass (kernels/bn_relu.py bn_relu_eval_gather), the
    first pair of every grouped set abstraction's scale, on the very inputs
    of one eager 32-cluster request of each serving cell's models (the
    per-point products, the centroids' and the ball query's indices, seeded
    weights): against its plain version bit for bit, then its time (a call
    in a CUDA graph; the products stay in the L2, as in a request) beside
    its bound (the output written once and the products, centroid terms
    and indices read once, at the HBM rate) and its plain version's. No
    PyTorch call computes it (library_ms: none). The entry's times are one
    SSG request's; ``msg_request`` holds the MSG request's."""
    import collections

    import torch

    from pointnet_like_pose_estimation_tpu_torch.kernels import bn_relu as fused
    from pointnet_like_pose_estimation_tpu_torch.nn import layers
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    configs = {"ssg": PipelineConfig(),
               "msg": PipelineConfig(classifier="pointnet2_cls_msg", rotation="rotation_msg", sign="sign_msg",
                                     translation="translation_msg")}
    clusters = blobs(np.random.default_rng(4), 32, 2048)
    calls, counts = {}, {name: collections.Counter() for name in configs}
    saved = layers.bn_relu_eval_gather
    for name, cfg in configs.items():
        def spy(pf, qc, idx, bias, bn, name=name):
            shape = (*idx.shape, pf.shape[-1], pf.shape[1])    # B, S, K, C, N
            counts[name][shape] += 1
            calls.setdefault(shape, (pf, qc, idx, bias, bn))
            return saved(pf, qc, idx, bias, bn)

        layers.bn_relu_eval_gather = spy
        try:
            with uncounted():
                eager_request(GraspPipeline.from_random(cfg, seed=5, device=device), clusters)
        finally:
            layers.bn_relu_eval_gather = saved
    shapes, err = [], 0
    with uncounted(), torch.inference_mode():
        for shape, (pf, qc, idx, bias, bn) in sorted(calls.items()):
            B, S, K, C, N = shape
            args = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
            kernel = lambda: fused.bn_relu_eval_gather(pf, qc, idx, bias, bn)
            reference = lambda: fused.eval_gather_reference(pf, qc, idx, bias, *args)
            got, want = kernel(), reference()
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            check(differ == 0, f"bn_relu_eval_gather {list(shape)}: {differ} elements differ from its plain version")
            err = max(err, differ)
            del got, want
            bound = 1e3 * 4 * (B * S * K * C + B * N * C + B * S * C + B * S * K) / HBM_BYTES_PER_S
            ms = cuda_graph_ms(kernel, 10)
            check(ms >= bound, f"bn_relu_eval_gather {list(shape)}: {ms} ms reads over 100% of its bound {bound} ms")
            shapes.append({"call": "gathered", "shape": [B, S, K, C, N], "ms": ms, "plain_ms": cuda_ms(reference, 3),
                           "bound_ms": bound, "bound_by": "bytes", "ssg_pairs": counts["ssg"][shape],
                           "msg_pairs": counts["msg"][shape]})
        log("  bn_relu_eval_gather: every shape of both requests equals its plain version bit for bit")
    entry = kernel_entry("bn_relu_eval_gather", "pointnet_like_pose_estimation_tpu_torch/kernels/csrc/bn_relu.cu",
                         "none: the grouped first layer was a gather, a concatenation and a Linear on the TPU",
                         float(err), shapes, "one clusters_k32 request (32 clusters x 2048 points): its 2 "
                         "gathered first pairs; msg_request: one clusters_msg_k32 request's 18")
    for key, into in (("ssg_pairs", entry), ("msg_pairs", entry.setdefault("msg_request", {}))):
        for field in ("ms", "plain_ms", "bound_ms"):
            into[field] = sum(s[key] * s[field] for s in shapes)
    log(f"  bn_relu_eval_gather a request: SSG {json.dumps({k: entry[k] for k in ('ms', 'bound_ms', 'plain_ms')})}, "
        f"MSG {json.dumps(entry['msg_request'])}")
    return entry


def knn_entry(device) -> dict:
    """The kNN query (kernels/knn.py knn) at the nine shapes of one
    32-cluster Point Transformer request (bench_port/harness/bounds_pt.py
    knn_calls: each stage's points among themselves, each strided
    TransitionDown's centroids among the points before): its indices
    against its plain version's on the card, equal (a quarter of the
    points repeat others, so distances tie and go to the lower index),
    then its time (a call in a CUDA graph) beside its bound
    (bounds_pt.knn_bound_ms: the larger of the bytes once at the HBM rate
    and 9 operations a pair at the f32 peak) and its plain version's. No
    PyTorch call computes it (library_ms: none)."""
    import torch

    if os.path.join(ROOT, "bench_port") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "bench_port"))
    from harness.bounds_pt import knn_bound_ms, knn_calls

    from pointnet_like_pose_estimation_tpu_torch.kernels.knn import knn, knn_reference

    rng = np.random.default_rng(6)
    B, shapes, err = 32, [], 0
    with uncounted(), torch.inference_mode():
        for N, S, k in knn_calls(1024):
            pts = torch.from_numpy(unit_clouds(rng, B, N)).to(device)
            pts[:, N - N // 4:] = pts[:, :N // 4]
            queries = pts[:, :S].contiguous()
            kernel = lambda: knn(pts, queries, k)
            reference = lambda: knn_reference(pts, queries, k)
            got, want = kernel(), reference()
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            check(differ == 0, f"knn [{B}, {N} -> {S}, k {k}]: {differ} indices differ from its plain version")
            err = max(err, differ)
            bound = knn_bound_ms(B, N, S, k)
            ms = cuda_graph_ms(kernel, 20)
            check(ms >= bound, f"knn [{B}, {N} -> {S}, k {k}]: {ms} ms reads over 100% of its bound {bound} ms")
            shapes.append({"call": "query", "shape": [B, N, S, k], "ms": ms, "plain_ms": cuda_ms(reference, 3),
                           "bound_ms": bound,
                           "bound_by": "operations" if 1e3 * 9 * B * S * N / F32_FLOP_PER_S >= bound else "bytes"})
        log("  knn: every query of a request equals its plain version")
    return kernel_entry("knn", "pointnet_like_pose_estimation_tpu_torch/kernels/csrc/knn.cu",
                        "none: the JAX package selects no neighbours by rank", float(err), shapes,
                        "one clusters_pt_k32 request (32 clusters resampled to 1024 points): its nine queries")


def pt_attention_bound_ms(B: int, N: int, K: int, C: int, c: int) -> tuple[float, str]:
    """Least ms of one Point Transformer attention pass over B clouds of N
    points, K neighbours each, C channels, c = C / share_planes weights a
    neighbour: the larger of its bytes at the HBM rate (q, k, v and the
    points read and the output written once, the int64 indices and the
    layer's parameters read once) and its operations at the f32 peak, a
    multiply-add two: a neighbour's relative position (3), the position
    encoder's hidden layer (21, and 5 a BatchNorm + ReLU element: 15) and
    its last Linear (7 C), the relation (2 C) and its pair (5 C), the
    weight MLP (2 C c + c, 5 c, 2 c^2 + c), the softmax (5 c: max, subtract,
    exp, sum, divide) and the weighted sum (3 C); a query's bn2 pair (5 C).
    Which of the two bounds it is returned beside it."""
    params = 9 + 3 + 3 * C + C + c * C + c + c * c + c + 4 * (3 + C + c + C)
    nbytes = 4 * (4 * B * N * C + 3 * B * N + params) + 8 * B * N * K
    ops = B * N * K * (39 + 17 * C + 2 * C * c + 2 * c * c + 12 * c) + 5 * B * N * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pt_attention_entry(device) -> dict:
    """Point Transformer's one-pass attention (kernels/pt_attention.py
    pt_attention) on the very inputs of the 13 layers of one eager
    32-cluster request (seeded weights, the features grown to thousands):
    against its plain version in float32 and in float64, where the
    kernel's distance from float64 must stay within PT_ATTENTION_ERR times
    the plain float32 version's (both sum in float32, in other orders; the
    softmax over logits of hundreds turns a last-bit difference of a logit
    into a visible one of the output, in both alike), then its time (a call
    in a CUDA graph; its inputs in the L2, as in a request) beside its
    bound (pt_attention_bound_ms) and its plain version's. No PyTorch call
    computes it (library_ms: none)."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.kernels.pt_attention import pt_attention, pt_attention_reference
    from pointnet_like_pose_estimation_tpu_torch.nn import point_transformer
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    calls = []
    saved = point_transformer.pt_attention

    def spy(*args):
        calls.append(args)
        return saved(*args)

    point_transformer.pt_attention = spy
    try:
        with uncounted():
            eager_request(GraspPipeline.from_random(PipelineConfig(classifier="point_transformer_cls"), seed=5,
                                                    device=device), blobs(np.random.default_rng(8), 32, 2048))
    finally:
        point_transformer.pt_attention = saved
    check(len(calls) == 13, f"pt_attention: {len(calls)} calls in one Point Transformer request, want 13")
    shapes, worst = [], 0.0
    with uncounted(), torch.inference_mode():
        for i, (p, q, k, v, idx, attn, bn2) in enumerate(calls):
            B, N, K = idx.shape
            C, c = q.shape[-1], q.shape[-1] // attn.share_planes
            kernel = lambda: pt_attention(p, q, k, v, idx, attn, bn2)
            reference = lambda: pt_attention_reference(p, q, k, v, idx, attn, bn2)
            got, want = kernel(), reference()
            exact = pt_attention_reference(p.double(), q.double(), k.double(), v.double(), idx,
                                           copy.deepcopy(attn).double(), copy.deepcopy(bn2).double())
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"pt_attention layer {i} [{B}, {N}, {K}, {C}]: not finite")
            scale = float(exact.abs().max())
            err_kernel = float((got.double() - exact).abs().max())
            err_plain = float((want.double() - exact).abs().max())
            check(err_kernel <= PT_ATTENTION_ERR * err_plain + 1e-6 * scale,
                  f"pt_attention layer {i} [{B}, {N}, {K}, {C}]: {err_kernel} from float64, the plain version "
                  f"{err_plain}, the output's scale {scale}")
            worst = max(worst, err_kernel / scale)
            del got, want, exact
            bound, by = pt_attention_bound_ms(B, N, K, C, c)
            ms = cuda_graph_ms(kernel, 20)
            check(ms >= bound, f"pt_attention layer {i}: {ms} ms reads over 100% of its bound {bound} ms")
            shapes.append({"call": f"layer {i}", "shape": [B, N, K, C], "ms": ms, "plain_ms": cuda_ms(reference, 3),
                           "bound_ms": bound, "bound_by": by, "err_from_f64": err_kernel,
                           "plain_err_from_f64": err_plain, "scale": scale})
        log(f"  pt_attention: the 13 layers within {PT_ATTENTION_ERR}x the plain version's distance from float64 "
            f"(the widest {worst:.3g} of the output's scale)")
    return kernel_entry("pt_attention", "pointnet_like_pose_estimation_tpu_torch/kernels/csrc/pt_attention.cu",
                        "none: the JAX package has no Point Transformer", worst, shapes,
                        "one clusters_pt_k32 request (32 clusters resampled to 1024 points): its 13 attention layers")


def kernel_entry(name, source, replaces, err, shapes, per_request_of) -> dict:
    """One kernel of the kernels JSON line: its times and bounds summed over
    the calls of one request; ``launches`` is filled in by the path runs."""
    for s in shapes:
        extra = f", {s['us_per_step']:.4f} us/step" if "us_per_step" in s else ""
        if "path" in s:
            extra += f", plan {tuple(s['plan'])}: {s['path']} path"
        if "ms_with_host_enqueue" in s:
            extra = f", {s['ms_with_host_enqueue']:.4f} ms a call launched from Python in a loop"
        if "library_ms" in s:
            extra = f", the plain pair {s['library_ms']:.4f} ms"
        if "tc_bound_ms" in s:
            extra = (f" = {100 * s['bound_ms'] / s['ms']:.1f}% of the f32 bound, tensor-core bound "
                     f"{s['tc_bound_ms']:.6f} ms = {100 * s['tc_bound_ms'] / s['ms']:.1f}%")
        log(f"  time {name} {s['call']} {s['shape']}: kernel {s['ms']:.4f} ms, "
            f"plain {s['plain_ms']:.4f} ms, bound {s['bound_ms']:.6f} ms ({s['bound_by']}){extra}")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err,
        "ms": sum(s["ms"] for s in shapes),
        "plain_ms": sum(s["plain_ms"] for s in shapes),
        "bound_ms": sum(s["bound_ms"] for s in shapes),
        "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
        "library_ms": None,
        "per_request_of": per_request_of,
        "shapes": shapes,
    }


def blobs(rng, K, M):
    """K seeded clusters of M points, each a blob of 0.05 around its centre."""
    return (rng.uniform(-0.5, 0.5, (K, 1, 3))
            + 0.05 * rng.standard_normal((K, M, 3))).astype(np.float32)


def seeded_model(name: str, seed: int):
    """A registry model with weights drawn from a torch.Generator and
    nontrivial BatchNorm statistics and affine parameters, so that eval-mode
    BN (and folding it into the weights) is exercised. A T-Net's output
    layer is the identity plus small noise, so that its transform is
    neither trivial nor wild."""
    import math

    import torch
    from torch import nn

    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.nn import TNet

    gen = torch.Generator().manual_seed(seed)
    model = build_model(name)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(m, nn.BatchNorm1d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
        for m in model.modules():
            if isinstance(m, TNet):
                m.reset_identity()
                m.out.weight.normal_(0.0, 0.02, generator=gen)
    return model.eval()


def fused_sa_phase(device, executors, xyz) -> dict:
    """The MMA tile self-test; then the fused-SA kernel against its plain
    version on seeded clouds and seeded folded weights at the shapes of the
    four SA calls (B = 8), with empty balls, with a ragged last centroid
    tile and with K no multiple of 8: selected indices exact, features
    within FUSED_TOL. Then the path's own calls: ``xyz`` [32, 1024, 3]
    through each executor's folded SA1 and SA2, held against the plain
    version in the same way and timed beside both bounds."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_reference
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
    from pointnet_like_pose_estimation_tpu_torch.kernels.fused_sa import (
        fused_sa_infer,
        fused_sa_reference,
        launch_plan,
        mma_tile_selftest,
    )
    from pointnet_like_pose_estimation_tpu_torch.models.fast_infer import fold_sa_level
    from pointnet_like_pose_estimation_tpu_torch.ops import index_points

    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)).to(device)
    tile = mma_tile_selftest(a, b)
    torch.cuda.synchronize()
    diff = float((tile - (a.double() @ b.double()).float()).abs().max())
    check(diff <= MMA_TOL, f"fused_sa MMA self-test: tile differs from the f64 product (max {diff})")
    log(f"  fused_sa MMA self-test 16x8x8: max abs diff {diff:.3g} from the f64 product")

    levels = {f"{ex} SA{i + 1}": fold_sa_level(getattr(model, f"sa{i + 1}"))
              for ex, (_, _, model) in executors.items() for i in range(2)}
    err = 0.0

    def case(what, N, level, offset=0.0, S=None, B=8):
        S0, radii, ks, widths, model_w = level
        return what, B, N, S or S0, radii, ks, widths, model_w[0].shape[0], offset

    cases = [case("SSG SA1", 1024, levels["SSG SA1"]), case("SSG SA2", 512, levels["SSG SA2"]),
             case("MSG SA1", 1024, levels["MSG SA1"]), case("MSG SA2", 512, levels["MSG SA2"]),
             case("empty balls", 1024, levels["MSG SA1"], offset=4.0),
             case("ragged S, MSG SA1", 1024, levels["MSG SA1"], S=509),
             case("ragged S, SSG SA2", 512, levels["SSG SA2"], S=127),
             case("ragged S, SSG SA2, more clouds", 512, levels["SSG SA2"], S=127, B=40),
             ("K = 20 and 50, P = 7", 8, 512, 64, (0.3, 0.5), (20, 50), ((16, 24), (40, 8)), 7, 0.0)]

    def compare(what, pts, cent, weights, radii, ks, widths, empty=False):
        nonlocal err
        B, N, P = pts.shape
        S = cent.shape[1]
        idx = torch.empty((B, S, sum(ks)), dtype=torch.int32, device=device)
        got = fused_sa_infer(pts, cent, weights, radii, ks, widths, idx_out=idx)
        torch.cuda.synchronize()
        check(torch.equal(idx, ball_query_reference(pts[..., :3], cent, radii, ks)),
              f"fused_sa {what}: selection differs from ball_query_reference")
        if empty:
            check(bool((idx == N - 1).all()), "fused_sa empty balls: selection is not N-1")
        want = fused_sa_reference(pts, cent, weights, radii, ks, widths)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"fused_sa {what}: shape")
        diff = float((got - want).abs().max())
        err = max(err, diff)
        check(torch.allclose(got, want, rtol=FUSED_TOL, atol=FUSED_TOL),
              f"fused_sa {what}: differs from its plain version (max {diff})")
        rows, tile_c, nbytes = launch_plan(P, ks, widths)
        log(f"  fused_sa {what} B={B} N={N} P={P} S={S} ks={ks} ({rows} rows, {tile_c} centroids "
            f"a block, {nbytes} B shared): selection exact, features max abs diff {diff:.3g}")
        return got

    for what, B, N, S, radii, ks, widths, P, offset in cases:
        xyz8 = torch.from_numpy(unit_clouds(rng, B, N)).to(device)
        feats = np.abs(rng.standard_normal((B, N, P - 3))).astype(np.float32)
        pts = torch.cat([xyz8, torch.from_numpy(feats).to(device)], dim=-1).contiguous()
        cent = (index_points(xyz8, fps(xyz8, S)) + offset).contiguous()
        weights = []
        for ws in widths:
            cin = P
            for cout in ws:
                weights += [rng.standard_normal((cin, cout)) / np.sqrt(cin),
                            0.1 * rng.standard_normal(cout)]
                cin = cout
        weights = [torch.from_numpy(w.astype(np.float32)).to(device) for w in weights]
        compare(what, pts, cent, weights, radii, ks, widths, empty=bool(offset))

    shapes = []
    for ex in executors:
        p = ptsfeat = xyz
        for i in range(2):
            S, radii, ks, widths, weights = levels[f"{ex} SA{i + 1}"]
            weights = [w.to(device) for w in weights]
            cent = index_points(p, fps(p, S)).contiguous()
            args = (ptsfeat, cent, weights, radii, ks, widths)
            f = compare(f"path call {ex} SA{i + 1}", *args)
            bound, by = fused_sa_bound_ms(ptsfeat, cent, radii, ks, widths)
            tc_bound = fused_sa_tc_bound_ms(ptsfeat, cent, ks, widths)
            ms = cuda_ms(lambda: fused_sa_infer(*args), 10)
            check(ms >= bound and ms >= tc_bound,
                  f"fused_sa {ex} SA{i + 1}: {ms} ms reads over 100% of a bound "
                  f"(f32 {bound} ms, tensor cores {tc_bound} ms)")
            shapes.append({"call": f"{ex} SA{i + 1}", "shape": [*ptsfeat.shape, S, *ks],
                           "ms": ms, "plain_ms": cuda_ms(lambda: fused_sa_reference(*args), 3),
                           "bound_ms": bound, "bound_by": by, "tc_bound_ms": tc_bound})
            p, ptsfeat = cent, torch.cat([cent, f], dim=-1)
    return kernel_entry("fused_sa", "pointnet_like_pose_estimation_tpu_torch/kernels/csrc/fused_sa.cu",
                        "pointnet_like_pose_estimation_tpu/kernels/fused_sa.py:43", err, shapes,
                        "one SSG and one MSG forward of 32 clouds x 1024 points")


def timed(fn, reps: int) -> dict:
    """Host clock around ``fn`` ending in a synchronize; peak device memory."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times), "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
            "reserved_mb": torch.cuda.memory_reserved() / 2**20}


@contextlib.contextmanager
def uncounted():
    """Kernel launches inside are no launches of the main path (an eager
    run held against a replay, or timed beside it): the counts are put back."""
    from pointnet_like_pose_estimation_tpu_torch.utils import counters

    saved = counters.read()
    try:
        yield
    finally:
        counters.take_back(saved)


def runs_of(cache, fn):
    """``fn()`` and the times the programs of ``cache`` ran on the card in
    it: each replay, and the warm-up before each capture. A kernel wrapper's
    launches in ``fn`` are its launches per run times this."""
    import torch

    c0, r0 = cache.captures, cache.replays
    out = fn()
    torch.cuda.synchronize()
    return out, cache.captures - c0 + cache.replays - r0


def output_gap(got: dict, want: dict, what: str) -> float:
    """A replay against the same function run eagerly on the card on the
    same inputs: every integer output equal, every float within
    PROGRAM_TOL; the largest float gap."""
    check(set(got) == set(want), f"{what}: keys {sorted(got)} against {sorted(want)}")
    gap = 0.0
    for k in got:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        check(a.shape == b.shape and a.dtype == b.dtype, f"{what}: {k} {a.dtype} {a.shape} against {b.dtype} {b.shape}")
        if np.issubdtype(a.dtype, np.floating):
            gap = max(gap, float(np.abs(a - b).max()) if a.size else 0.0)
        else:
            check(np.array_equal(a, b), f"{what}: {k} differs from the eager run on the card")
    check(gap <= PROGRAM_TOL, f"{what}: floats {gap} from the eager run on the card, over {PROGRAM_TOL}")
    return gap


def eager_request(pipe, clusters) -> dict:
    """``infer_clusters``'s work without its graph: the same bucketed
    inputs, the request program's function run eagerly on the card, the
    same copies back to the host."""
    import torch

    _, fn, inputs, K = pipe._request_call(clusters)
    with torch.inference_mode():
        out = fn(*(x.to(pipe.device) for x in inputs))
        return {k: v[:K].cpu().numpy() for k, v in out.items()}


def eager_scene(pipe, pts, labels) -> dict:
    """``_infer_scene``'s work without its graph (the scene program's
    function run eagerly on the card)."""
    import torch

    _, fn, inputs, K, min_size = pipe._scene_call(pts, labels)
    with torch.inference_mode():
        out, cglobal = fn(*(x.to(pipe.device) for x in inputs))
        res = {k: v[:K].cpu().numpy() for k, v in out.items()}
        res["clusters"] = pts[cglobal[:K, :min_size].cpu().numpy()]
    return res


def graph_pools_mb(pool=None):
    """Device memory the caching allocator holds in ``pool`` (a program
    cache's pool), or in every private pool (every CUDA graph's pool on the
    card at this moment) when ``pool`` is None; "not measured" where its
    snapshot does not name a segment's pool."""
    import torch

    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segments):
        return "not measured"
    ids = [tuple(seg["segment_pool_id"]) for seg in segments]
    mine = (lambda i: i == tuple(pool)) if pool is not None else (lambda i: i != (0, 0))
    return sum(seg["total_size"] for seg, i in zip(segments, ids) if mine(i)) / 2**20


def programs_line(what: str, cache) -> dict:
    """A program cache's counters, its own pool's MB (``pool_mb``) and all
    graph pools' MB on the card (``graph_pools_mb``)."""
    row = {"captures": cache.captures, "capture_s": cache.capture_seconds, "replays": cache.replays,
           "held": len(cache), "evictions": cache.evictions,
           "pool_mb": graph_pools_mb(cache.pool) if cache.pool is not None else 0.0,
           "graph_pools_mb": graph_pools_mb()}
    log(f"  programs {what}: {json.dumps(row)}")
    return row


# the bytes of one cluster's grouped tensors in the SSG request: the
# classifier's global level (SA1 and SA2 take their first Linears per point
# and build none; the default heads group nothing)
SSG_GROUPED_BYTES = 4 * 128 * (3 + 256)
# the kernels of the port by the name the profiler gives them
PROFILED_KERNELS = {"fps": ("fps_register_kernel", "fps_register_spliced_kernel", "fps_dist_kernel",
                            "fps_cluster_kernel"),
                    "ball_query": ("ball_query_kernel",), "fused_sa": ("fused_sa_kernel",),
                    "bn_relu": ("bn_relu_apply_kernel",), "bn_relu_eval": ("bn_relu_eval_kernel",),
                    "bn_relu_eval_pool": ("bn_relu_eval_max_kernel",),
                    "bn_relu_eval_gather": ("bn_relu_eval_gather_kernel",), "knn": ("knn_kernel",),
                    "pt_attention": ("pt_attention_kernel",)}
# what the program of one Point Transformer request of 32 clusters of 2048
# points records: the resampling FPS and the four strided ones, the nine kNN
# queries, the 13 attention passes (each with its block's bn2 pair, the
# weight pair and the weight MLP's inner pair, and the position encoder's
# pair of 3 channels inside it), the eval pairs (14 of the classifier's:
# its 13 blocks' bn1 and its first TransitionDown's; 16 of the heads'; the
# pooled last pairs of its 4 strided TransitionDowns and of the 4 heads)
# and the bytes of the strided TransitionDowns' grouped inputs, 1,048,320
# a cluster (the attention forms no neighbourhood tensor)
PT_REQUEST_COUNTS = {"fps": 5, "knn": 9, "pt_attention": 13, "bn_relu_eval": 30, "bn_relu_eval_pool": 8,
                     "grouped_bytes": 32 * 1_048_320}


def profiled_launches(fn) -> dict[str, int]:
    """The port's kernels that ran on the card in ``fn()``, counted by
    torch.profiler from the card's own trace (CUPTI records the kernels a
    graph replay runs), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(PROFILED_KERNELS, 0)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            for name, marks in PROFILED_KERNELS.items():
                counts[name] += any(m in ev.name for m in marks)
    return counts


def resampled(pipe, clusters):
    """Host clusters ``[K, M, 3]`` resampled to the pipeline's
    ``num_points`` on its device, as a request resamples them."""
    import torch

    with torch.inference_mode():
        return pipe._resample_tensor(torch.from_numpy(np.ascontiguousarray(clusters[..., :3])).to(pipe.device))


def fast_infer_phase(pipe, executors, kernels: list[dict]) -> dict:
    """The fused executors on their main path, each forward one replay of
    its (B, N) program: the SSG one on the trained r3 checkpoint (replay
    clusters and two seeded batches of 32 in one bucket, prepared as the
    pipeline prepares them), the MSG one on seeded weights (a seeded batch
    of 32). Each run of a program must add 2 fused_sa, 2 fps and 0
    ball-query launches. Every output is held against the executor's
    function run eagerly on the card (PROGRAM_TOL), the unfused model on the
    card and the same executor on the CPU (pred equal, log_probs within
    TOL), and the replay classes against the recorded JAX pred_class. Then
    latency and peak memory of the executor's replay, its eager function
    and the unfused model, B = 32 and 256."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
    from pointnet_like_pose_estimation_tpu_torch.kernels.fused_sa import fused_sa_infer
    from pointnet_like_pose_estimation_tpu_torch.ops import normalize_cloud

    fix = np.load(FIXTURE)
    rng = np.random.default_rng(2)

    def prepare(clusters):
        return normalize_cloud(resampled(pipe, clusters))

    requests = [("SSG", "replay", prepare(fix["clusters"])),
                ("SSG", "seeded B=32", prepare(blobs(rng, 32, 2048))),
                ("SSG", "seeded B=32, same bucket", prepare(blobs(rng, 32, 2048))),
                ("MSG", "seeded B=32", prepare(blobs(rng, 32, 2048)))]

    def counts():
        return fused_sa_infer.launches, fps.launches, ball_query_multi.launches

    fused_sa_infer.launches = fps.launches = ball_query_multi.launches = 0
    outputs = []
    for ex, name, x in requests:
        fwd = executors[ex][0]
        before = counts()
        (log_probs, pred), runs = runs_of(fwd.programs, lambda: fwd(x))
        got = tuple(a - b for a, b in zip(counts(), before))
        check(got == (2 * runs, 2 * runs, 0),
              f"{ex} {name}: launches fused_sa/fps/ball_query {got}, want (2, 2, 0) a run, {runs} runs")
        outputs.append((ex, name, x, log_probs, pred, runs))
    launches = dict(zip(("fused_sa", "fps", "ball_query"), counts()))
    check(launches["fused_sa"] > 0 and launches["fps"] > 0, "fast-infer path launched no kernel")
    check(outputs[2][5] == 1, "SSG: the second batch of one bucket was not a replay")
    check(not torch.equal(outputs[1][3], outputs[2][3]), "SSG: the second batch of one bucket gave the first's")
    for k in kernels:
        k.setdefault("launches_by_path", {"serving": k["launches"]})["fast_infer"] = launches.get(k["name"], 0)
        if k["name"] == "fused_sa":
            k["launches"] = launches["fused_sa"]

    report = {"forwards": {}}
    for ex, name, x, log_probs, pred, runs in outputs:
        fwd, cpu_fwd, model = executors[ex]
        check(log_probs.shape == (x.shape[0], 7) and bool(torch.isfinite(log_probs).all()),
              f"{ex} {name}: log_probs shape or non-finite")
        with uncounted(), torch.inference_mode():
            e_lp, e_pred = fwd.body(x)
            gap = output_gap({"log_probs": log_probs.cpu(), "pred": pred.cpu()},
                             {"log_probs": e_lp.cpu(), "pred": e_pred.cpu()}, f"{ex} {name}")
            m_lp, _, m_pred = model(x)
        c_lp, c_pred = cpu_fwd(x.cpu())
        for what, lp, pr in (("unfused model on the card", m_lp, m_pred),
                             ("executor on the CPU", c_lp, c_pred)):
            check(torch.equal(pred.cpu(), pr.cpu()), f"{ex} {name}: pred differs from the {what}")
            diff = float((log_probs.cpu() - lp.cpu()).abs().max())
            check(torch.allclose(log_probs.cpu(), lp.cpu(), rtol=TOL, atol=TOL),
                  f"{ex} {name}: log_probs differ from the {what} (max {diff})")
            log(f"  {ex} {name}: matches the {what} (log_probs max abs diff {diff:.3g})")
        log(f"  {ex} {name}: {runs} runs of its program; the eager run on the card within {gap:.3g}")
        report["forwards"][f"{ex} {name}"] = {"runs": runs, "eager_gap": gap}
        if name == "replay":
            check(np.array_equal(pred.cpu().numpy(), fix["pred_class"]),
                  f"SSG replay: pred {pred.tolist()} vs recorded JAX {fix['pred_class'].tolist()}")
            log(f"  SSG replay: classes {pred.tolist()} equal the recorded JAX pred_class")

    latency = {}
    for B in (32, 256):
        x = normalize_cloud(torch.from_numpy(blobs(rng, B, 1024)).to(pipe.device))
        for ex, (fwd, _, model) in executors.items():
            for what, fn in (("fused", lambda: fwd(x)), ("fused eager", lambda: fwd.body(x)),
                             ("unfused", lambda: model(x))):
                with uncounted() if what != "fused" else contextlib.nullcontext(), torch.inference_mode():
                    latency[f"{ex} B={B} {what}"] = timed(fn, 10)
                log(f"  latency {ex} B={B} {what}: {json.dumps(latency[f'{ex} B={B} {what}'])}")
    report["programs"] = {ex: programs_line(f"{ex} executor", fwd.programs)
                          for ex, (fwd, _, _) in executors.items()}
    report["latency"] = latency
    return report


def pt_request(device) -> dict:
    """One request of 32 clusters of 2048 points through ``infer_clusters``
    on Point Transformer (``classifier="point_transformer_cls"``, seeded
    weights, the PointNet heads), a replay of the program that a request
    before it captured, with every counter set to 0 just before it: what it
    counts is PT_REQUEST_COUNTS and nothing else, as its program records;
    one more replay under torch.profiler runs on the card the kernels those
    counts name; its outputs against its function run eagerly on the card
    (integers equal, floats within PROGRAM_TOL of each output's largest
    value: the seeded weights give logits of thousands)."""
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
    from pointnet_like_pose_estimation_tpu_torch.utils import counters

    pipe = GraspPipeline.from_random(PipelineConfig(classifier="point_transformer_cls"), seed=5, device=device)
    rng = np.random.default_rng(7)
    pipe.infer_clusters(blobs(rng, 32, 2048))
    clusters = blobs(rng, 32, 2048)
    counters.take_back({})
    out, runs = runs_of(pipe.programs, lambda: pipe.infer_clusters(clusters))
    counts = {name: n for name, n in counters.read().items() if n}
    key = pipe._request_call(clusters)[0]
    check(runs == 1 and counts == PT_REQUEST_COUNTS and pipe.programs.counts(key) == PT_REQUEST_COUNTS,
          f"Point Transformer request: {runs} runs counted {counts}, its program {key} records "
          f"{pipe.programs.counts(key)}, want one replay of {PT_REQUEST_COUNTS}")
    with uncounted():
        traced = profiled_launches(lambda: pipe.infer_clusters(clusters))
        eager = eager_request(pipe, clusters)
    check(all(traced[k] == PT_REQUEST_COUNTS.get(k, 0) for k in traced),
          f"Point Transformer request: the profiler saw {traced} in a replay, its capture recorded {counts}")
    check(set(out) == set(eager), f"Point Transformer request: keys {sorted(out)} against {sorted(eager)}")
    gap = 0.0
    for name in out:
        a, b = np.asarray(out[name]), np.asarray(eager[name])
        if not np.issubdtype(a.dtype, np.floating):
            check(np.array_equal(a, b), f"Point Transformer request: {name} differs from the eager run on the card")
            continue
        gap = max(gap, float(np.abs(a - b).max() / max(1.0, np.abs(b).max())))
        check(bool(np.isfinite(a).all()), f"Point Transformer request: {name} not finite")
    check(gap <= PROGRAM_TOL, f"Point Transformer request: floats {gap} of their scale from the eager run")
    log(f"  Point Transformer K=32 M=2048: one replay of {key} counted {json.dumps(counts)}; under "
        f"torch.profiler {json.dumps(traced)}; the eager run on the card within {gap:.3g} of the scale; "
        f"classes {out['pred_class'].tolist()}")
    return {"bucket": list(key), "counts": counts, "profiled_launches": traced, "eager_gap": gap}


def serving_phase(pipe, cpu, kernels: list[dict]) -> dict:
    """Requests through ``infer_clusters``, each one replay of its bucket's
    program: the launches of each request are its program's launches per
    run times the runs (a capture adds its warm-up's); every output against
    the program's function run eagerly on the card, the CPU pipeline and,
    for the replay clusters, the recorded JAX outputs; a second request in
    one bucket with other clusters. Then the latency of a replay beside the
    eager function at 4 and 32 clusters of 2048 points."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.bn_relu import (
        bn_relu_eval,
        bn_relu_eval_gather,
        bn_relu_eval_pool,
    )
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps

    fix = np.load(FIXTURE)
    rng = np.random.default_rng(1)

    # the last request shares the (4, 1792) bucket of the second: a stale static input would show
    requests = [("replay", fix["clusters"]), ("seeded M>1024", blobs(rng, 4, 1600)),
                ("seeded M<1024", blobs(rng, 4, 700)), ("seeded M>1024, same bucket", blobs(rng, 3, 1700))]

    def compare(name, got, want, keys):
        np.testing.assert_array_equal(got["pred_class"], want["pred_class"], err_msg=name)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=f"{name} {k}")

    float_keys = ("log_probs", "rotation_deg", "rotation_matrix", "sign_prob", "translation", "width")
    outputs = []
    fps.launches = ball_query_multi.launches = bn_relu_eval.launches = bn_relu_eval_pool.launches = 0
    bn_relu_eval_gather.launches = 0
    for name, clusters in requests:
        f0, b0 = fps.launches, ball_query_multi.launches
        out, runs = runs_of(pipe.programs, lambda: pipe.infer_clusters(clusters))
        key = pipe._request_call(clusters)[0]
        want_fps = 3 if clusters.shape[1] > 1024 else 2
        check(pipe.programs.counts(key) == {"fps": want_fps, "ball_query": 2, "bn_relu_eval": 20,
                                            "bn_relu_eval_pool": 7, "bn_relu_eval_gather": 2,
                                            "grouped_bytes": key[1] * SSG_GROUPED_BYTES},
              f"{name}: the program of {key} records {pipe.programs.counts(key)}")
        got_counts = (fps.launches - f0, ball_query_multi.launches - b0)
        check(got_counts == (want_fps * runs, 2 * runs),
              f"{name}: launches fps/ball_query {got_counts}, want ({want_fps}, 2) a run, {runs} runs")
        outputs.append((name, clusters, out, key, runs))
    launches = {"fps": fps.launches, "ball_query": ball_query_multi.launches,
                "bn_relu_eval": bn_relu_eval.launches + bn_relu_eval_pool.launches,
                "bn_relu_eval_gather": bn_relu_eval_gather.launches}
    point_transformer = pt_request(pipe.device)
    launches["knn"] = point_transformer["counts"]["knn"]
    launches["pt_attention"] = point_transformer["counts"]["pt_attention"]
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
        check(k["launches"] > 0 or k["name"] not in launches, f"{k['name']} never launched on the main path")
    check(outputs[-1][3] == outputs[1][3] and outputs[-1][4] == 1,
          f"the second request of bucket {outputs[1][3]} was not a replay")
    # the card's trace of one replay runs the kernels its capture recorded
    _, traced_clusters, _, traced_key, _ = outputs[1]
    with uncounted():
        traced = profiled_launches(lambda: pipe.infer_clusters(traced_clusters))
    recorded = pipe.programs.counts(traced_key)
    check(recorded == {"fps": 3, "ball_query": 2, "bn_relu_eval": 20, "bn_relu_eval_pool": 7,
                       "bn_relu_eval_gather": 2, "grouped_bytes": traced_key[1] * SSG_GROUPED_BYTES}
          and all(traced[k] == recorded.get(k, 0) for k in traced),
          f"the profiler saw {traced} in a replay of {traced_key}, its capture recorded {recorded}")
    log(f"  one replay of {traced_key} under torch.profiler: {json.dumps(traced)}, as its capture recorded")

    report = {"requests": {}, "profiled_replay": {"bucket": list(traced_key), "launches": traced},
              "point_transformer": point_transformer}
    for name, clusters, out, key, runs in outputs:
        K = clusters.shape[0]
        check(out["rotation_matrix"].shape == (K, 3, 3) and out["translation"].shape == (K, 3),
              f"{name}: output shapes")
        check(all(np.isfinite(v).all() for v in out.values()), f"{name}: non-finite output")
        with uncounted():
            gap = output_gap(out, eager_request(pipe, clusters), name)
        compare(f"{name} vs cpu", out, cpu.infer_clusters(clusters), float_keys)
        report["requests"][name] = {"bucket": list(key), "runs": runs, "eager_gap": gap}
        log(f"  {name} K={K} M={clusters.shape[1]}: program {key}, {runs} runs; the eager run on the card "
            f"within {gap:.3g}; matches the CPU pipeline, classes {out['pred_class'].tolist()}")
    check(not np.array_equal(outputs[-1][2]["log_probs"], outputs[1][2]["log_probs"][:3]),
          "the second request of one bucket gave the first's outputs")
    compare("replay vs jax", outputs[0][2], fix,
            ("rotation_deg", "sign_prob", "translation", "width"))
    log("  replay: matches the recorded JAX outputs")

    latency = {}
    for K in (4, 32):
        clusters = blobs(rng, K, 2048)
        for what in ("replay", "eager", "replay", "eager"):                # in turns
            if what == "replay":
                row = timed(lambda: pipe.infer_clusters(clusters), 10)
            else:
                with uncounted():
                    row = timed(lambda: eager_request(pipe, clusters), 10)
            latency.setdefault(f"K={K} M=2048 {what}", []).append(row)
            log(f"  latency K={K} M=2048 {what}: {json.dumps(row)}")
    report["programs"] = programs_line("serving", pipe.programs)
    report["latency"] = latency
    return report


def eager_evaluate(spec, cfg, model, ds, device) -> dict:
    """``evaluate``'s work without its program: the same padded batches,
    each batch's sums run op by op on the card, the one copy to the host."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.nn import set_compute_dtype
    from pointnet_like_pose_estimation_tpu_torch.train.loop import (
        _batch_sums,
        _device_eval_batches,
        _finalize_eval,
        _host_sums,
    )

    model = set_compute_dtype(model, cfg.dtype).eval()
    with torch.no_grad():
        total = sum(_batch_sums(spec, cfg, model, b) for b in _device_eval_batches(ds, cfg.batch_size, device))
    return _finalize_eval(spec, cfg, _host_sums(spec, cfg, total))


# model -> (experiment directory under log/ or None for seeded weights, FPS and
# ball-query launches per batch: one each per set-abstraction level that samples)
EVAL_MODELS = {
    "pointnet2_cls_ssg": ("classification/r3_pointnet2_cls_ssg", 2),
    "sign_msg": ("pose/r5_sign_msg", 1),
    "translation_msg": ("pose/r5_translation_msg_bf16", 1),
    "rotation": ("pose/r3_rotation", 0),
    "sign": ("pose/r3_sign", 0),
    "translation": ("pose/r3_translation_ref", 0),
    "width": ("pose/r3_width_ref", 0),
    "rotation_ssg": (None, 2),
    "rotation_msg": (None, 2),
    "pointnet_cls": (None, 0),
    "pointnet2_cls_msg": (None, 2),
    "pose_feat_trans": (None, 0),
    "pose_classify": (None, 0),
}
EVAL_BATCH = 24


def eval_phase(device, kernels: list[dict]) -> dict:
    """The evaluation path: a seeded dataset built on the card by the
    ``generate`` command (``build_dataset``, 80 clouds a class, so 140 test
    clouds) and saved under build/, then ``evaluate`` at the checkpoints'
    batch size of 24 and full width for every model of EVAL_MODELS: the
    committed checkpoints, and seeded weights with nontrivial BatchNorm
    where the repository has none. Each ``evaluate`` must launch FPS and
    the ball query once per batch and sampling level. A model with a
    checkpoint also goes through the ``eval`` command, which must print the
    figures ``evaluate`` gave and launch as often. ``normalize_cloud`` must
    give the same bits on the card and on the CPU. Each model is held
    against the same code on the CPU over 48 test clouds spread over the classes: per-cloud predictions
    within TOL, classes equal, hard signs equal wherever the probability is
    more than 1e-4 from 0.5, every figure of ``evaluate`` within TOL
    relative. ``evaluate`` runs one eval program a model (a CUDA graph,
    captured at its first batch and replayed at the others): its figures
    must equal those of the same batches run eagerly on the card within
    PROGRAM_TOL. Then a request through a pipeline whose classifier is
    ``pointnet2_cls_msg`` on seeded weights against the CPU pipeline, and
    the eval throughput per model through the program and eagerly (in
    turns program, eager, eager, program, each a warm-up pass and 3 timed
    ones, the median of each kind's 6), with the program cache's line."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch import cli
    from pointnet_like_pose_estimation_tpu_torch.data import PoseDataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
    from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.ops import normalize_cloud
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
    from pointnet_like_pose_estimation_tpu_torch.train import (
        TrainConfig,
        evaluate,
        load_checkpoint,
        make_eval_step,
    )
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _device_eval_batches, eval_programs

    t0 = time.perf_counter()
    f0 = fps.launches
    data_path = os.path.join(ROOT, "build", "chip_smoke_dataset.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["generate", "--num-per-class", "80", "--seed", "0", "--out", data_path])  # default: cuda
    test = load_dataset(data_path, "test")
    check(len(test) >= 140 and test.points.shape[1:] == (1024, 3), f"test split {test.points.shape}")
    check(fps.launches > f0, "the generate command did not launch the FPS kernel")
    log(f"  dataset: {7 * 80} clouds built and saved in {time.perf_counter() - t0:.1f} s "
        f"({fps.launches - f0} FPS launches), {len(test)} test clouds")
    for what, clouds in (("test clouds", test.points), ("seeded blobs", blobs(np.random.default_rng(8), 32, 1024))):
        clouds = torch.from_numpy(clouds)
        check(torch.equal(normalize_cloud(clouds.to(device)).cpu(), normalize_cloud(clouds)),
              f"normalize_cloud of the {what}: the card's result is not the CPU's bit for bit")
    log("  normalize_cloud: equal on the card and the CPU bit for bit (test clouds, seeded blobs)")
    pick = np.linspace(0, len(test) - 1, 48).astype(int)
    subset = PoseDataset(**{k: getattr(test, k)[pick] for k in
                            ("points", "labels", "rot", "tran", "sign", "width")})
    batches = -(-len(test) // EVAL_BATCH)

    def predictions(spec, cfg, model, dev):
        step = make_eval_step(spec, cfg)
        outs = [step(model, b) for b in _device_eval_batches(subset, EVAL_BATCH, dev)]
        return {k: torch.cat([o[k] for o in outs]).cpu() for k in ("pred", "prob") if k in outs[0]}

    results, launches = {}, {"fps": 0, "ball_query": 0}
    fps.launches = ball_query_multi.launches = 0
    for i, (name, (experiment, per_batch)) in enumerate(EVAL_MODELS.items()):
        spec = get_model_spec(name)
        cfg = TrainConfig.for_model(name, batch_size=EVAL_BATCH)
        if experiment is None:
            model, meta = seeded_model(name, 20 + i), None
        else:
            model, meta = load_checkpoint(
                os.path.join(ROOT, "log", experiment, "checkpoints", "best.msgpack"),
                build_model(name))
        cpu_model = copy.deepcopy(model)
        before = (fps.launches, ball_query_multi.launches)
        res = evaluate(cfg, model, test)                                      # default: cuda
        torch.cuda.synchronize()
        got = (fps.launches - before[0], ball_query_multi.launches - before[1])
        check(got == (per_batch * batches,) * 2,
              f"{name}: fps/ball_query launches {got} per evaluate, want {per_batch * batches} each")
        launches["fps"] += got[0]
        launches["ball_query"] += got[1]
        check(all(np.isfinite(np.asarray(v, np.float64)).all() for v in res.values()),
              f"{name}: non-finite result {res}")

        if experiment is not None:
            before = (fps.launches, ball_query_multi.launches)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                cli.main(["eval", "--model", name, "--data", data_path, "--batch-size", str(EVAL_BATCH),
                          "--log-dir", os.path.join(ROOT, "log"),
                          "--experiment", os.path.basename(experiment)])       # default: cuda
            torch.cuda.synchronize()
            from_cli = json.loads(printed.getvalue().strip().splitlines()[-1])
            check(from_cli.pop("checkpoint_epoch") == meta["epoch"], f"{name}: eval command's epoch")
            check(set(from_cli) == set(res) and all(
                np.allclose(from_cli[k], res[k], rtol=1e-6, atol=1e-6) for k in res),
                f"{name}: the eval command printed {from_cli}, evaluate gave {res}")
            cli_got = (fps.launches - before[0], ball_query_multi.launches - before[1])
            check(cli_got == got, f"{name}: eval command launched fps/ball_query {cli_got}, evaluate {got}")
            launches["fps"] += cli_got[0]
            launches["ball_query"] += cli_got[1]

        on_card = evaluate(cfg, model, subset)
        on_cpu = evaluate(cfg, cpu_model, subset, device="cpu")
        check(set(on_card) == set(on_cpu), f"{name}: result keys differ")
        for key, want in on_cpu.items():
            check(np.allclose(on_card[key], want, rtol=TOL, atol=TOL),
                  f"{name}: {key} on the card {on_card[key]} differs from the CPU {want}")
        p_card, p_cpu = predictions(spec, cfg, model, device), predictions(spec, cfg, cpu_model, "cpu")
        if spec.task == "classify":
            check(torch.equal(p_card["pred"], p_cpu["pred"]), f"{name}: classes differ from the CPU")
        elif spec.task == "sign":
            check(torch.allclose(p_card["prob"], p_cpu["prob"], rtol=TOL, atol=TOL),
                  f"{name}: probabilities differ from the CPU")
            sure = (p_cpu["prob"] - 0.5).abs() > 1e-4
            check(torch.equal(p_card["pred"][sure], p_cpu["pred"][sure]),
                  f"{name}: hard signs differ from the CPU")
        else:
            diff = float((p_card["pred"] - p_cpu["pred"]).abs().max())
            check(torch.allclose(p_card["pred"], p_cpu["pred"], rtol=TOL, atol=TOL),
                  f"{name}: predictions differ from the CPU (max {diff})")

        def one_pass():
            evaluate(cfg, model, test)
            torch.cuda.synchronize()

        def eager_pass():
            return eager_evaluate(spec, cfg, model, test, device)

        with uncounted():
            eager_res = eager_pass()
        check(set(eager_res) == set(res) and all(np.allclose(eager_res[k], res[k], rtol=PROGRAM_TOL, atol=PROGRAM_TOL)
                                                 for k in res),
              f"{name}: evaluate's program gave {res}, the same batches run eagerly on the card {eager_res}")
        times = {}
        with uncounted():
            for what, fn in (("program", one_pass), ("eager", eager_pass), ("eager", eager_pass),
                             ("program", one_pass)):        # in turns
                fn()
                for _ in range(3):
                    t1 = time.perf_counter()
                    fn()
                    times.setdefault(what, []).append(time.perf_counter() - t1)
        headline = res.get("instance_acc", res.get("mean_err"))
        results[name] = {
            "weights": experiment or "seeded", "metric": res["metric"], "headline": headline,
            "loss": res["loss"], "clouds_per_s": len(test) / statistics.median(times["program"]),
            "clouds_per_s_eager": len(test) / statistics.median(times["eager"]),
            "programs": programs_line(f"eval {name}", eval_programs(model, device)),
            "fps_and_ball_query_launches_per_batch": got[0] // batches,
            "eval_command": experiment is not None,
            "checkpoint_metric": None if meta is None else meta["metric"],
        }
        log(f"  eval {name} ({experiment or 'seeded weights'}): matches the CPU on 48 clouds; "
            f"{json.dumps(results[name])}")
    check(results["pointnet2_cls_ssg"]["headline"] >= 0.95,
          f"r3 pointnet2_cls_ssg instance accuracy {results['pointnet2_cls_ssg']['headline']} < 0.95")
    log(f"  sign_msg accuracy {results['sign_msg']['metric']:.4f} on this draw "
        f"(best.msgpack.json: {results['sign_msg']['checkpoint_metric']:.4f}); translation_msg "
        f"{results['translation_msg']['headline']:.3f} cm a axis "
        f"(best.msgpack.json: {results['translation_msg']['checkpoint_metric']:.3f})")
    check(launches["fps"] > 0 and launches["ball_query"] > 0, "the eval path launched no kernel")
    for k in kernels:
        k["launches_by_path"]["eval"] = launches.get(k["name"], 0)

    cfg = PipelineConfig(classifier="pointnet2_cls_msg")
    pipe = GraspPipeline.from_random(cfg, seed=7)                             # default: cuda
    cpu = GraspPipeline.from_random(cfg, seed=7, device="cpu")
    clusters = blobs(np.random.default_rng(6), 4, 1600)
    before = (fps.launches, ball_query_multi.launches)
    out, runs = runs_of(pipe.programs, lambda: pipe.infer_clusters(clusters))
    got = (fps.launches - before[0], ball_query_multi.launches - before[1])
    check(got == (3 * runs, 2 * runs), f"MSG-classifier request: fps/ball_query launches {got}, want (3, 2) "
          f"a run of its program, {runs} runs")
    with uncounted():
        gap = output_gap(out, eager_request(pipe, clusters), "MSG-classifier request")
    want = cpu.infer_clusters(clusters)
    check(np.array_equal(out["pred_class"], want["pred_class"]), "MSG-classifier request: classes")
    for key in ("log_probs", "rotation_deg", "rotation_matrix", "sign_prob", "translation", "width"):
        check(np.allclose(out[key], want[key], rtol=TOL, atol=TOL),
              f"MSG-classifier request: {key} differs from the CPU pipeline")
    log(f"  request with classifier=pointnet2_cls_msg (seeded weights): the eager run on the card within "
        f"{gap:.3g}; matches the CPU pipeline, classes {out['pred_class'].tolist()}")
    return results


TRAIN_BATCH = 24
# gradient misses of the card-against-CPU train steps, reported together and
# failing the run at its end
STEP_FAILURES: list[str] = []
# model -> (committed experiment or None for seeded weights, FPS and
# ball-query launches per train step)
TRAIN_STEP_MODELS = {"pointnet2_cls_ssg": ("classification/r3_pointnet2_cls_ssg", 2),
                     "sign_msg": ("pose/r5_sign_msg", 1),
                     "pointnet_cls": (None, 0),
                     "rotation_ssg": (None, 2)}


def step_pair(device, name, experiment, data_path, dtype="float32", seed=40):
    """One train step of ``name`` at batch 24 of the generated dataset, on the
    card and on the CPU from the same weights (the committed ``experiment``
    or ``seeded_model``) with the same augmentation and dropout draws (made
    once on the CPU). The card's step is a replay of its training program:
    the program is captured at a first call, the card's model and optimizer
    are then put back in place to the start (the parameters and statistics
    copied in, Adam's moments and step count zeroed, which its first step
    treats as a fresh state), and the step held against the CPU is the
    second call. Beside it the eager step on the card, from a copy of the
    start. Returns ``(cfg, cpu_model, card_model, cpu_out, card_out,
    launches, params_before, linear_dtypes, eager)``; ``launches`` counts
    the replay's FPS and ball-query launches, ``linear_dtypes`` the dtypes
    of the card's Linear outputs in the captured forward, ``eager`` the
    eager step's ``(model, out)`` and the program cache's line."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.data import PoseDataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
    from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.nn import set_compute_dtype
    from pointnet_like_pose_estimation_tpu_torch.train import (
        TrainConfig,
        draw_step,
        load_checkpoint,
        make_optimizer,
        make_train_step,
    )
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _device_data

    ds = load_dataset(data_path, "train")
    pick = np.linspace(0, len(ds) - 1, TRAIN_BATCH).astype(int)        # every class
    cpu_batch = _device_data(PoseDataset(**{k: getattr(ds, k)[pick] for k in
                                            ("points", "labels", "rot", "tran", "sign", "width")}), "cpu")
    card_batch = {k: v.to(device) for k, v in cpu_batch.items()}
    spec = get_model_spec(name)
    cfg = TrainConfig.for_model(name, batch_size=TRAIN_BATCH, dtype=dtype)
    if experiment is None:
        cpu_model = seeded_model(name, seed)
    else:
        cpu_model, _ = load_checkpoint(os.path.join(ROOT, "log", experiment, "checkpoints", "best.msgpack"),
                                       build_model(name))
    cpu_model = set_compute_dtype(cpu_model, dtype)
    card_model = copy.deepcopy(cpu_model).to(device)
    eager_model = copy.deepcopy(card_model)
    start = {k: v.clone() for k, v in card_model.state_dict().items()}
    before = {k: p.detach().clone() for k, p in cpu_model.named_parameters()}
    draws = draw_step(cfg, cpu_model, cpu_batch, torch.Generator().manual_seed(31))   # made once
    card_draws = {part: {k: v.to(device) for k, v in d.items()} for part, d in draws.items()}
    step = make_train_step(spec, cfg)
    card_opt = make_optimizer(cfg, card_model.parameters())[0]
    linear_dtypes = set()
    hooks = [m.register_forward_hook(lambda m, i, o: linear_dtypes.add(o.dtype))
             for m in card_model.modules() if isinstance(m, torch.nn.Linear)]
    with uncounted():
        step(card_model, card_opt, card_batch, draws=card_draws)            # runs the step, then captures it
    for h in hooks:
        h.remove()
    card_model.load_state_dict(start)
    for state in card_opt.state.values():
        for t in state.values():
            t.zero_()
    f0, b0 = fps.launches, ball_query_multi.launches
    card_out = step(card_model, card_opt, card_batch, draws=card_draws)    # a replay
    torch.cuda.synchronize()
    launches = (fps.launches - f0, ball_query_multi.launches - b0)
    programs = step.cache(device)
    check((programs.captures, programs.replays, programs.remade) == (1, 1, 0),
          f"train step {name} {dtype}: the step held against the CPU is no replay of its program")
    card_out = {k: v.clone() for k, v in card_out.items()}
    with uncounted():
        eager_out = step.eager(eager_model, make_optimizer(cfg, eager_model.parameters())[0], card_batch,
                               draws=card_draws)
    cpu_out = step(cpu_model, make_optimizer(cfg, cpu_model.parameters())[0], cpu_batch, draws=draws)
    eager = {"model": eager_model, "out": eager_out,
             "programs": programs_line(f"train step {name} {dtype}", programs)}
    return cfg, cpu_model, card_model, cpu_out, card_out, launches, before, linear_dtypes, eager


def train_step_check(device, name, experiment, per_step, data_path):
    """One float32 train step on the card against the same step on the CPU
    (see the module docstring); returns the largest differences and the
    named gradient tensors held by relative L2 (TIED_GRADIENTS)."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.nn import pre_bn_biases

    cfg, cpu_model, card_model, cpu_out, card_out, got, before, dtypes, eager = step_pair(
        device, name, experiment, data_path)
    check(got == (per_step, per_step), f"train step {name}: fps/ball_query launches {got}, want {per_step} each")
    check(dtypes == {torch.float32}, f"train step {name}: the card's Linear layers gave {dtypes}")

    worst, by_norm, missed = {}, {}, {}

    def close(what, a, b, atol=TRAIN_TOL):
        a, b = a.detach().cpu().double(), b.detach().double()
        diff = float((a - b).abs().max()) if a.numel() else 0.0
        group = what.split(" ")[0]
        worst[group] = max(worst.get(group, 0.0), diff)
        return bool(torch.allclose(a, b, rtol=TRAIN_TOL, atol=atol)), diff

    def must(what, a, b):
        ok, diff = close(what, a, b)
        check(ok, f"train step {name}: {what} on the card differs from the CPU (max {diff})")

    for key in ("loss", "metric"):
        must(key, card_out[key], cpu_out[key])
    card_params = dict(card_model.named_parameters())
    tied, tied_bound = TIED_GRADIENTS.get(name, ((), 0.0))
    noisy = pre_bn_biases(cpu_model)
    scale = max(1.0, max(float(p.grad.abs().max()) for p in cpu_model.parameters()))
    for k, p in cpu_model.named_parameters():
        ok, diff = close(f"gradient {k}", card_params[k].grad, p.grad, TRAIN_TOL * scale)
        if ok:
            continue
        rel = float((card_params[k].grad.cpu() - p.grad).norm() / p.grad.norm())
        (by_norm if k.startswith(tied) and k not in noisy else missed)[k] = {"max_abs_diff": diff, "rel_l2": rel}
    if missed:
        STEP_FAILURES.append(f"train step {name}: gradients on the card differ from the CPU by more than "
                             f"{TRAIN_TOL}: {json.dumps(missed)}")
        log("  " + STEP_FAILURES[-1])
    for k, d in by_norm.items():
        check(d["rel_l2"] <= tied_bound, f"train step {name}: gradient {k} on the card differs from the "
              f"CPU by {d['rel_l2']} of its norm, over {tied_bound}")
    card_state = card_model.state_dict()
    for k, v in cpu_model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            must(f"statistic {k}", card_state[k], v)
    # Adam's first step is lr * g / (|g| + 1e-8): it follows the sign of g,
    # so where the two gradients differ by more than half of |g| (and at the
    # pre-BN biases, whose true gradient is 0) each side is held to one step
    # of the learning rate from the start, elsewhere to TRAIN_TOL
    lr, wd = cfg.learning_rate, cfg.weight_decay
    for k, p in cpu_model.named_parameters():
        card_g = card_params[k].grad.detach().cpu()
        floor = (p.grad + wd * before[k]).abs() <= 1e-6 + 2 * (card_g - p.grad).abs()
        if k in noisy:
            floor[...] = True
        card_p = card_params[k].detach().cpu()
        # one learning rate, and the float32 rounding of the parameter itself
        step_bound = lr * 1.0001 + torch.finfo(torch.float32).eps * before[k].abs()
        for side in (card_p, p.detach()):
            check(bool(((side - before[k]).abs() <= step_bound)[floor].all()),
                  f"train step {name}: {k} moved more than the learning rate at Adam's rounding floor")
        must(f"parameter {k}", card_p[~floor], p.detach()[~floor])
    replay = hold_step(f"train step {name}: the replay against the eager step on the card", name, card_model,
                       eager["model"], card_out, eager["out"])
    log(f"  train step {name} B={TRAIN_BATCH} ({experiment or 'seeded weights'}): the replay of its program "
        f"matches the CPU (loss {float(cpu_out['loss']):.6f}; gradient scale {scale:.4g}; max abs diff "
        f"{json.dumps(worst)}; named gradients held by relative L2: {json.dumps(by_norm)}); fps/ball_query "
        f"launches {got}; against the eager step on the card {json.dumps(replay['max_abs_diff'])}")
    return {"loss": float(cpu_out["loss"]), "gradient_scale": scale, "max_abs_diff": worst,
            "named_gradients_by_rel_l2": by_norm, "replay_vs_eager_max_abs_diff": replay["max_abs_diff"],
            "programs": eager["programs"],
            "fps_and_ball_query_launches": got[0], "weights": experiment or "seeded"}


def bf16_train_step_check(device, name, experiment, per_step, data_path) -> dict:
    """One bfloat16 train step on the card against the CPU's bfloat16 and
    float32 steps (the BF16_* bounds above); returns what was measured."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.nn import pre_bn_biases

    _, cpu16, card16, cpu_out, card_out, got, _, dtypes, eager = step_pair(device, name, experiment, data_path,
                                                                             "bfloat16")
    check(got == (per_step, per_step), f"bf16 train step {name}: fps/ball_query launches {got}, want {per_step}")
    check(dtypes == {torch.bfloat16}, f"bf16 train step {name}: the card's Linear layers gave {dtypes}")
    _, cpu32, _, out32, *_ = step_pair(device, name, experiment, data_path, "float32")
    loss, loss16, loss32 = float(card_out["loss"]), float(cpu_out["loss"]), float(out32["loss"])
    check(abs(loss - loss16) <= BF16_LOSS_TOL and abs(loss - loss32) <= max(2 * abs(loss16 - loss32),
                                                                               BF16_LOSS_TOL),
          f"bf16 train step {name}: loss {loss} on the card, {loss16} bf16 / {loss32} f32 on the CPU")
    noisy = pre_bn_biases(cpu16)
    card_g = {k: p.grad.detach().cpu().double() for k, p in card16.named_parameters() if k not in noisy}
    g16 = {k: p.grad.detach().double() for k, p in cpu16.named_parameters() if k in card_g}
    g32 = {k: p.grad.detach().double() for k, p in cpu32.named_parameters() if k in card_g}

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    worst_ratio = 0.0
    for k in card_g:
        gap, cpu_gap = rel(card_g[k], g32[k]), rel(g16[k], g32[k])
        worst_ratio = max(worst_ratio, gap / max(cpu_gap, 1e-30))
        check(gap <= max(2 * cpu_gap, BF16_GRAD_FLOOR),
              f"bf16 train step {name}: gradient {k} {gap} from the CPU's float32 one, its bf16 {cpu_gap}")
    cat = lambda d: torch.cat([d[k].reshape(-1) for k in card_g])  # noqa: E731
    whole, whole32 = rel(cat(card_g), cat(g16)), rel(cat(card_g), cat(g32))
    check(whole <= BF16_GRAD_REL_L2 and whole < whole32,
          f"bf16 train step {name}: gradients {whole} from the CPU's bf16 step and {whole32} from its f32 "
          f"step (relative L2)")
    stats = 0.0
    card_state = card16.state_dict()
    for k, v in cpu16.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            stats = max(stats, float((card_state[k].cpu() - v).abs().max()))
    check(stats <= BF16_STATS_TOL, f"bf16 train step {name}: BN statistics {stats} from the CPU's")
    eager_g = {k: p.grad.detach().cpu().double() for k, p in eager["model"].named_parameters() if k in card_g}
    out = {"replay_vs_eager_grad_rel_l2": rel(cat(card_g), cat(eager_g)),
           "replay_vs_eager_loss": abs(loss - float(eager["out"]["loss"])),
           "loss_card": loss, "loss_cpu_bf16": loss16, "loss_cpu_f32": loss32, "grad_rel_l2_vs_cpu_bf16": whole,
           "grad_rel_l2_vs_cpu_f32": whole32, "cpu_bf16_vs_f32_grad_rel_l2": rel(cat(g16), cat(g32)), "worst_tensor_gap_ratio": worst_ratio,
           "stats_max_abs_diff": stats, "fps_and_ball_query_launches": got[0]}
    log(f"  bf16 train step {name} B={TRAIN_BATCH}: card matches the CPU within the stated bounds "
        f"{json.dumps(out)}")
    return out


def train_throughput(device, name, B, data, dtype="float32", make_step=None, span_ms=2000.0,
                     eager=False) -> dict:
    """Training clouds/s at batch B in ``dtype``: train steps on batches
    drawn on the card from the resident split, CUDA events around spans of
    ``span_ms`` or more, median of 3; peak device memory over the spans.
    ``make_step(spec, cfg)`` builds the step (``make_train_step`` unless
    given); with ``eager`` the step runs op by op (``TrainStep.eager``),
    else a step of ``make_train_step`` replays its program, whose cache's
    line (captures, capture seconds, replays, pool MB) is reported. The
    step and its program are freed before this returns."""
    import gc

    import torch

    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, build_state, make_train_step

    cfg = TrainConfig.for_model(name, batch_size=B, dtype=dtype)
    spec, state = build_state(cfg, device)
    step = (make_step or make_train_step)(spec, cfg)
    call = step.eager if eager else step
    n = data["labels"].shape[0]

    def run(steps):
        for _ in range(steps):
            idx = torch.randint(0, n, (B,), generator=state.generator, device=device)
            call(state.model, state.optimizer, {k: v[idx] for k, v in data.items()}, state.generator)

    def span(steps) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(steps)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    run(3)
    torch.cuda.synchronize()
    steps = max(1, int(np.ceil(span_ms / (span(5) / 5))))
    torch.cuda.reset_peak_memory_stats()
    spans = []
    while len(spans) < 3:
        ms = span(steps)
        if ms < span_ms:        # the calibration ran fast: lengthen the span and start over
            steps, spans = int(np.ceil(steps * span_ms / ms)) + 1, []
        else:
            spans.append(ms)
    ms = statistics.median(spans)
    out = {"clouds_per_s": steps * B / (ms / 1e3), "ms_per_step": ms / steps, "steps_per_span": steps,
           "span_ms": spans, "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20}
    if not eager and hasattr(step, "cache"):
        out["programs"] = programs_line(f"train {name} {dtype} B={B}", step.cache(device))
    log(f"  train throughput {name} {dtype} B={B}{' eager' if eager else ''}: {json.dumps(out)}")
    del step, call, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profiled_train_replay(device, data) -> dict:
    """One replay of a pointnet2_cls_ssg train step under torch.profiler:
    the FPS and ball-query kernels run on the card inside the graph, as
    many as its capture recorded (the launches are no main-path ones)."""
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, build_state, make_train_step

    cfg = TrainConfig.for_model("pointnet2_cls_ssg", batch_size=TRAIN_BATCH)
    spec, state = build_state(cfg, device)
    step = make_train_step(spec, cfg)
    batch = {k: v[:TRAIN_BATCH] for k, v in data.items()}
    with uncounted():
        step(state.model, state.optimizer, batch, state.generator)         # runs the step, then captures it
        seen = profiled_launches(lambda: step(state.model, state.optimizer, batch, state.generator))
    programs = step.cache(device)
    recorded = programs.counts(programs.keys()[0])
    check(programs.replays == 1 and seen["fps"] == recorded["fps"] == 2
          and seen["ball_query"] == recorded["ball_query"] == 2
          and seen["bn_relu"] == recorded["bn_relu"] == 9 and recorded.get("bn_relu_plain", 0) == 0,
          f"a train step's replay under the profiler ran {seen}, its capture recorded {recorded}")
    log(f"  a train step's replay under the profiler ran {seen} on the card, as its capture recorded")
    return {"profiled": seen, "recorded": recorded}


def train_phase(device, kernels: list[dict]) -> dict:
    """The training path; see the module docstring."""
    import shutil

    import torch

    from pointnet_like_pose_estimation_tpu_torch import cli
    from pointnet_like_pose_estimation_tpu_torch.data import load_dataset
    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.bn_relu import bn_relu, plain_bn_relu
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, evaluate, load_checkpoint
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _device_data

    data_path = os.path.join(ROOT, "build", "chip_smoke_dataset.npz")       # the eval phase's
    report = {"step": {}, "train_command": {}, "throughput": {}}
    fps.launches = ball_query_multi.launches = bn_relu.launches = plain_bn_relu.launches = 0
    for name, (experiment, per_step) in TRAIN_STEP_MODELS.items():
        report["step"][name] = train_step_check(device, name, experiment, per_step, data_path)

    log_dir = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(log_dir, ignore_errors=True)
    train_ds, test = load_dataset(data_path, "train"), load_dataset(data_path, "test")
    steps_per_epoch, eval_batches = len(train_ds) // TRAIN_BATCH, -(-len(test) // TRAIN_BATCH)
    for name, per_step in (("pointnet2_cls_ssg", 2), ("rotation", 0)):
        f0 = fps.launches
        args = ["--model", name, "--data", data_path, "--batch-size", str(TRAIN_BATCH),
                "--log-dir", log_dir, "--experiment", f"smoke_{name}"]
        t0 = time.perf_counter()
        for epochs in ("2", "3"):                   # the second call resumes from latest.pt
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["train", *args, "--epochs", epochs])                # default: cuda
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        cfg = TrainConfig.for_model(name, batch_size=TRAIN_BATCH, log_dir=log_dir, experiment=f"smoke_{name}")
        exp_dir = os.path.join(log_dir, "classification" if "cls" in name else "pose", f"smoke_{name}")
        with open(os.path.join(exp_dir, "history.json")) as f:
            history = json.load(f)
        check([r["epoch"] for r in history] == [0, 1, 2], f"train {name}: history.json epochs "
              f"{[r['epoch'] for r in history]}, want [0, 1, 2]")
        losses = [r["train_loss"] for r in history]
        check(all(np.isfinite(losses)), f"train {name}: non-finite loss {losses}")
        want_fps = per_step * 3 * (steps_per_epoch + eval_batches)
        check(fps.launches - f0 == want_fps, f"train {name}: {fps.launches - f0} FPS launches, want {want_fps}")
        model, meta = load_checkpoint(os.path.join(exp_dir, "checkpoints", "best.pt"), build_model(name))
        want = evaluate(cfg, model, test)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cli.main(["eval", *args])
        from_cli = json.loads(printed.getvalue().strip().splitlines()[-1])
        check(from_cli.pop("checkpoint_epoch") == meta["epoch"], f"eval of best.pt {name}: epoch")
        check(set(from_cli) == set(want) and all(np.allclose(from_cli[k], want[k], rtol=1e-6, atol=1e-6)
                                                  for k in want),
              f"eval of best.pt {name}: the eval command printed {from_cli}, evaluate gave {want}")
        report["train_command"][name] = {
            "train_loss_by_epoch": losses, "test_metric_by_epoch": [r.get("test_metric") for r in history],
            "best_epoch": meta["epoch"], "seconds_for_3_epochs_with_eval": seconds,
            "seconds_per_epoch": [r["seconds"] for r in history], "fps_launches": fps.launches - f0}
        log(f"  train command {name}: 2 epochs, then resumed for a third; train loss by epoch {losses}; "
            f"test metric {report['train_command'][name]['test_metric_by_epoch']}; eval of best.pt "
            f"(epoch {meta['epoch']}) equals evaluate")
    losses = report["train_command"]["pointnet2_cls_ssg"]["train_loss_by_epoch"]
    check(losses[2] < losses[0], f"pointnet2_cls_ssg: the train loss did not fall: {losses}")
    launches = {"fps": fps.launches, "ball_query": ball_query_multi.launches, "bn_relu": bn_relu.launches,
                "bn_relu_plain": plain_bn_relu.launches}
    check(launches["fps"] > 0 and launches["ball_query"] > 0 and launches["bn_relu"] > 0,
          "the train path launched no kernel")
    for k in kernels:
        k["launches_by_path"]["train"] = launches.get(k["name"], 0)
        if k["name"] == "bn_relu":
            k["launches"] = launches["bn_relu"]
    report["launches"] = launches

    data = _device_data(train_ds, device)
    report["profiled_replay"] = profiled_train_replay(device, data)
    for B in (24, 256):
        for dtype in ("float32", "bfloat16"):       # in turns, in one process
            key = f"pointnet2_cls_ssg B={B}" + ("" if dtype == "float32" else " bfloat16")
            for eager in (True, False):             # the eager step, then the program
                report["throughput"][key + (" eager" if eager else "")] = train_throughput(
                    device, "pointnet2_cls_ssg", B, data, dtype, eager=eager)
    return report


BF16_EXPERIMENT = "classification/r5_pn2_ssg_bf16"
# bfloat16 on the card against bfloat16 on the CPU: a logit that the two
# round to neighbouring bfloat16 values moves every log-probability of its
# cloud by one bfloat16 ulp of the logit, 2^-4 for logits of magnitude 8 to
# 16 (measured: 0.0625 on r5_pn2_ssg_bf16), so two such ulps; classes are
# held where the CPU's two best log-probabilities lie more than BF16_SURE
# apart
BF16_OUT_TOL, BF16_SURE = 2.0 ** -3, 0.1


def bf16_phase(device, kernels: list[dict]) -> dict:
    """bfloat16 on the card: one train step of pointnet2_cls_ssg against the
    CPU's (bf16_train_step_check); ``evaluate`` of the committed
    r5_pn2_ssg_bf16 checkpoint in bfloat16 against the CPU on 48 test clouds
    (log-probabilities within BF16_OUT_TOL, classes where sure) and its eval
    throughput beside float32; a request in bfloat16 from the five r3
    checkpoints against the CPU pipeline in bfloat16, and its latency at 4
    and 32 clusters. FPS and the ball query must launch on every part."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.data import PoseDataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
    from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, evaluate, load_checkpoint
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _device_eval_batches
    from pointnet_like_pose_estimation_tpu_torch.train.steps import _prepare_inputs

    data_path = os.path.join(ROOT, "build", "chip_smoke_dataset.npz")       # the eval phase's
    report = {}
    fps.launches = ball_query_multi.launches = 0
    report["train_step"] = bf16_train_step_check(device, "pointnet2_cls_ssg", "classification/r3_pointnet2_cls_ssg",
                                                 2, data_path)

    name = "pointnet2_cls_ssg"
    test = load_dataset(data_path, "test")
    pick = np.linspace(0, len(test) - 1, 48).astype(int)
    subset = PoseDataset(**{k: getattr(test, k)[pick] for k in ("points", "labels", "rot", "tran", "sign", "width")})
    path = os.path.join(ROOT, "log", BF16_EXPERIMENT, "checkpoints", "best.msgpack")
    card, meta = load_checkpoint(path, build_model(name, dtype="bfloat16"))
    cpu = copy.deepcopy(card)
    cfg16 = TrainConfig.for_model(name, batch_size=EVAL_BATCH, dtype="bfloat16")
    batches = -(-len(test) // EVAL_BATCH)
    f0 = fps.launches
    res = evaluate(cfg16, card, test)                                        # default: cuda
    torch.cuda.synchronize()
    check(fps.launches - f0 == 2 * batches, f"bf16 evaluate: {fps.launches - f0} FPS launches, want {2 * batches}")

    def log_probs(model, dev):
        model = model.to(dev).eval()
        outs = []
        with torch.inference_mode():
            for b in _device_eval_batches(subset, EVAL_BATCH, dev):
                inputs, _ = _prepare_inputs(get_model_spec(name), cfg16, b, train=False)
                outs.append(model(*inputs)[0].float().cpu())
        return torch.cat(outs)

    lp_card, lp_cpu = log_probs(card, device), log_probs(cpu, "cpu")
    diff = float((lp_card - lp_cpu).abs().max())
    check(torch.allclose(lp_card, lp_cpu, rtol=0.0, atol=BF16_OUT_TOL),
          f"bf16 evaluate: log-probabilities on the card differ from the CPU by {diff}")
    top2 = lp_cpu.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > BF16_SURE
    check(torch.equal(lp_card.argmax(-1)[sure], lp_cpu.argmax(-1)[sure]), "bf16 evaluate: classes differ")
    on_cpu = evaluate(cfg16, cpu, subset, device="cpu")
    on_card = evaluate(cfg16, card, subset)
    check(abs(on_card["instance_acc"] - on_cpu["instance_acc"]) <= (~sure).sum().item() / len(subset),
          f"bf16 evaluate: accuracy {on_card['instance_acc']} on the card, {on_cpu['instance_acc']} on the CPU")
    throughput = {}
    for dtype in ("float32", "bfloat16", "float32", "bfloat16"):            # in turns
        cfg = TrainConfig.for_model(name, batch_size=EVAL_BATCH, dtype=dtype)
        evaluate(cfg, card, test)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            evaluate(cfg, card, test)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        throughput.setdefault(dtype, []).append(len(test) / statistics.median(times))
    report["evaluate"] = {"checkpoint": BF16_EXPERIMENT, "instance_acc": res["instance_acc"],
                          "checkpoint_metric": meta["metric"], "log_probs_max_abs_diff_vs_cpu": diff,
                          "unsure_clouds": int((~sure).sum()), "clouds_per_s": throughput}
    log(f"  bf16 evaluate {BF16_EXPERIMENT}: matches the CPU on 48 clouds (log-probs max abs diff {diff:.3g}); "
        f"{json.dumps(report['evaluate'])}")

    paths = {k: os.path.join(ROOT, v) for k, v in CHECKPOINTS.items()}
    pipe = GraspPipeline.from_checkpoints(PipelineConfig(dtype="bfloat16"), paths)   # default: cuda
    cpu_pipe = GraspPipeline.from_checkpoints(PipelineConfig(dtype="bfloat16"), paths, device="cpu")
    rng = np.random.default_rng(9)
    clusters = blobs(rng, 4, 1600)
    f0, b0 = fps.launches, ball_query_multi.launches
    out, runs = runs_of(pipe.programs, lambda: pipe.infer_clusters(clusters))
    got = (fps.launches - f0, ball_query_multi.launches - b0)
    check(got == (3 * runs, 2 * runs), f"bf16 request: fps/ball_query launches {got}, want (3, 2) a run, {runs} runs")
    with uncounted():
        gap = output_gap(out, eager_request(pipe, clusters), "bf16 request")
    want = cpu_pipe.infer_clusters(clusters)
    check(all(v.dtype == np.float32 for k, v in out.items() if k != "pred_class"), "bf16 request: outputs not f32")
    top2 = np.sort(want["log_probs"], -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > BF16_SURE
    check(np.array_equal(out["pred_class"][sure], want["pred_class"][sure]), "bf16 request: classes differ")
    worst = {k: float(np.abs(out[k] - want[k]).max()) for k in
             ("log_probs", "rotation_deg", "sign_prob", "translation", "width")}
    for k in worst:             # one bfloat16 ulp relative, BF16_OUT_TOL absolute
        check(np.allclose(out[k], want[k], rtol=2.0 ** -7, atol=BF16_OUT_TOL),
              f"bf16 request: {k} differs from the CPU by {worst[k]}")
    log(f"  bf16 request K=4 M=1600: the eager run on the card within {gap:.3g}; classes "
        f"{out['pred_class'].tolist()} (CPU {want['pred_class'].tolist()}), max abs diff from the CPU "
        f"{json.dumps(worst)}")
    latency = {}
    pipe32 = GraspPipeline.from_checkpoints(PipelineConfig(), paths)
    for K in (4, 32):
        c = blobs(rng, K, 2048)
        for what, p in (("float32", pipe32), ("bfloat16", pipe)):          # in turns
            latency[f"K={K} M=2048 {what}"] = timed(lambda: p.infer_clusters(c), 10)
            with uncounted():
                latency[f"K={K} M=2048 {what} eager"] = timed(lambda: eager_request(p, c), 10)
            for w in (what, f"{what} eager"):
                log(f"  latency {w} K={K} M=2048: {json.dumps(latency[f'K={K} M=2048 {w}'])}")
    report["request"] = {"max_abs_diff_vs_cpu": worst, "eager_gap": gap, "latency": latency,
                         "programs": programs_line("bf16", pipe.programs)}
    launches = {"fps": fps.launches, "ball_query": ball_query_multi.launches}
    check(launches["fps"] > 0 and launches["ball_query"] > 0, "the bf16 path launched no kernel")
    for k in kernels:
        k["launches_by_path"]["bf16"] = launches.get(k["name"], 0)
    report["launches"] = launches
    return report


# the replay scene's thresholds (tests/test_e2e_replay.py) and the synthetic
# frames' (scripts/bench_e2e_latency.py)
FIXTURE_CFG = dict(clip_range=(-1.0, 0.0), min_points=200, radius_nb_points=60, radius=0.03, eps=0.04)
FRAME_CFG = dict(clip_range=(-1.0, 0.0), min_points=500, eps=0.03)
FRAME_BUDGET_MS = 1000.0 / 30.0          # the reference camera's 30 frames/s
# (label, table points) of the frames served end to end, each drawn with
# FRAME_SEEDS seeds
FRAMES = (("28k", 20000), ("300k", 292000))
FRAME_SEEDS = 4
# a camera's stream of one scene: CAMERA_FRAMES distinct frames (2 s at 30
# frames/s) a run, each with depth noise of CAMERA_DEPTH_SD m and a share of
# its points drawn from [0, CAMERA_MAX_DROPOUT) lost (pixels without depth)
CAMERA_FRAMES, CAMERA_DEPTH_SD, CAMERA_MAX_DROPOUT = 60, 0.001, 0.05


def synthetic_frame(n_table: int, seed: int = 0) -> np.ndarray:
    """A raw frame in the camera's convention (z negative): a table of
    ``n_table`` points at z = -0.7 (sd 1.5 mm) over 1 m x 1 m, a cube and a
    cylinder from the dataset generators (their camera-facing halves, 4,000
    points each) standing in front of it, and 60 far outliers. 20,000 table
    points make the 28k frame; 292,000 the raw size of a 640x480 frame."""
    from pointnet_like_pose_estimation_tpu_torch.data import generators

    rng = np.random.default_rng(seed)
    table = np.column_stack([rng.uniform(-0.5, 0.5, n_table), rng.uniform(-0.5, 0.5, n_table),
                             -0.7 + rng.normal(0, 0.0015, n_table)])
    objects = []
    for cat, pos in (("cube", (-0.15, 0.1)), ("cylinder", (0.2, -0.05))):
        dense = generators.clip_half(generators.dense_surface(generators.sample_category_params(cat, rng)))
        dense = dense[rng.choice(len(dense), min(4000, len(dense)), replace=False)]
        objects.append(dense + np.array([pos[0], pos[1], -0.66]))
    far = rng.uniform(-1, 1, (60, 3)) + [0, 0, -1.5]
    return np.concatenate([table, *objects, far]).astype(np.float32)


def camera_frames(n_table: int, seed: int, first: int, count: int) -> list[np.ndarray]:
    """Frames ``first`` to ``first + count`` of a camera that looks at the
    scene ``synthetic_frame(n_table, seed)``: each frame the scene with its
    own depth noise (z, CAMERA_DEPTH_SD) and its own share of points lost,
    so that the point counts of the scene and of its clusters vary from
    frame to frame as a camera's do."""
    base = synthetic_frame(n_table, seed)
    frames = []
    for i in range(first, first + count):
        rng = np.random.default_rng((seed, i))
        frame = base[rng.random(len(base)) >= rng.uniform(0, CAMERA_MAX_DROPOUT)]
        frame[:, 2] += rng.normal(0, CAMERA_DEPTH_SD, len(frame)).astype(np.float32)
        frames.append(frame)
    return frames


def eager_frame(pipe, frame):
    """``__call__``'s work on the card with the scene program's function run
    eagerly: (grasps or None, the scene program's key or None, the JAX
    package's key for the scene, with the scene rounded up to 2048 points
    in place of the pipeline's buffer)."""
    from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess as pp

    cfg = pipe.cfg
    pts = pp.clip_distance(frame, cfg.clip_range, cfg.clip_axis)
    if len(pts) < cfg.min_points:
        return None, None, None
    cleaned = pp.clean_scene(pts, cfg.plane_threshold, cfg.plane_iterations, cfg.radius_nb_points, cfg.radius,
                             device=pipe.device)
    labels = pp.dbscan(cleaned, cfg.eps, cfg.min_points) if len(cleaned) >= cfg.min_points else None
    if labels is None or labels.max() < 0:
        return None, None, None
    key = pipe._scene_call(cleaned, labels)[0]
    return eager_scene(pipe, cleaned, labels), key, key[:4] + (pp._round_up(len(cleaned), 2048),) + key[5:]


def camera_run(pipe, frames, label: str) -> dict:
    """``frames`` of one camera through ``pipe`` one ``__call__`` at a time:
    each held against the eager run on the card (None where that finds no
    cluster) with its launches its program's per run times its runs; the
    host latency of each call, captures included, and the captures."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps

    ms, captured, keys, jax_keys, lost, gaps = [], [], set(), set(), 0, []
    for i, frame in enumerate(frames):
        c0, f0, b0 = pipe.programs.captures, fps.launches, ball_query_multi.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, runs = runs_of(pipe.programs, lambda: pipe(frame))
        ms.append(1e3 * (time.perf_counter() - t0))
        got = (fps.launches - f0, ball_query_multi.launches - b0)
        if pipe.programs.captures > c0:
            captured.append(i)
        with uncounted():
            want, key, jax_key = eager_frame(pipe, frame)
        check((out is None) == (want is None), f"camera {label} frame {i}: served {out is not None}, "
                                               f"the eager run {want is not None}")
        if out is None:
            lost += 1
            continue
        keys.add(key)
        jax_keys.add(jax_key)
        want_fps = 4 if out["clusters"].shape[1] > pipe.cfg.num_points else 3
        check(got == (want_fps * runs, 2 * runs),
              f"camera {label} frame {i}: fps/ball_query launches {got}, want ({want_fps}, 2) a run, {runs} runs")
        gaps.append(output_gap(out, want, f"camera {label} frame {i}"))
    steady = [t for i, t in enumerate(ms) if i not in captured]
    return {"frames": len(frames), "served": len(frames) - lost, "lost": lost,
            "captures": len(captured), "captures_per_frame": len(captured) / len(frames),
            "frames_that_captured": captured, "program_keys": len(keys), "jax_program_keys": len(jax_keys),
            "scene_points": pipe.scene_points, "eager_gap": max(gaps, default=0.0),
            "ms": {"median": float(np.median(ms)), "p90": float(np.percentile(ms, 90)), "max": max(ms),
                   "median_without_a_capture": float(np.median(steady)) if steady else None,
                   "captures": [ms[i] for i in captured]}}


STAGES = ("clip", "clean", "dbscan", "infer", "infer_eager")


def stage_ms(pipe, frame) -> np.ndarray:
    """Host ms of a frame's clip, clean, DBSCAN and inference on ``pipe``
    (the radius clean; the inference a replay of the scene program), each
    ended by a synchronize; then the inference's function run eagerly on
    the card, uncounted (STAGES)."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess as pp

    cfg = pipe.cfg
    t = [time.perf_counter()]
    p = pp.clip_distance(frame, cfg.clip_range, cfg.clip_axis)
    t.append(time.perf_counter())
    c = pp.clean_scene(p, cfg.plane_threshold, cfg.plane_iterations, cfg.radius_nb_points, cfg.radius,
                       device=pipe.device)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    lab = pp.dbscan(c, cfg.eps, cfg.min_points)
    t.append(time.perf_counter())
    pipe._infer_scene(c, lab)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    with uncounted():
        eager_scene(pipe, c, lab)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    return np.diff(t) * 1e3


def frame_phase(device, kernels: list[dict]) -> dict:
    """The raw-frame path: ``cli infer`` on the replay scene on the card
    against ``--device cpu``; ``__call__`` and ``stream`` on the 28k and 300k
    synthetic frames (r3 checkpoints) against the CPU, the cleaned points
    equal bit for bit, with the launches, the latency by stage and the
    served frames/s of ``stream``."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch import cli
    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
    from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess as pp

    report = {"frames": {}}
    fps.launches = ball_query_multi.launches = 0
    paths = {k: os.path.join(ROOT, v) for k, v in CHECKPOINTS.items()}
    scene = os.path.join(ROOT, "tests", "fixtures", "scene_table2obj.ply")
    printed = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["infer", "--input", scene, "--config", json.dumps(FIXTURE_CFG),
                      "--checkpoints", json.dumps(paths)] + (["--device", "cpu"] if dev == "cpu" else []))
        printed[dev] = json.loads(buf.getvalue().strip().splitlines()[-1])
    card, cpu = printed["cuda"], printed["cpu"]
    check(set(card) == set(cpu) == {"input", "clusters", "pred_class", "rotation_deg", "translation", "width"},
          f"cli infer: fields {sorted(card)}")
    check(card["clusters"] == cpu["clusters"] == 2 and card["pred_class"] == cpu["pred_class"],
          f"cli infer: card {card['pred_class']} against the CPU {cpu['pred_class']}")
    for k in ("rotation_deg", "translation", "width"):
        check(np.allclose(card[k], cpu[k], rtol=TOL, atol=TOL), f"cli infer: {k} {card[k]} against {cpu[k]}")
    log(f"  cli infer on the replay scene: the card prints the CPU's classes {card['pred_class']}, floats "
        f"within {TOL}")
    report["cli_infer"] = card

    pipe = GraspPipeline.from_checkpoints(PipelineConfig(**FRAME_CFG), paths)       # default: cuda
    cpu_pipe = GraspPipeline.from_checkpoints(PipelineConfig(**FRAME_CFG), paths, device="cpu")
    cfg = pipe.cfg
    float_keys = ("log_probs", "rotation_deg", "rotation_matrix", "sign_prob", "translation", "width")
    for label, n_table in FRAMES:
        frames = [synthetic_frame(n_table, seed) for seed in range(FRAME_SEEDS)]
        rows, served = [], None
        for seed, frame in enumerate(frames):
            pts = pp.clip_distance(frame, cfg.clip_range, cfg.clip_axis)
            normal, _ = pp.best_plane(torch.from_numpy(pts[:, :3].copy()),
                                      pp.draw_ransac(len(pts), cfg.plane_iterations), cfg.plane_threshold)
            lost = not bool(normal.any())               # a degenerate triple won (ROADMAP.md Queue 3)
            f0, b0 = fps.launches, ball_query_multi.launches
            out, runs = runs_of(pipe.programs, lambda: pipe(frame))
            got = (fps.launches - f0, ball_query_multi.launches - b0)
            want = cpu_pipe(frame)
            if lost:
                check(out is None and want is None and got == (0, 0) and runs == 0,
                      f"frame {label} seed {seed}: the best plane is degenerate, yet the frame was served")
                rows.append({"seed": seed, "clipped": len(pts), "served": False})
                log(f"  frame {label} seed {seed}: lost, as the reference loses it, to a RANSAC triple that "
                    f"repeats a point (zero normal, every point an inlier)")
                continue
            check(out is not None and want is not None and out["clusters"].shape == want["clusters"].shape,
                  f"frame {label} seed {seed}: clusters {None if out is None else out['clusters'].shape} on the "
                  f"card, {None if want is None else want['clusters'].shape} on the CPU")
            want_fps = 4 if out["clusters"].shape[1] > cfg.num_points else 3
            check(got == (want_fps * runs, 2 * runs),
                  f"frame {label}: fps/ball_query launches {got}, want ({want_fps}, 2) a run, {runs} runs")
            check(np.array_equal(out["clusters"], want["clusters"]), f"frame {label}: clusters differ from the CPU")
            check(np.array_equal(out["pred_class"], want["pred_class"]), f"frame {label}: classes differ")
            for k in float_keys:
                check(np.allclose(out[k], want[k], rtol=TOL, atol=TOL), f"frame {label}: {k} differs from the CPU")
            args = (pts, cfg.plane_threshold, cfg.plane_iterations, cfg.radius_nb_points, cfg.radius)
            with uncounted():
                cleaned = pp.clean_scene(*args)
                labels = pp.dbscan(cleaned, cfg.eps, cfg.min_points)
                gap = output_gap(out, eager_scene(pipe, cleaned, labels), f"frame {label} seed {seed}")
            check(np.array_equal(cleaned, pp.clean_scene(*args, device="cpu")),
                  f"frame {label}: the cleaned points on the card are not the CPU's bit for bit")
            rows.append({"seed": seed, "clipped": len(pts), "served": True, "cleaned": len(cleaned),
                         "cluster_sizes": np.bincount(labels[labels >= 0]).tolist(),
                         "program": list(pipe._scene_call(cleaned, labels)[0]), "runs": runs, "eager_gap": gap,
                         "classes": out["pred_class"].tolist(), "fps_and_ball_query_launches": list(got)})
            log(f"  frame {label} seed {seed}: matches the CPU (classes {out['pred_class'].tolist()}, "
                f"cleaned points equal bit for bit) and the eager run on the card; {json.dumps(rows[-1])}")
            served = served or (frame, out)
        check(served is not None, f"frame {label}: no frame served")
        frame, out = served

        split = np.median(np.array([stage_ms(pipe, frame) for _ in range(5)]), axis=0)
        total = timed(lambda: pipe(frame), 5)
        for r, f in zip(pipe.stream(iter(frames)), frames):
            want = pipe(f)
            check((r is None) == (want is None) and (r is None or all(np.array_equal(r[k], want[k]) for k in want)),
                  f"frame {label}: stream differs from __call__")
        programs = programs_line(f"frame {label}", pipe.programs)

        # a camera on the first served scene, from a fresh pipeline: every frame distinct
        scene_seed = next(r["seed"] for r in rows if r["served"])
        cam = GraspPipeline.from_checkpoints(PipelineConfig(**FRAME_CFG), paths)
        camera = camera_run(cam, camera_frames(n_table, scene_seed, 0, CAMERA_FRAMES), label)
        camera["scene_seed"] = scene_seed
        log(f"  camera {label}, scene seed {scene_seed}, {CAMERA_FRAMES} distinct frames from a fresh pipeline, "
            f"each held against the eager run on the card: {json.dumps(camera)}")
        window_s, n_served, n_frames, window_captures = [], 0, 0, []
        for w in (1, 2):                                    # two windows of new frames of the camera
            stream = camera_frames(n_table, scene_seed, w * CAMERA_FRAMES, CAMERA_FRAMES)
            c0 = cam.programs.captures
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_served += sum(r is not None for r in cam.stream(iter(stream)))
            torch.cuda.synchronize()
            window_s.append(time.perf_counter() - t0)
            window_captures.append(cam.programs.captures - c0)
            n_frames += len(stream)
        row = {"frames": rows, "raw_points": len(frame),
               "stage_ms": dict(zip(STAGES, split.tolist())), "call": total, "programs": programs,
               "camera": camera, "camera_programs": programs_line(f"camera {label}", cam.programs),
               "stream_captures": window_captures,
               "stream_ms_per_frame": [1e3 * w / CAMERA_FRAMES for w in window_s],
               "stream_served_frames_per_s": n_served / sum(window_s),
               "stream_frames": n_frames, "stream_served": n_served, "stream_lost": n_frames - n_served,
               "budget_ms": FRAME_BUDGET_MS}
        report["frames"][label] = row
        log(f"  frame {label}: latency and stream "
            f"{json.dumps({k: v for k, v in row.items() if k not in ('frames', 'camera')})}")
        del cam

    launches = {"fps": fps.launches, "ball_query": ball_query_multi.launches}
    check(launches["fps"] > 0 and launches["ball_query"] > 0, "the frame path launched no kernel")
    for k in kernels:
        k["launches_by_path"]["frame"] = launches.get(k["name"], 0)
    report["launches"] = launches
    return report


# (B, N, C, S) of the FPS calls above what the kernel's shared path holds: the
# global path's shapes until the cluster path took them over
FPS_GLOBAL_SHAPES = ((2, 57_857, 3, 256), (1, 300_000, 3, 512), (2, 70_000, 10, 128))
# points above the cluster path's limit (kernels/fps.py MAX_CLUSTER_POINTS),
# which stay on the global path: B and S of that call
FPS_ABOVE_CLUSTER = (1, 32)
NEAR_CUBE_POINTS = 70_000
# the near frame served with the plane removal alone, so that the CPU's
# side of the comparison does not count all 5e9 pairs of its radius test
NEAR_CFG = dict(FRAME_CFG, outlier_method="none")
MODELNET_SHAPES, MODELNET_PER_SHAPE, MODELNET_ROWS = ("bed", "night_stand"), 16, 10_000
LAYOUT_PER_CLASS = 8


def all_finite(row: dict) -> bool:
    """Every figure of a history or sweep row is finite (lists included)."""
    return all(np.isfinite(np.asarray(v, dtype=np.float64)).all() for v in row.values())


def near_object_frame(seed: int) -> np.ndarray:
    """A 640x480 frame's worst case for FPS: a table of 20,000 points at
    z = -0.7 (as in ``synthetic_frame``), the six faces of a cube of side
    0.15 m at z = -0.5 sampled with NEAR_CUBE_POINTS points (an object near
    the camera, above what the FPS kernel's shared path holds), a blob of
    1,500 points (the small cluster that sets the truncation's size) and 60
    far outliers."""
    rng = np.random.default_rng(seed)
    n = 20000
    table = np.column_stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                             -0.7 + rng.normal(0, 0.0015, n)])
    face = rng.integers(0, 6, NEAR_CUBE_POINTS)
    cube = rng.uniform(-0.075, 0.075, (NEAR_CUBE_POINTS, 3))
    cube[np.arange(NEAR_CUBE_POINTS), face // 2] = np.where(face % 2, 0.075, -0.075)
    cube += [0.2, 0.2, -0.5]
    blob = rng.normal(0, 0.01, (1500, 3)) + [-0.2, -0.2, -0.6]
    far = rng.uniform(-1, 1, (60, 3)) + [0, 0, -1.5]
    return np.concatenate([table, cube, blob, far]).astype(np.float32)


def modelnet_tree(root: str) -> None:
    """The JAX package's ModelNet test tree (tests/test_modelnet.py), at the
    reference's cloud size: MODELNET_PER_SHAPE clouds a shape of
    MODELNET_ROWS rows (x, y, z, nx, ny, nz), three quarters of them in the
    train split; each shape's clouds have a scale of their own."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(0)
    with open(os.path.join(root, "modelnet10_shape_names.txt"), "w") as f:
        f.write("\n".join(MODELNET_SHAPES) + "\n")
    ids = {"train": [], "test": []}
    for k, shape in enumerate(MODELNET_SHAPES):
        os.makedirs(os.path.join(root, shape))
        for i in range(1, MODELNET_PER_SHAPE + 1):
            sid = f"{shape}_{i:04d}"
            xyz = rng.standard_normal((MODELNET_ROWS, 3)) * (1.0 + k, 1.0, 0.5)
            normals = rng.standard_normal((MODELNET_ROWS, 3))
            normals /= np.linalg.norm(normals, axis=1, keepdims=True)
            np.savetxt(os.path.join(root, shape, f"{sid}.txt"), np.concatenate([xyz, normals], 1),
                       fmt="%.6f", delimiter=",")
            ids["train" if i <= 3 * MODELNET_PER_SHAPE // 4 else "test"].append(sid)
    for split, names in ids.items():
        with open(os.path.join(root, f"modelnet10_{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")


def plain_reference_layout(root: str, split: str, num_points: int, rng) -> dict:
    """``load_reference_layout`` spelled with ``np.loadtxt``, one sample at a
    time (``load_reference_sample``): the split, the draws and the sign
    convention, for the comparison with the native bulk reader."""
    from pointnet_like_pose_estimation_tpu_torch.data.dataset import _split_count
    from pointnet_like_pose_estimation_tpu_torch.data.generators import CATEGORIES
    from pointnet_like_pose_estimation_tpu_torch.data.io_utils import load_reference_sample

    out = {"points": [], "labels": [], "rot": [], "tran": []}
    for label, cat in enumerate(CATEGORIES):
        count = len([n for n in os.listdir(os.path.join(root, cat)) if not n.endswith(("_rot.txt", "_tran.txt"))])
        n_train = _split_count(count)
        for index in range(1, count + 1):
            if (index <= n_train) != (split == "train"):
                continue
            points, rot, tran = load_reference_sample(root, cat, index)
            out["points"].append(points.astype(np.float32)[rng.choice(len(points), num_points, replace=False)])
            out["labels"].append(label)
            out["rot"].append(rot.astype(np.float32))
            out["tran"].append(tran.astype(np.float32))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["labels"] = out["labels"].astype(np.int32)
    out["sign"] = np.sign(out["rot"][:, 2]).astype(np.float32)
    out["rot"][:, 2] = np.abs(out["rot"][:, 2])
    return out


def data_phase(device, pipe, kernels: list[dict]) -> dict:
    """What this slice added (ROADMAP items 6 and 11): the FPS kernel's
    cluster path against its plain version at FPS_GLOBAL_SHAPES and its
    global path one point above the cluster's limit, each with its time in
    a CUDA graph and its bound; then, with the launch counts set to 0, a frame with an
    object above the old FPS cap served on the card against the CPU; the
    ModelNet loader's uniform resampling on the card against the CPU and a
    training epoch on it; the reference's txt layout written, read back
    against a plain reader and trained on; ``cli sweep`` with its resume
    and its refusal; and a request timed by ``utils.profiling``."""
    import shutil

    import torch

    from pointnet_like_pose_estimation_tpu_torch import cli
    from pointnet_like_pose_estimation_tpu_torch.data import build_dataset, load_reference_layout
    from pointnet_like_pose_estimation_tpu_torch.data.generators import CATEGORIES
    from pointnet_like_pose_estimation_tpu_torch.data.io_utils import save_reference_layout
    from pointnet_like_pose_estimation_tpu_torch.data.modelnet import ModelNetDataset
    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import (
        MAX_CLUSTER_POINTS,
        MAX_SHARED_POINTS,
        fps,
        fps_plan,
        fps_reference,
    )
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
    from pointnet_like_pose_estimation_tpu_torch.pipeline import preprocess as pp
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, train
    from pointnet_like_pose_estimation_tpu_torch.utils import sustained_time

    t_phase = time.perf_counter()
    report = {}
    work = os.path.join(ROOT, "build", "chip_smoke_data")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # 1. the cluster path at FPS_GLOBAL_SHAPES and the global path above the cluster's limit, exact
    # against the plain version, and their times
    rng = np.random.default_rng(21)
    by_path, err = {"cluster": [], "global": []}, 0
    large = [(*shape, "cluster") for shape in FPS_GLOBAL_SHAPES]
    large.append((FPS_ABOVE_CLUSTER[0], MAX_CLUSTER_POINTS + 1, 3, FPS_ABOVE_CLUSTER[1], "global"))
    for B, N, C, S, name in large:
        pts = torch.from_numpy(np.concatenate(
            [unit_clouds(rng, B, N), rng.standard_normal((B, N, C - 3)).astype(np.float32)], -1)).to(device)
        plan = fps_plan(N, C, B)
        check(fps_path(N, C, B) == name, f"fps plan {plan} for B={B} N={N}: not the {name} path")
        got = fps(pts, S)
        torch.cuda.synchronize()
        want = fps_reference(pts, S)
        diff = int((got.long() - want.long()).abs().max())
        err = max(err, diff)
        check(diff == 0, f"fps {name} path B={B} N={N} C={C} S={S}: differs from the plain version (max {diff})")
        bound, by = fps_bound_ms(B, N, C, S)
        ms = cuda_graph_ms(lambda: fps(pts, S), 3)
        by_path[name].append({"call": f"{name} path B={B} N={N} C={C} S={S}", "shape": [B, N, C, S],
                              "plan": list(plan), "path": name, "ms": ms,
                              "plain_ms": cuda_ms(lambda: fps_reference(pts, S), 1), "bound_ms": bound,
                              "bound_by": by, "us_per_step": 1e3 * ms / S})
        log(f"  fps {name} path B={B} N={N} C={C} S={S}, plan {plan}: exact; kernel {ms:.4f} ms "
            f"({1e3 * ms / S:.3f} us/step), plain {by_path[name][-1]['plain_ms']:.4f} ms, "
            f"bound {bound:.6f} ms ({by})")
        del pts
    entry = next(k for k in kernels if k["name"] == "fps")
    entry["cluster_path_shapes"] = by_path["cluster"]
    entry["global_path_shapes"] = by_path["global"]
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    report["fps_large"] = by_path

    fps.launches = ball_query_multi.launches = 0

    # 2. a frame with an object above the old cap: the card against the CPU
    paths = {k: os.path.join(ROOT, v) for k, v in CHECKPOINTS.items()}
    near = GraspPipeline.from_checkpoints(PipelineConfig(**NEAR_CFG), paths)             # default: cuda
    near_cpu = GraspPipeline.from_checkpoints(PipelineConfig(**NEAR_CFG), paths, device="cpu")
    cfg = near.cfg
    float_keys = ("log_probs", "rotation_deg", "rotation_matrix", "sign_prob", "translation", "width")
    served = None
    for seed in range(4):
        frame = near_object_frame(seed)
        pts = pp.clip_distance(frame, cfg.clip_range, cfg.clip_axis)
        normal, _ = pp.best_plane(torch.from_numpy(pts[:, :3].copy()),
                                  pp.draw_ransac(len(pts), cfg.plane_iterations), cfg.plane_threshold)
        t0 = time.perf_counter()
        out = near(frame)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = near_cpu(frame)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        if not normal.any():                    # the reference's RANSAC fault (ROADMAP.md Queue 3)
            check(out is None and want is None, f"near frame seed {seed}: a degenerate best plane, yet served")
            log(f"  near frame seed {seed}: lost to a RANSAC triple that repeats a point, as in the reference")
            continue
        check(out is not None and want is not None, f"near frame seed {seed}: not served")
        labels = pp.dbscan(pp.remove_plane(pts, distance_threshold=cfg.plane_threshold,
                                           num_iterations=cfg.plane_iterations), cfg.eps, cfg.min_points)
        sizes = np.bincount(labels[labels >= 0]).tolist()
        check(len(sizes) == 2 and max(sizes) > MAX_SHARED_POINTS,
              f"near frame seed {seed}: cluster sizes {sizes}, want two, one above {MAX_SHARED_POINTS}")
        check(out["clusters"].shape == want["clusters"].shape == (2, min(sizes), 3),
              f"near frame: clusters {out['clusters'].shape} on the card, {want['clusters'].shape} on the CPU")
        check(np.array_equal(out["clusters"], want["clusters"]), "near frame: clusters differ from the CPU")
        with uncounted():
            output_gap({k: v for k, v in out.items() if k != "clusters"}, eager_request(near, out["clusters"]),
                       "near frame, plane only")
        check(np.array_equal(out["pred_class"], want["pred_class"]), "near frame: classes differ from the CPU")
        for k in float_keys:
            check(np.allclose(out[k], want[k], rtol=TOL, atol=TOL), f"near frame: {k} differs from the CPU")
        served = (seed, frame, sizes, out, card_ms, cpu_ms)
        break
    check(served is not None, "near frame: no seed served")
    seed, frame, sizes, out, card_ms, cpu_ms = served
    truncation = pp._TRUNCATION_PROGRAMS[torch.device("cuda")]
    check(any(key[2] > MAX_SHARED_POINTS for key in truncation.keys()),
          f"near frame, plane only: no truncation program over the cube ({truncation.keys()})")
    warm = timed(lambda: near(frame), 3)
    full = GraspPipeline.from_checkpoints(PipelineConfig(**FRAME_CFG), paths)            # the radius clean
    got = full(frame)
    torch.cuda.synchronize()
    check(got is not None and got["clusters"].shape[0] == 2, "near frame, radius clean: not served with 2 clusters")
    with uncounted():
        fc = full.cfg
        cleaned = pp.clean_scene(pp.clip_distance(frame, fc.clip_range, fc.clip_axis), fc.plane_threshold,
                                 fc.plane_iterations, fc.radius_nb_points, fc.radius)
        labels = pp.dbscan(cleaned, fc.eps, fc.min_points)
        gap = output_gap(got, eager_scene(full, cleaned, labels), "near frame, radius clean")
    key = full._scene_call(cleaned, labels)[0]
    want_fps = 4 if key[-1] == "fps" else 3          # truncation, resampling (fps branch), SA1, SA2
    check(full.programs.counts(key)["fps"] == want_fps and fps_path(key[2], 3, key[1]) == "cluster",
          f"near frame, radius clean: the scene program {key} records {full.programs.counts(key)}, "
          f"its truncation FPS the {fps_path(key[2], 3, key[1])} path")
    split = np.median(np.array([stage_ms(full, frame) for _ in range(3)]), axis=0)
    report["near_frame"] = {
        "seed": seed, "raw_points": len(frame), "cluster_sizes": sizes, "classes": out["pred_class"].tolist(),
        "first_call_ms_plane_only": card_ms, "cpu_first_call_ms_plane_only": cpu_ms,
        "call_ms_plane_only": warm,
        "radius_clean_classes": got["pred_class"].tolist(), "radius_clean_program": list(key),
        "radius_clean_eager_gap": gap, "stage_ms": dict(zip(STAGES, split.tolist())),
        "programs": programs_line("near frame, radius clean", full.programs),
        "truncation_programs": programs_line("truncation (cluster_point)", truncation)}
    log(f"  near frame seed {seed}: clusters of {sizes} points kept; card equals the CPU (classes "
        f"{out['pred_class'].tolist()}, floats within {TOL}); {json.dumps(report['near_frame'])}")

    # 3. ModelNet: uniform resampling of 10,000-point clouds with normals, on the card and the CPU
    root = os.path.join(work, "modelnet")
    t0 = time.perf_counter()
    modelnet_tree(root)
    written_s = time.perf_counter() - t0
    loaded = {}
    for split in ("train", "test"):
        f0 = fps.launches
        t0 = time.perf_counter()
        card = ModelNetDataset(root, 10, split, uniform=True, use_normals=True, cache=False)  # default: cuda
        card_s = time.perf_counter() - t0
        launched = fps.launches - f0
        cpu = ModelNetDataset(root, 10, split, uniform=True, use_normals=True, cache=False, device="cpu")
        m = len(card)
        check(card.points.shape == (m, 1024, 6) and launched == -(-m // 64),
              f"ModelNet {split}: points {card.points.shape}, {launched} FPS launches")
        check(np.array_equal(card.points, cpu.points) and np.array_equal(card.labels, cpu.labels),
              f"ModelNet {split}: the card's points are not the CPU's bit for bit")
        loaded[split] = card
        log(f"  ModelNet {split}: {m} clouds of {MODELNET_ROWS} rows resampled to 1024 with normals, "
            f"equal on the card and the CPU bit for bit ({launched} FPS launch, {card_s:.2f} s on the card)")
    cfg_mn = TrainConfig.for_model("pointnet2_cls_ssg", num_classes=10, epochs=1, batch_size=8,
                                   log_dir=os.path.join(work, "log"), experiment="modelnet")
    _, history = train(cfg_mn, loaded["train"].as_pose_dataset(), loaded["test"].as_pose_dataset())
    check(len(history) == 1 and all_finite(history[0]), f"ModelNet training: history {history}")
    report["modelnet"] = {"tree_written_s": written_s, "train_clouds": len(loaded["train"]),
                          "test_clouds": len(loaded["test"]), "epoch": history[0]}
    log(f"  ModelNet: one epoch of pointnet2_cls_ssg {json.dumps(history[0])}")

    # 4. the reference's txt layout: written from a dataset built on the card, read back, trained on
    fields = build_dataset(LAYOUT_PER_CLASS, seed=3)                                      # default: cuda
    root = os.path.join(work, "layout")
    for i in range(len(fields["labels"])):
        save_reference_layout(root, CATEGORIES[fields["labels"][i]], i % LAYOUT_PER_CLASS + 1,
                              fields["points"][i], fields["rot"][i], fields["tran"][i])
    layout = {}
    for split in ("train", "test"):
        ds = load_reference_layout(root, split, rng=np.random.default_rng(0))
        plain = plain_reference_layout(root, split, 1024, np.random.default_rng(0))
        for key, want_v in plain.items():
            got_v = getattr(ds, key)
            check(got_v.dtype == want_v.dtype and np.array_equal(got_v, want_v),
                  f"load_reference_layout {split}: {key} differs from the plain reader")
        layout[split] = ds
    cfg_rot = TrainConfig.for_model("rotation", epochs=1, log_dir=os.path.join(work, "log"), experiment="layout")
    _, history = train(cfg_rot, layout["train"], layout["test"])
    check(len(history) == 1 and all_finite(history[0]), f"layout training: {history}")
    report["reference_layout"] = {"train": len(layout["train"]), "test": len(layout["test"]), "epoch": history[0]}
    log(f"  reference layout: {len(layout['train'])} + {len(layout['test'])} clouds read back equal to the "
        f"plain reader; one epoch of rotation {json.dumps(history[0])}")

    # 5. the sweep: 14 jobs of one epoch, a resume that trains nothing, a refusal
    data_path = os.path.join(work, "layout.npz")
    np.savez(data_path, **fields)
    sweep_dir = os.path.join(work, "sweep")
    args = ["sweep", "--data", data_path, "--epochs", "1", "--log-dir", sweep_dir]
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(args)                                                                   # default: cuda
    sweep_s = time.perf_counter() - t0
    results_path = os.path.join(sweep_dir, "sweep_results.json")
    with open(results_path) as f:
        rows = json.load(f)
    settings = rows.pop("_settings")
    check(settings == {"epochs": 1, "data": data_path} and len(rows) == 14
          and len(printed.getvalue().strip().splitlines()) == 14, f"sweep: {len(rows)} rows, settings {settings}")
    check(all(all_finite(row) for row in rows.values()), "sweep: a non-finite figure")
    mtime = os.path.getmtime(results_path)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(args)
    check(printed.getvalue().strip() == "" and os.path.getmtime(results_path) == mtime,
          "sweep resume: the second call trained")
    try:
        cli.main(args[:4] + ["2"] + args[5:])
        refused = None
    except SystemExit as e:
        refused = str(e)
    check(refused is not None and "was produced with settings" in refused,
          f"sweep with another --epochs: not refused ({refused})")
    report["sweep"] = {"seconds": sweep_s, "rows": rows}
    log(f"  sweep: 14 jobs of one epoch in {sweep_s:.1f} s, every figure finite; a second call trained "
        f"nothing; --epochs 2 refused")

    launches = {"fps": fps.launches, "ball_query": ball_query_multi.launches}
    check(launches["fps"] > 0 and launches["ball_query"] > 0, "the data path launched no kernel")
    for k in kernels:
        k["launches_by_path"]["data"] = launches.get(k["name"], 0)
    report["launches"] = launches

    # 6. utils.profiling on a request of 4 clusters, beside the smoke's own loop
    clusters = blobs(np.random.default_rng(4), 4, 2048)
    sustained_ms = 1e3 * sustained_time(pipe.infer_clusters, clusters, min_seconds=1.0)
    loop = timed(lambda: pipe.infer_clusters(clusters), 10)
    report["request_k4"] = {"sustained_time_ms": sustained_ms, "smoke_loop": loop}
    log(f"  request K=4 M=2048: sustained_time {sustained_ms:.3f} ms a request; the smoke's loop "
        f"{json.dumps(loop)}")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  data phase: {report['seconds']:.1f} s")
    return report


PARALLEL_WORK = os.path.join(ROOT, "build", "chip_smoke_parallel")
R3_CLASSIFIER = "classification/r3_pointnet2_cls_ssg"
# sharded FPS against the FPS kernel (its cluster path): B, N, S
SHARDED_FPS = (1, 300_000, 512)
# the DP step against the single-process step: a train step on the card's
# float32 arithmetic, summed over the rows in another order (each rank's
# rows, then the all-reduce)
PARALLEL_TRAIN_TOL = TRAIN_TOL
# the TP step against the single step: JAX's test_tp_step_matches_single_device_step
TP_LOSS_RTOL, TP_STATS_RTOL, TP_STATS_ATOL = 1e-4, 1e-3, 1e-5
# the point-sharded forward against the unsharded one: the same selection,
# the same MLP; log-probabilities within
SHARDED_FORWARD_TOL = 1e-4


def parallel_rank(rank, world, backend, task, work):
    """One spawned rank of the parallel phase: joins a ``backend`` group of
    ``world`` ranks through a FileStore under ``work``, runs
    PARALLEL_TASKS[task] on the one card and writes its report; any failure
    raises, and the phase fails on a rank's exit code."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    os.environ["LOCAL_RANK"] = "0"                  # every rank on the one card
    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(work, f"store-{task}"), world),
                            rank=rank, world_size=world)
    try:
        report = PARALLEL_TASKS[task](rank, world, torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"{task}-rank{rank}.json"), "w") as f:
        json.dump(report, f)


def spawn_ranks(task: str, world: int, backend: str, timeout: float = 600.0) -> list[dict]:
    """Run ``task`` on ``world`` spawned ranks; every rank's exit code and
    report are checked."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(parallel_rank, args=(world, backend, task, PARALLEL_WORK), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise SmokeFailure(f"parallel {task}: ranks still running after {timeout} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise SmokeFailure(f"parallel {task}: a rank failed:\n{e}") from e
    reports = []
    for r in range(world):
        with open(os.path.join(PARALLEL_WORK, f"{task}-rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def step_inputs(device, name, experiment, seed):
    """The smoke's train batch (24 clouds of every class of the generated
    dataset), the committed model on the CPU, and draws made once on the CPU,
    moved to ``device``."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.data import PoseDataset, load_dataset
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, draw_step, load_checkpoint
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _device_data

    ds = load_dataset(os.path.join(ROOT, "build", "chip_smoke_dataset.npz"), "train")
    pick = np.linspace(0, len(ds) - 1, TRAIN_BATCH).astype(int)
    cpu_batch = _device_data(PoseDataset(**{k: getattr(ds, k)[pick] for k in
                                            ("points", "labels", "rot", "tran", "sign", "width")}), "cpu")
    cfg = TrainConfig.for_model(name, batch_size=TRAIN_BATCH)
    model, _ = load_checkpoint(os.path.join(ROOT, "log", experiment, "checkpoints", "best.msgpack"),
                               build_model(name))
    draws = draw_step(cfg, model, cpu_batch, torch.Generator().manual_seed(seed))
    return (cfg, model, {k: v.to(device) for k, v in cpu_batch.items()},
            {part: {k: v.to(device) for k, v in d.items()} for part, d in draws.items()})


def hold_step(what, name, got_model, want_model, got_out, want_out) -> dict:
    """A parallel step against the single-process step on the card, by the
    train phase's rule: loss, metric and BatchNorm statistics within
    TRAIN_TOL, every gradient within TRAIN_TOL element by element (absolute
    times the model's largest gradient element) or, for TIED_GRADIENTS, by
    relative L2."""
    import torch

    def gap(a, b):
        return float((a.detach().double() - b.detach().double()).abs().max())

    for key in ("loss", "metric"):
        check(torch.allclose(got_out[key].double(), want_out[key].double(), rtol=PARALLEL_TRAIN_TOL,
                             atol=PARALLEL_TRAIN_TOL), f"{what}: {key} {float(got_out[key])} against "
              f"{float(want_out[key])}")
    tied, bound = TIED_GRADIENTS.get(name, ((), 0.0))
    want_params = dict(want_model.named_parameters())
    scale = max(1.0, max(float(p.grad.abs().max()) for p in want_params.values()))
    worst = {"gradient": 0.0, "statistic": 0.0}
    for k, p in got_model.named_parameters():
        g, w = p.grad, want_params[k].grad
        worst["gradient"] = max(worst["gradient"], gap(g, w))
        if torch.allclose(g, w, rtol=PARALLEL_TRAIN_TOL, atol=PARALLEL_TRAIN_TOL * scale):
            continue
        rel = float((g - w).norm() / w.norm())
        check(k.startswith(tied) and rel <= bound, f"{what}: gradient {k} differs by {gap(g, w)} (relative "
              f"L2 {rel})")
    want_state = want_model.state_dict()
    for k, v in got_model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            worst["statistic"] = max(worst["statistic"], gap(v, want_state[k]))
            check(torch.allclose(v, want_state[k], rtol=PARALLEL_TRAIN_TOL, atol=PARALLEL_TRAIN_TOL),
                  f"{what}: statistic {k} differs by {gap(v, want_state[k])}")
    return {"loss": float(got_out["loss"]), "max_abs_diff": worst, "gradient_scale": scale}


def dp_step_check(device, mesh, what) -> dict:
    """One DP train step of pointnet2_cls_ssg on this rank's rows against
    the single-process step on the card on the same draws, with the launch
    counts set to 0 just before the DP step and read just after, and the
    step's collective traffic."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch import parallel as P
    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
    from pointnet_like_pose_estimation_tpu_torch.models import get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.train import make_optimizer, make_train_step
    from pointnet_like_pose_estimation_tpu_torch.utils.collectives import (
        collective_traffic,
        reset_collective_traffic,
    )

    name = "pointnet2_cls_ssg"
    cfg, model, batch, draws = step_inputs(device, name, R3_CLASSIFIER, 31)
    spec = get_model_spec(name)
    single = copy.deepcopy(model).to(device)
    want = make_train_step(spec, cfg)(single, make_optimizer(cfg, single.parameters())[0], batch, draws=draws)
    dp = P.replicate(copy.deepcopy(model).to(device), mesh)
    rows = P.batch_sharding(mesh, len(batch["points"]))
    local = {part: None if d is None else {k: v[rows] for k, v in d.items()} for part, d in draws.items()}
    step = P.make_parallel_train_step(spec, cfg, mesh)
    opt = make_optimizer(cfg, dp.parameters())[0]
    torch.cuda.synchronize()
    reset_collective_traffic()
    fps.launches = ball_query_multi.launches = 0
    got = step(dp, opt, {k: v[rows] for k, v in batch.items()}, draws=local)
    torch.cuda.synchronize()
    launches = {"fps": fps.launches, "ball_query": ball_query_multi.launches}
    check(launches == {"fps": 2, "ball_query": 2}, f"{what}: launches {launches}, want 2 of each a step")
    report = hold_step(what, name, dp, single, got, want)
    report.update(launches=launches, rows=[rows.start, rows.stop], traffic=collective_traffic())
    return report


def nccl_world_one(rank, world, device) -> dict:
    """World size 1 on NCCL: the DP step against the single step, then
    training clouds/s of the DP step and of the single step at B = 24 and
    256, in turns."""
    from pointnet_like_pose_estimation_tpu_torch import parallel as P
    from pointnet_like_pose_estimation_tpu_torch.data import load_dataset
    from pointnet_like_pose_estimation_tpu_torch.train import make_train_step
    from pointnet_like_pose_estimation_tpu_torch.train.loop import _device_data

    mesh = P.make_mesh()                                                     # default: cuda
    report = {"step": dp_step_check(device, mesh, "DP step, NCCL world 1"), "throughput": {}}
    data = _device_data(load_dataset(os.path.join(ROOT, "build", "chip_smoke_dataset.npz"), "train"), device)
    for B in (24, 256):
        for kind, make in (("single", make_train_step),
                           ("dp", lambda spec, cfg: P.make_parallel_train_step(spec, cfg, mesh))):
            report["throughput"][f"{kind} B={B}"] = train_throughput(device, "pointnet2_cls_ssg", B, data,
                                                                     make_step=make, span_ms=1000.0)
    return report


def gloo_world_two(rank, world, device) -> dict:
    """Two ranks on gloo sharing the card: the DP step against the single
    step; sharded FPS, grouping and a point-sharded forward against the
    kernels; a TP step of rotation against the single step."""
    import torch
    import torch.distributed as dist

    from pointnet_like_pose_estimation_tpu_torch import parallel as P
    from pointnet_like_pose_estimation_tpu_torch.kernels.ball_group import ball_query_multi
    from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
    from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
    from pointnet_like_pose_estimation_tpu_torch.ops import index_points, normalize_cloud
    from pointnet_like_pose_estimation_tpu_torch.train import load_checkpoint, make_optimizer, make_train_step

    report = {"step": dp_step_check(device, P.make_mesh(), "DP step, gloo world 2")}
    mesh = P.make_mesh({"points": world})

    # sharded FPS at 300,000 points against the FPS kernel (its cluster path)
    B, N, S = SHARDED_FPS
    pts = torch.from_numpy(unit_clouds(np.random.default_rng(21), B, N)).to(device)
    want = fps(pts, S)
    times = []
    for _ in range(2):                                   # the second call is timed
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = P.sharded_farthest_point_sample(pts, S, mesh)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(torch.equal(got, want), "sharded FPS at 300,000 points differs from the FPS kernel")
    kernel_ms = cuda_ms(lambda: fps(pts, S), 3) if rank == 0 else None
    dist.barrier()
    report["sharded_fps"] = {"shape": [B, N, S], "ms_per_step": 1e3 * times[-1] / S, "first_call_s": times[0],
                             "kernel_us_per_step": None if kernel_ms is None else 1e3 * kernel_ms / S}

    # the groupings at SSG SA1 and MSG SA1 against the kernels
    pts = torch.from_numpy(unit_clouds(np.random.default_rng(22), TRAIN_BATCH, 1024)).to(device)
    cent = index_points(pts, fps(pts, 512))
    for what, radii, ks in (("SSG SA1", *SSG_SA1), ("MSG SA1", *MSG_SA1)):
        idx_all = ball_query_multi(pts, cent, radii, ks)
        if len(ks) == 1:
            got_c, grouped = P.sharded_sample_and_group(pts, None, 512, ks[0], radii[0], mesh)
            grouped = [grouped]
        else:
            got_c, grouped = P.sharded_sample_and_group_multi(pts, None, 512, radii, ks, mesh)
        check(torch.equal(got_c, cent), f"sharded grouping {what}: centroids differ from the kernels'")
        lo = 0
        for g, K in zip(grouped, ks):
            want_g = index_points(pts, idx_all[..., lo:lo + K]) - cent[:, :, None, :]
            lo += K
            check(torch.equal(g, want_g), f"sharded grouping {what} K={K}: neighbourhoods differ from the kernels'")
    report["sharded_grouping"] = "SSG SA1 and MSG SA1 at 24 x 1024 -> 512 equal to the kernels' outputs"

    # a point-sharded forward of the r3 classifier
    model, _ = load_checkpoint(os.path.join(ROOT, "log", R3_CLASSIFIER, "checkpoints", "best.msgpack"),
                               build_model("pointnet2_cls_ssg"))
    model = model.to(device).eval()
    x = normalize_cloud(pts)
    with torch.no_grad():
        want = model(x)[0]
        with P.point_sharding(mesh) as ctx:
            got = model(x)[0]
    check(ctx.dispatch_count == 2, f"point-sharded forward: {ctx.dispatch_count} dispatches, want 2")
    check(torch.equal(got.argmax(-1), want.argmax(-1)), "point-sharded forward: classes differ")
    err = float((got - want).abs().max())
    check(err <= SHARDED_FORWARD_TOL, f"point-sharded forward: log-probs {err} from the unsharded forward")
    report["sharded_forward"] = {"max_abs_diff": err, "dispatch_count": ctx.dispatch_count}

    # one TP step of rotation against the single step
    mesh = P.make_mesh({"data": 1, "model": world})
    cfg, model, batch, draws = step_inputs(device, "rotation", "pose/r3_rotation", 32)
    spec = get_model_spec("rotation")
    single = copy.deepcopy(model).to(device)
    want = make_train_step(spec, cfg)(single, make_optimizer(cfg, single.parameters())[0], batch, draws=draws)
    tp = copy.deepcopy(model).to(device)
    index = P.tensor_parallel_shardings(tp, mesh)
    sharded, total = P.count_sharded(tp, mesh)
    P.shard_state_tp(tp, mesh)
    step = P.make_parallel_train_step(spec, cfg, mesh, tp_axis="model", model=tp)
    got = step(tp, make_optimizer(cfg, tp.parameters())[0], batch, draws=draws)
    torch.cuda.synchronize()
    check(abs(float(got["loss"]) - float(want["loss"])) <= TP_LOSS_RTOL * abs(float(want["loss"])),
          f"TP step: loss {float(got['loss'])} against {float(want['loss'])}")
    worst = 0.0
    want_state = single.state_dict()
    for k, v in tp.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            w = want_state[k][index[k]]
            worst = max(worst, float((v - w).abs().max()))
            check(torch.allclose(v, w, rtol=TP_STATS_RTOL, atol=TP_STATS_ATOL), f"TP step: statistic {k}")
    report["tp_step"] = {"loss": float(got["loss"]), "single_loss": float(want["loss"]), "stats_max_abs_diff": worst,
                         "sharded_params": sharded, "params": total}
    return report


PARALLEL_TASKS = {"nccl_world_one": nccl_world_one, "gloo_world_two": gloo_world_two}


def parallel_phase(device, pipe, training: dict, kernels: list[dict]) -> dict:
    """The parallel layer (ROADMAP item 10); see the module docstring."""
    import shutil

    import torch

    from pointnet_like_pose_estimation_tpu_torch import cli
    from pointnet_like_pose_estimation_tpu_torch.data import load_dataset
    from pointnet_like_pose_estimation_tpu_torch.models import build_model
    from pointnet_like_pose_estimation_tpu_torch.parallel import MultiHeadParallel
    from pointnet_like_pose_estimation_tpu_torch.train import TrainConfig, evaluate, load_checkpoint

    t_phase = time.perf_counter()
    shutil.rmtree(PARALLEL_WORK, ignore_errors=True)
    os.makedirs(PARALLEL_WORK)
    data_path = os.path.join(ROOT, "build", "chip_smoke_dataset.npz")       # the eval phase's
    report = {}

    # 1. world size 1 on NCCL, then two ranks on gloo sharing the card
    t0 = time.perf_counter()
    (nccl,) = spawn_ranks("nccl_world_one", 1, "nccl")
    report["nccl_world_one"] = {**nccl, "seconds": time.perf_counter() - t0, "train_phase_single_process": {
        B: training["throughput"][f"pointnet2_cls_ssg B={B}"]["clouds_per_s"] for B in (24, 256)}}
    log(f"  NCCL world 1: DP step equals the single step {json.dumps(nccl['step']['max_abs_diff'])}, "
        f"launches {nccl['step']['launches']}; clouds/s " + json.dumps(
            {k: round(v["clouds_per_s"], 1) for k, v in nccl["throughput"].items()}))
    t0 = time.perf_counter()
    gloo = spawn_ranks("gloo_world_two", 2, "gloo")
    report["gloo_world_two"] = {"ranks": gloo, "seconds": time.perf_counter() - t0}
    for r in gloo:
        log(f"  gloo world 2 rank rows {r['step']['rows']}: DP step equals the single step "
            f"{json.dumps(r['step']['max_abs_diff'])}, launches {r['step']['launches']}, traffic "
            f"{json.dumps(r['step']['traffic']['by_op'])}")
    log(f"  sharded FPS {gloo[0]['sharded_fps']}; {gloo[0]['sharded_grouping']}; point-sharded forward "
        f"{gloo[0]['sharded_forward']}; TP step {gloo[0]['tp_step']}")
    launches = {"fps": sum(r["step"]["launches"]["fps"] for r in [nccl, *gloo]),
                "ball_query": sum(r["step"]["launches"]["ball_query"] for r in [nccl, *gloo])}
    for k in kernels:
        k["launches_by_path"]["parallel"] = launches.get(k["name"], 0)
    report["launches"] = launches

    # 2. torchrun ... cli train --data-parallel: 2 epochs, resumed for a third, then cli eval of best.pt
    log_dir = os.path.join(PARALLEL_WORK, "train")
    args = ["--model", "pointnet2_cls_ssg", "--data", data_path, "--batch-size", str(TRAIN_BATCH),
            "--log-dir", log_dir, "--experiment", "smoke_dp"]
    t0 = time.perf_counter()
    for epochs in ("2", "3"):
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1", "-m",
             "pointnet_like_pose_estimation_tpu_torch.cli", "train", "--data-parallel", *args, "--epochs", epochs],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True, text=True, timeout=600)
        check(res.returncode == 0, f"torchrun train --data-parallel --epochs {epochs}: exit {res.returncode}\n"
              f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    seconds = time.perf_counter() - t0
    exp_dir = os.path.join(log_dir, "classification", "smoke_dp")
    with open(os.path.join(exp_dir, "history.json")) as f:
        history = json.load(f)
    check([r["epoch"] for r in history] == [0, 1, 2], f"torchrun train: history epochs {history}")
    losses = [r["train_loss"] for r in history]
    check(all(np.isfinite(losses)), f"torchrun train: non-finite loss {losses}")
    cfg = TrainConfig.for_model("pointnet2_cls_ssg", batch_size=TRAIN_BATCH, log_dir=log_dir, experiment="smoke_dp")
    model, meta = load_checkpoint(os.path.join(exp_dir, "checkpoints", "best.pt"), build_model("pointnet2_cls_ssg"))
    want = evaluate(cfg, model, load_dataset(data_path, "test"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["eval", *args])
    from_cli = json.loads(printed.getvalue().strip().splitlines()[-1])
    check(from_cli.pop("checkpoint_epoch") == meta["epoch"], "torchrun train: eval of best.pt, epoch")
    check(set(from_cli) == set(want) and all(np.allclose(from_cli[k], want[k], rtol=1e-6, atol=1e-6) for k in want),
          f"torchrun train: the eval command printed {from_cli}, evaluate gave {want}")
    report["torchrun_train"] = {"train_loss_by_epoch": losses, "best_epoch": meta["epoch"],
                                "seconds_for_two_calls": seconds, "seconds_per_epoch": [r["seconds"] for r in history],
                                "test_instance_acc": want["instance_acc"]}
    log(f"  torchrun --nproc-per-node 1 cli train --data-parallel: 2 epochs, resumed for a third, in "
        f"{seconds:.1f} s; train loss {losses}; eval of best.pt (epoch {meta['epoch']}) equals evaluate")

    # 3. the head fan-out on the r3 checkpoints against infer_clusters
    mhp = MultiHeadParallel(pipe.models)                                   # default: every visible card
    check(all(d.type == "cuda" for d in mhp.placement.values()), "MultiHeadParallel: not on the card")
    report["multihead"] = {"placement": {k: str(v) for k, v in mhp.placement.items()}}
    for K in (4, 32):
        clusters = blobs(np.random.default_rng(40 + K), K, pipe.cfg.num_points)
        got, want = mhp(clusters), pipe.infer_clusters(clusters)
        check(set(got) == set(want) and np.array_equal(got["pred_class"], want["pred_class"]),
              f"MultiHeadParallel K={K}: keys or classes differ from infer_clusters")
        err = max(float(np.abs(got[k] - want[k]).max()) for k in got)
        check(err <= TOL, f"MultiHeadParallel K={K}: {err} from infer_clusters")
        report["multihead"][f"K={K}"] = {"max_abs_diff": err, "fan_out": timed(lambda: mhp(clusters), 10),
                                         "infer_clusters": timed(lambda: pipe.infer_clusters(clusters), 10)}
        log(f"  MultiHeadParallel K={K}: equals infer_clusters ({err}); "
            f"{report['multihead'][f'K={K}']['fan_out']['median_ms']:.3f} ms against "
            f"{report['multihead'][f'K={K}']['infer_clusters']['median_ms']:.3f}")
    torch.cuda.synchronize()
    report["seconds"] = time.perf_counter() - t_phase
    log(f"  parallel phase: {report['seconds']:.1f} s")
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "pointnet_like_pose_estimation_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card} | torch: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from pointnet_like_pose_estimation_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(built)}")
    for b in built.values():
        for line in b.log.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"  {b.name}: {line.strip()}")

    from pointnet_like_pose_estimation_tpu_torch.models.fast_infer import (
        build_pn2_msg_infer,
        build_pn2_ssg_infer,
    )
    from pointnet_like_pose_estimation_tpu_torch.ops import normalize_cloud
    from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig

    log("kernel phase")
    kernels = kernel_phase(device)

    log("serving phase")
    paths = {k: os.path.join(ROOT, v) for k, v in CHECKPOINTS.items()}
    pipe = GraspPipeline.from_checkpoints(PipelineConfig(), paths)        # default: cuda
    check(pipe.device.type == "cuda", "the pipeline did not default to the card")
    cpu = GraspPipeline.from_checkpoints(PipelineConfig(), paths, device="cpu")
    serving = serving_phase(pipe, cpu, kernels)

    log("fused set-abstraction kernel phase")
    msg_cpu = seeded_model("pointnet2_cls_msg", 5)
    msg = copy.deepcopy(msg_cpu).to(device)
    # name -> (executor on the card, the same on the CPU, the unfused model on the card)
    executors = {
        "SSG": (build_pn2_ssg_infer(pipe.models["classifier"]),           # default: cuda
                build_pn2_ssg_infer(cpu.models["classifier"], device="cpu"), pipe.models["classifier"]),
        "MSG": (build_pn2_msg_infer(msg), build_pn2_msg_infer(msg_cpu, device="cpu"), msg),
    }
    xyz = normalize_cloud(resampled(pipe, blobs(np.random.default_rng(3), 32, 2048)))
    kernels.append(fused_sa_phase(device, executors, xyz))

    log("fast-infer phase")
    fast_infer = fast_infer_phase(pipe, executors, kernels)

    log("eval phase")
    evals = eval_phase(device, kernels)

    log("train phase")
    training = train_phase(device, kernels)

    log("bf16 phase")
    bf16 = bf16_phase(device, kernels)

    log("frame phase")
    frames = frame_phase(device, kernels)

    log("data phase")
    data = data_phase(device, pipe, kernels)

    log("parallel phase")
    parallel = parallel_phase(device, pipe, training, kernels)

    check(not STEP_FAILURES, "train steps: " + " | ".join(STEP_FAILURES))
    log(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    log(card)
    print(json.dumps({"kernels": kernels, "serving": serving, "fast_infer": fast_infer, "eval": evals, "train": training,
                      "bf16": bf16, "frame": frames, "data": data, "parallel": parallel, "card": card}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
