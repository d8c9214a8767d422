"""Point Transformer in the port on the CPU: the kNN query's plain version
against a brute force and its launch plan, the one-pass attention's plain
version against the composed layer, its launch plan and the reasons that
keep the composed route, the classifier and the grasp
request with it against the benchmark's plain reference
(``bench_port/reference/point_transformer.py``) on seeded random weights,
its grouped bytes, the yardstick's FLOP count against
``torch.utils.flop_counter``, and the cell's benchmark files found by name
and importing no JAX. The kernels themselves run in
``tests/test_torch_cuda.py``."""

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pointnet_like_pose_estimation_tpu_torch.kernels import pt_attention as attention_kernel
from pointnet_like_pose_estimation_tpu_torch.kernels.knn import MAX_K, MAX_POINTS, knn, knn_plan
from pointnet_like_pose_estimation_tpu_torch.kernels.pt_attention import pt_attention, pt_attention_plan
from pointnet_like_pose_estimation_tpu_torch.models import build_model, get_model_spec
from pointnet_like_pose_estimation_tpu_torch.nn import point_transformer as pt_layers
from pointnet_like_pose_estimation_tpu_torch.nn.layers import set_compute_dtype
from pointnet_like_pose_estimation_tpu_torch.nn.point_transformer import (
    PointTransformerBlock,
    PointTransformerLayer,
    attention_reason,
)
from pointnet_like_pose_estimation_tpu_torch.ops.grouping import count_grouped, knn_group, query_knn
from pointnet_like_pose_estimation_tpu_torch.pipeline import GraspPipeline, PipelineConfig
from pointnet_like_pose_estimation_tpu_torch.pipeline.infer import MODEL_KEYS

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench_port"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import bounds, bounds_pt, grasp, traffic  # noqa: E402
from harness.runner import FORBIDDEN, Run, execute, read_metric, result_line  # noqa: E402
from kinds import clusters_pt  # noqa: E402
from reference import point_transformer as PT  # noqa: E402

PT_NAMES = {"classifier": "point_transformer_cls", "rotation": "rotation", "sign": "sign",
            "translation": "translation", "width": "width"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cloud(B, N, seed):
    x = np.random.default_rng(seed).standard_normal((B, N, 3)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None])


def _brute_force(points: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """Each query's k nearest by (distance, index), the distance rounded
    step by step in float32 as ``(dx*dx + dy*dy) + dz*dz``."""
    out = np.empty((*queries.shape[:2], k), np.int64)
    for b in range(points.shape[0]):
        for s, q in enumerate(queries[b]):
            d = points[b] - q
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            out[b, s] = [j for _, j in sorted(zip(d2.tolist(), range(len(d2))))[:k]]
    return out


@pytest.mark.parametrize("B,N,S,k,dups", [(2, 50, 50, 8, 0), (2, 64, 16, 16, 20), (1, 30, 7, 5, 29),
                                          (3, 16, 4, 16, 8), (1, 4, 4, 4, 0)])
def test_knn_plain_version_matches_a_brute_force(B, N, S, k, dups):
    """Queries among the points themselves and elsewhere; ``dups`` points
    repeat earlier ones, so whole runs of distances tie and go to the lower
    index."""
    rng = np.random.default_rng(N + S)
    points = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    points[:, N - dups:] = points[:, :dups]
    queries = np.concatenate([points[:, :S // 2], rng.uniform(-1, 1, (B, S - S // 2, 3)).astype(np.float32)], 1)
    got = knn(torch.from_numpy(points), torch.from_numpy(queries), k)
    assert got.dtype == torch.int64 and got.shape == (B, S, k)
    np.testing.assert_array_equal(got.numpy(), _brute_force(points, queries, k))


def test_a_query_asking_for_more_than_the_cloud_gets_every_point():
    p = _cloud(2, 5, 0)
    idx = query_knn(16, p, p)
    assert idx.shape == (2, 5, 5)
    assert torch.equal(idx.sort(dim=-1).values, torch.arange(5).expand(2, 5, 5))
    assert torch.equal(idx[..., 0], torch.arange(5).expand(2, 5))     # each point first


def test_knn_plan_and_refusals():
    assert knn_plan(1024, 1024, 8) == (256, 32, 12 * 1024)
    assert knn_plan(16, 4, 16) == (128, 4, 192) and knn_plan(64, 16, 16) == (256, 16, 768)
    for N, S, k in [(8, 4, 9), (100, 4, 0), (100, 4, MAX_K + 1), (MAX_POINTS + 1, 4, 4), (0, 1, 1)]:
        with pytest.raises(ValueError, match="knn: no plan"):
            knn_plan(N, S, k)
    with pytest.raises(ValueError, match="outside"):
        knn(_cloud(1, 4, 0), _cloud(1, 2, 1), 5)


def test_knn_group_puts_the_relative_coordinates_first_and_counts_them():
    p, f = _cloud(2, 40, 0), torch.rand(2, 40, 6)
    c = p[:, :10]
    idx = query_knn(8, p, c)
    before = count_grouped.bytes
    g = knn_group(p, f, c, idx)
    assert g.shape == (2, 10, 8, 9) and count_grouped.bytes - before == g.numel() * 4
    b, s, j = 1, 3, 5
    n = int(idx[b, s, j])
    assert torch.equal(g[b, s, j], torch.cat([p[b, n] - c[b, s], f[b, n]]))


# (N, nsample, C) of the attention's layers in a 1024-point forward: 1, 2, 3, 5 and 2 of them a stage
PT_ATTENTION_STAGES = list(zip((1024, 256, 64, 16, 4), PT.NSAMPLE, PT.PLANES))


def _block(C: int, seed: int) -> PointTransformerBlock:
    """A block in eval mode on the benchmark's weights."""
    block = PointTransformerBlock(C).eval()
    block.load_state_dict(clusters_pt.model_state(PointTransformerBlock(C), seed, "cpu"), strict=True)
    return block


@pytest.mark.parametrize("N,nsample,C", PT_ATTENTION_STAGES)
def test_pt_attention_plain_version_matches_the_composed_layer(N, nsample, C):
    """At each stage's shape of the request (stage 5 takes K = min(16, 4)),
    on the benchmark's weights: the one-pass attention's plain version
    against the layer's composed eval forward and its block's bn2 pair,
    the route the CPU takes. The two sum the same float32 terms in other
    orders (the eval passes' rounding against PyTorch's CPU BatchNorm,
    one softmax against another), so they part by float32 reordering:
    some 6e-7 of the largest output at these inputs; 1e-5 of it leaves
    room for the softmax, which passes a last-bit difference of a logit
    on to its weights."""
    block = _block(C, 2**31 + C)
    gen = torch.Generator().manual_seed(C)
    p = _cloud(2, N, C)
    x = torch.relu(3 * torch.randn(2, N, C, generator=gen))
    idx = query_knn(nsample, p, p)
    assert idx.shape == (2, N, min(nsample, N))
    attn = block.attn
    with torch.no_grad():
        assert attention_reason(attn, x, idx, block.bn2) == "device"
        want = attn(p, x, idx, block.bn2)
        got = pt_attention(p, attn.q(x), attn.k(x), attn.v(x), idx, attn, block.bn2)
    assert got.shape == (2, N, C)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_attention_reason_names_what_keeps_the_composed_route():
    block = _block(32, 7)
    attn, bn2 = block.attn, block.bn2
    p = _cloud(1, 20, 0)
    x = torch.rand(1, 20, 32)
    idx = query_knn(8, p, p)
    assert attention_reason(attn, x, idx, bn2) == "grad"           # the parameters want gradients
    with torch.no_grad():
        assert attention_reason(attn, x, idx, bn2) == "device"     # eval, float32, on the CPU
        assert attention_reason(attn, x, query_knn(20, p, p), bn2) == "plan"     # K above 16
        block.train()
        assert attention_reason(attn, x, idx, bn2) == "train"
        block.eval()
        assert attention_reason(attn, x.bfloat16(), idx, bn2) == "dtype"
        set_compute_dtype(block, "bfloat16")
        assert attention_reason(attn, x, idx, bn2) == "dtype"
        set_compute_dtype(block, "float32")
        odd = PointTransformerLayer(36).eval()
        assert attention_reason(odd, torch.rand(1, 20, 36), idx, bn2) == "share"
    with torch.enable_grad():
        for t in block.parameters():
            t.requires_grad_(False)
        assert attention_reason(attn, x, idx, bn2) == "device"
        assert attention_reason(attn, x.requires_grad_(), idx, bn2) == "grad"


def test_pt_attention_plan_and_refusals():
    """A tile of queries a block whose neighbour rows times C fill 8192
    elements: 32 at the first stage (K = 8, C = 32), 2 at the fourth (K =
    16, C = 256), all four at the fifth (N = 4); the shared bytes its
    layout's, within a block's 227 KB. Shapes the kernel does not take
    raise."""
    want = {(1024, 8, 32): (32, 59264), (256, 16, 64): (8, 52512), (64, 16, 128): (4, 55520),
            (16, 16, 256): (2, 81888), (4, 4, 512): (4, 193184)}
    for N, nsample, C in PT_ATTENTION_STAGES:
        K = min(nsample, N)
        plan = pt_attention_plan(32, N, K, C, 8)
        assert (plan.tile, plan.shared_bytes) == want[N, K, C] and plan.threads == attention_kernel.THREADS
        assert plan.tile * K * C <= attention_kernel.TILE_ELEMENTS
        assert plan.shared_bytes <= attention_kernel.MAX_SHARED_BYTES
    for B, N, K, C, s in [(32, 16, 17, 256, 8), (32, 4, 5, 512, 8), (32, 0, 1, 32, 8), (32, 16, 0, 32, 8),
                          (32, 16, 16, 1024, 8), (32, 16, 16, 48, 8), (32, 16, 16, 96, 8), (32, 16, 16, 64, 0),
                          (32, 16, 16, 64, 32), (0, 16, 16, 64, 8), (65536, 16, 16, 64, 8),
                          (32, 2**31, 16, 64, 8), (32, 1000, 8, 4, 1)]:
        with pytest.raises(ValueError, match="pt_attention: no plan"):
            pt_attention_plan(B, N, K, C, s)


def test_pt_attention_refuses_mismatched_inputs():
    block = _block(32, 3)
    p = _cloud(1, 10, 0)
    x = torch.rand(1, 10, 32)
    idx = query_knn(4, p, p)
    with pytest.raises(ValueError, match="pt_attention: want"):
        pt_attention(p, x, x, x[:, :5], idx, block.attn, block.bn2)


def test_the_one_pass_route_forms_only_the_transition_downs_groups(monkeypatch):
    """The classifier with every attention on the one-pass route (its plain
    version on the CPU): the grouped bytes are the four strided
    TransitionDowns' inputs alone, 1,048,320 a 1024-point cloud, and the
    outputs part from the composed route's by float32 reordering (some
    7e-7 of the logits' scale of a thousand or two; held to 1e-5)."""
    state = _pt_state(2**31 + 77)
    model = build_model("point_transformer_cls").eval()
    model.load_state_dict(state, strict=True)
    x = _cloud(2, 1024, 4)
    with torch.no_grad():
        composed = model(x)
        monkeypatch.setattr(pt_layers, "attention_reason", lambda *args: None)
        before = count_grouped.bytes
        fused = model(x)
    assert count_grouped.bytes - before == 2 * 1_048_320
    tds = sum(m * min(nsample, n) * (3 + cin) for (n, m, cin, c, stride, k), nsample
              in zip(bounds_pt.stages(1024), PT.NSAMPLE) if stride > 1)
    assert 4 * tds == 1_048_320
    scale = float(composed[0].abs().max())
    assert float((fused[0] - composed[0]).abs().max()) <= 1e-5 * scale
    assert float((fused[1] - composed[1]).abs().max()) <= 1e-5 * float(composed[1].abs().max())


def _pt_state(seed):
    return clusters_pt.model_state(PT.build(PT.NAME), seed, "cpu")


@pytest.mark.parametrize("B,N", [(2, 256), (2, 1024)])
def test_point_transformer_matches_the_plain_reference(B, N):
    """At the published widths and depth on 256 points (stages of 256, 64,
    16, 4 and 1 points) and on the request's 1024: both run the same float32
    operations in the same order on the CPU, so the outputs are expected to
    be equal; 1e-6 of the largest value leaves room only for a BLAS that
    blocks a product otherwise."""
    state = _pt_state(2**31 + N)
    ref = PT.build(PT.NAME).eval()
    ref.load_state_dict(state, strict=True)
    port = build_model("point_transformer_cls").eval()
    port.load_state_dict(state, strict=True)
    x = _cloud(B, N, N)
    with torch.no_grad():
        got, want = port(x), ref(x)
    for a, b in zip(got[:2], want[:2]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert torch.equal(got[2], want[2])
    assert got[1].shape == (B, 512)


@pytest.mark.parametrize("seed", [3180000003, 2**31 + 23])
def test_pt_request_matches_the_plain_reference(seed):
    """The request with ``classifier="point_transformer_cls"`` through
    ``infer_clusters`` (4 clusters of 512 points, resampled to 256 by FPS:
    one bucket, no padding) against the reference's ``GraspReference``,
    judged as the benchmark judges it (``harness/grasp.py``). The same
    operations in the same order on the CPU: the gaps are expected to be 0.
    The limits, 1e-6 of the log-probabilities' scale (the random weights
    grow the features through 13 residual blocks to logits of
    thousands) and 1e-6 of each head output's largest value, leave room only
    for a BLAS that blocks a sum otherwise."""
    states = {key: clusters_pt.model_state(PT.build(name), (seed * 8 + i) % 2**63, "cpu")
              for i, (key, name) in enumerate(PT_NAMES.items())}
    cfg = PipelineConfig(num_points=256, classifier="point_transformer_cls")
    models = {}
    for key in MODEL_KEYS:
        models[key] = build_model(PT_NAMES[key])
        models[key].load_state_dict(states[key], strict=True)
    pipe = GraspPipeline(cfg, models, device="cpu")
    clusters = traffic.cluster_pool({"requests": 1, "clusters": 4, "points": 512}, seed)[0]
    served = pipe.infer_clusters(clusters)
    ref = PT.GraspReference(states, PT_NAMES, 256, 7, "float32", "cpu")
    gaps = grasp.gaps(ref, torch.from_numpy(clusters), served)
    scale = float(np.abs(served["log_probs"]).max())
    assert gaps["class_err"] <= 1e-6 * scale and gaps["head_err"] <= 1e-6, (gaps, scale)


def test_the_registry_builds_point_transformer_as_a_classifier():
    spec = get_model_spec("point_transformer_cls")
    assert (spec.task, spec.input_kind) == ("classify", "xyz")
    model = GraspPipeline._make(PipelineConfig(classifier="point_transformer_cls"), "classifier")
    blocks = [n for n, _ in model.named_children() if n.startswith("block_")]
    downs = [n for n, _ in model.named_children() if n.startswith("down_")]
    assert len(downs) == 5 and len(blocks) == sum(b - 1 for b in PT.BLOCKS) == 13
    assert model.block_4_1.attn.weight_mlp.dense_1.out_features == 512 // 8
    assert model.down_1.mlp.dense_0.in_features == 32 + 3 and model.down_1.mlp.dense_0.bias is None


def _grouped_bytes_per_cloud(N: int) -> int:
    """The neighbourhood tensors of one cloud: each strided TransitionDown's
    grouped input, and per block rel (3), delta, k_j, a, its pair's output,
    v_j, v_j + delta and the weighted product (C each), the weights and
    their softmax (C/8 each)."""
    total = 0
    for (n, m, cin, c, stride, k), blocks, nsample in zip(bounds_pt.stages(N), PT.BLOCKS, PT.NSAMPLE):
        if stride > 1:
            total += m * min(nsample, n) * (3 + cin)
        total += (blocks - 1) * m * k * (3 + 7 * c + 2 * (c // 8))
    return 4 * total


@pytest.mark.parametrize("N", [256, 1024])
def test_grouped_bytes_count_the_neighbourhoods(N):
    model = build_model("point_transformer_cls").eval()
    before = count_grouped.bytes
    with torch.no_grad():
        model(_cloud(2, N, 1))
    assert count_grouped.bytes - before == 2 * _grouped_bytes_per_cloud(N)


def _flops(model, *args) -> int:
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("N", [256, 1024])
def test_pt_flops_equal_the_flop_counter(N):
    model = PT.build(PT.NAME).eval()
    assert _flops(model, _cloud(1, N, 2)) == bounds.forward_flops(bounds_pt.pt_layers(N))


def test_pt_request_flops_per_cluster():
    heads = sum(bounds.forward_flops(bounds.pose_layers(h, 1024)) for h in bounds.POSE_OUT)
    want = _flops(PT.build(PT.NAME).eval(), _cloud(1, 1024, 3)) + heads
    assert bounds_pt.request_flops_per_cluster(PT_NAMES) == want


def test_pt_call_shapes_and_bounds():
    """Nine kNN queries a forward (five stages, four strided TransitionDowns)
    and four strided FPS; each bound the larger of its bytes and its
    operations."""
    assert bounds_pt.knn_calls(1024) == [(1024, 1024, 8), (1024, 256, 16), (256, 256, 16), (256, 64, 16),
                                         (64, 64, 16), (64, 16, 16), (16, 16, 16), (16, 4, 16), (4, 4, 4)]
    assert bounds_pt.fps_calls(1024) == [(1024, 256), (256, 64), (64, 16), (16, 4)]
    assert bounds_pt.knn_bound_ms(32, 1024, 1024, 8) == pytest.approx(9 * 32 * 1024 * 1024 / 67e12 * 1e3)
    assert bounds_pt.knn_bound_ms(1, 10**6, 1, 1) == pytest.approx((4 * (3 * 10**6 + 3) + 8) / 3.35e12 * 1e3)
    fps_s, knn_s = bounds_pt.request_bounds_s(32, 2048)
    want_fps = bounds.fps_bound_ms(32, 2048, 3, 1024) + sum(bounds.fps_bound_ms(32, n, 3, s)
                                                             for n, s in bounds_pt.fps_calls())
    assert fps_s == pytest.approx(want_fps / 1e3)
    assert knn_s == pytest.approx(sum(bounds_pt.knn_bound_ms(32, *c) for c in bounds_pt.knn_calls()) / 1e3)


def test_the_cell_s_files_are_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    run = Run("clusters_pt_k32", 1, 1.0, True, device="cpu")
    assert run.config["pipeline"]["classifier"] == "point_transformer_cls" and run.config["reduced"] == []
    assert run.mix["kind"] == "clusters_pt" and set(run.limits) == set(grasp.GAPS)
    entry = next(c for c in bench["configs"] if c["name"] == "grasp_pt_f32")
    assert entry["file"] == "bench_port/configs/grasp_pt_f32.json" and (ROOT / entry["file"]).exists()
    assert "clusters_pt_k32" in next(m for m in bench["end_to_end"] if m["name"] == "request_p95_ms")["workloads"]
    names = {m["name"] for m in run.metrics("per_layer")}
    assert names == {f"{m}.serve_pt" for m in ("captures", "fps_roofline", "knn_roofline", "knn_launches", "mfu",
                                               "idle_share", "grouped_gb")}
    profile = {"groups": {"knn": 2e-3}, "idle_share": 5.0}
    readings = {"profile": profile, "knn_bound_s": 1e-3, "knn_launches": 27, "requests": 3, "captures": 0}
    assert read_metric("knn_roofline.serve_pt", readings) == pytest.approx(50.0)
    assert read_metric("knn_launches.serve_pt", readings) == 9
    assert read_metric("knn_roofline.serve_pt", {}) is None and read_metric("knn_launches.serve_pt", {}) is None


def test_the_knn_kernels_leave_other_for_a_group_of_their_own():
    profile = {"groups": {"other": 5.0, "matmul": 1.0},
               "kernels": {"void (anonymous namespace)::knn_kernel<16>(float const*)": (1.5, 9),
                           "knn_kernel<8>": (0.5, 2), "elementwise": (3.0, 4)}}
    clusters_pt.split_knn(profile)
    assert profile["groups"] == {"other": 3.0, "matmul": 1.0, "knn": 2.0}
    assert bounds.group("void (anonymous namespace)::knn_kernel<16>(float const*)") == "other"


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", ["reference/point_transformer.py", "harness/bounds_pt.py", "kinds/clusters_pt.py",
                                  "faults_pt.py", "metrics/knn_roofline.py", "metrics/knn_launches.py"])
def test_the_new_benchmark_files_import_no_jax(path):
    found = _imports(BENCH / path)
    assert not found & set(FORBIDDEN)
    if path.startswith("reference/"):
        assert found <= {"__future__", "numpy", "torch", "reference"}


def _cell(program_dtype=None):
    run = Run("clusters_pt_k32", 2**31 + 101, 0.5, False, device="cpu", program_dtype=program_dtype,
              overrides={"requests": 1, "clusters": 4, "points": 1100, "warmup": 1, "check": 1})
    return result_line(run, execute(run), "cpu", 1, "none")


def test_the_cell_runs_correct_on_the_cpu_and_the_control_does_not():
    """The cell's own loop and judge at 4 clusters: the sound run keeps
    its limits; the program's bfloat16 path against the float32 reference
    does not."""
    line = _cell()
    assert line["correct"] is True and line["failed"] == 0, line["compared"]
    assert set(line["metrics"]) == {"request_p95_ms", "setup_s"}
    control = _cell("bfloat16")
    assert control["correct"] is False, control["compared"]
