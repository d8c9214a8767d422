"""The yardstick's arithmetic: the models' matrix-product operations
against ``torch.utils.flop_counter`` on the reference models, and the
kernels' least times against the numbers they are defined by."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import bounds
from reference import geometry as G
from reference.models import build, dropouts


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["pointnet2_cls_ssg", "rotation", "sign", "translation", "width"])
def test_forward_flops_equal_the_flop_counter(name):
    torch.manual_seed(0)
    model = build(name).eval()
    if name == "pointnet2_cls_ssg":
        layers = bounds.ssg_layers()
        x = (torch.rand(1, 1024, 3),)
    else:
        layers = bounds.pose_layers(name, 1024)
        x = (torch.rand(1, 1024, 10), torch.rand(1, 3)) if name == "translation" else (torch.rand(1, 1024, 10),)
    with torch.no_grad():
        assert _counted(lambda: model(*x)) == bounds.forward_flops(layers)


def test_grasp_flops_per_cluster():
    total = 0
    for name in ["pointnet2_cls_ssg", "rotation", "sign", "translation", "width"]:
        model = build(name).eval()
        c = 3 if name == "pointnet2_cls_ssg" else 10
        args = (torch.rand(1, 1024, c),) + ((torch.rand(1, 3),) if name == "translation" else ())
        with torch.no_grad():
            total += _counted(lambda: model(*args))
    assert total == bounds.grasp_flops_per_cluster() == 2_893_487_688


def test_training_flops_per_cloud():
    torch.manual_seed(0)
    model = build("pointnet2_cls_ssg").train()
    for _, d in dropouts(model):
        d.uniforms = torch.rand(2, d.features)

    def step():
        model(torch.rand(2, 1024, 3))[0].sum().backward()

    assert _counted(step) == 2 * bounds.ssg_train_flops_per_cloud() == 2 * 5_018_823_168


def test_fps_bound_is_the_operations_at_the_request_sizes():
    # 32 clouds of 2048 points to 1024: 32 * 1024 * 2048 * 10 operations at 67 TFLOP/s
    assert bounds.fps_bound_ms(32, 2048, 3, 1024) == pytest.approx(32 * 1024 * 2048 * 10 / 67e12 * 1e3)
    # one point sampled from a large cloud is bound by its bytes
    assert bounds.fps_bound_ms(1, 10**6, 3, 1) == pytest.approx(4 * (3 * 10**6 + 2) / 3.35e12 * 1e3)


def test_scanned_points_counts_a_scan_in_index_order():
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-1, 1, (2, 200, 3)).astype(np.float32))
    cen = pts[:, :17]
    d2 = G.square_distance(cen, pts).numpy()
    r2, k = G.radius_sq(0.5), 8
    want = 0
    for b in range(2):
        for s in range(17):
            seen = hits = 0
            for n in range(200):
                seen += 1
                hits += d2[b, s, n] <= r2
                if hits == k:
                    break
            want += seen
    assert bounds.scanned_points(pts, cen, 0.5, k) == want


def test_kernel_groups():
    assert bounds.group("void (anonymous namespace)::fps_register_kernel<8>(float const*)") == "fps"
    assert bounds.group("ball_query_kernel<4>") == "ball_query"
    assert bounds.group("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x128x8") == "matmul"
    assert bounds.group("void at::native::vectorized_elementwise_kernel<4>") == "other"
    assert bounds.matmul_peak("float32", False) == 67e12
    assert bounds.matmul_peak("float32", True) == 495e12
