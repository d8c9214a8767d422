"""The MSG request's yardstick (``harness/bounds_msg.py``): the models'
matrix-product operations against ``torch.utils.flop_counter`` on the
reference models, and the multi-scale ball query's scanned pairs against a
count made point by point."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import bounds, bounds_msg
from reference import geometry as G
from reference import msg

MSG = {"classifier": "pointnet2_cls_msg", "rotation": "rotation_msg", "sign": "sign_msg",
       "translation": "translation_msg", "width": "width"}


def _counted(model, name) -> int:
    c = 3 if name.startswith("pointnet2") else 10
    gen = torch.Generator().manual_seed(0)
    args = (torch.rand(1, 1024, c, generator=gen),)
    if name.startswith("translation"):
        args += (torch.rand(1, 3, generator=gen),)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["pointnet2_cls_msg", "rotation_msg", "sign_msg", "translation_msg"])
def test_msg_forward_flops_equal_the_flop_counter(name):
    model = msg.build(name).eval()
    assert _counted(model, name) == bounds.forward_flops(bounds_msg.model_layers(name))


def test_msg_request_flops_per_cluster():
    total = sum(_counted(msg.build(name).eval(), name) for name in MSG.values())
    assert total == bounds_msg.request_flops_per_cluster(MSG) == 23_568_129_608


def test_the_ssg_request_counts_as_bounds_counts_it():
    names = {"classifier": "pointnet2_cls_ssg", "rotation": "rotation", "sign": "sign",
             "translation": "translation", "width": "width"}
    assert bounds_msg.request_flops_per_cluster(names) == bounds.grasp_flops_per_cluster()


def _scanned_by_hand(points, centroids, radii, ks) -> int:
    """Walk each centroid's points in index order, one scale count each,
    until every scale holds its K or the points run out."""
    d2 = G.square_distance(centroids, points)
    B, S, N = d2.shape
    total = 0
    for b in range(B):
        for s in range(S):
            found = [0] * len(ks)
            visited = 0
            for j in range(N):
                if all(f >= k for f, k in zip(found, ks)):
                    break
                visited += 1
                for i, r in enumerate(radii):
                    found[i] += int(float(d2[b, s, j]) <= G.radius_sq(r))
            total += visited
    return total


@pytest.mark.parametrize("radii,ks", [((0.2, 0.4), (4, 16)), ((0.1, 0.2, 0.4), (16, 4, 32)), ((0.3,), (8,))])
def test_scanned_pairs_equal_a_walk_point_by_point(radii, ks):
    gen = torch.Generator().manual_seed(3)
    points = torch.rand(2, 150, 3, generator=gen) - 0.5
    centroids = G.index_points(points, G.fps(points, 12))
    assert bounds_msg.scanned_pairs(points, centroids, radii, ks) == _scanned_by_hand(points, centroids, radii, ks)
    if len(ks) == 1:
        assert bounds_msg.scanned_pairs(points, centroids, radii, ks) == bounds.scanned_points(
            points, centroids, radii[0], ks[0])
        assert bounds_msg.ball_query_multi_bound_ms(points, centroids, radii, ks) == bounds.ball_query_bound_ms(
            points, centroids, radii[0], ks[0])
