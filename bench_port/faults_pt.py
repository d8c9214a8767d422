"""``control.py`` with three more planted faults, of Point Transformer's
attention, for the limits of a cell on it:

    python3 bench_port/faults_pt.py --workload clusters_pt_k32 --seeds 1 2 --seconds 3 --plant unshared

- ``unshared``: the attention weights applied in the other layout: channel
  ``i`` of the value takes weight ``i // share_planes`` where the
  published layer gives it weight ``i mod C / share_planes``, so that each
  weight serves one run of neighbouring channels and not one channel of
  every group;
- ``no_delta``: the position encoding left out of the value branch (``v_j``
  where the layer sums ``v_j + delta_ij``);
- ``no_self``: each point's own index dropped from its neighbourhood (the
  nearest point left out of every stage's kNN, which keeps one neighbour
  fewer).

Every other argument, and the output, is ``control.py``'s.
"""

import sys

import control


def _patch_weighted_sum(unshared: bool, with_delta: bool):
    """``PointTransformerLayer.forward`` with the weighted sum broken as
    named (the rest of the layer as the port computes it)."""
    import torch

    from pointnet_like_pose_estimation_tpu_torch.nn import point_transformer as P
    from pointnet_like_pose_estimation_tpu_torch.ops.geometry import index_points

    def forward(self, p, x, idx):
        B, N, K = idx.shape
        s, c = self.share_planes, self.channels // self.share_planes
        q, k, v = self.q(x), self.k(x), self.v(x)
        delta = self.pos(P.knn_group(p, None, p, idx))
        a = index_points(k, idx) - q[:, :, None, :] + delta
        w = torch.softmax(self.weight_mlp(P.bn_relu_pair(a, self.weight_bn)).float(), dim=2)
        value = (index_points(v, idx) + (delta if with_delta else 0)).float()
        if unshared:
            return (value.view(B, N, K, c, s) * w[..., None]).sum(dim=2).view(B, N, self.channels)
        return (value.view(B, N, K, s, c) * w[:, :, :, None, :]).sum(dim=2).view(B, N, self.channels)

    P.PointTransformerLayer.forward = forward


def _no_self():
    from pointnet_like_pose_estimation_tpu_torch.models import classifiers
    from pointnet_like_pose_estimation_tpu_torch.ops.grouping import query_knn

    def without_self(num_neighbors, points, queries):
        idx = query_knn(num_neighbors, points, queries)
        return idx[..., 1:] if idx.shape[-1] > 1 else idx

    classifiers.query_knn = without_self


if __name__ == "__main__":
    control.FAULTS.update(unshared=lambda: _patch_weighted_sum(True, True),
                          no_delta=lambda: _patch_weighted_sum(False, False), no_self=_no_self)
    sys.exit(control.main())
