"""Point Transformer's layers: the vector self-attention over kNN
neighbourhoods, its residual block and the TransitionDown between stages
(Zhao et al. 2021, arXiv:2012.09164; POSTECH-CVLab/point-transformer
``model/pointtransformer/pointtransformer_seg.py``: ``PointTransformerLayer``,
``PointTransformerBlock``, ``TransitionDown``), channels-last over a batch
of clouds ``[B, N, C]`` where the published code packs them into one
``[sum N, C]``.

Two departures, both of the neighbourhoods and not of the arithmetic: a
cloud of fewer points than ``nsample`` groups all of them (``min(nsample,
N)`` neighbours), and a stage's kNN is queried once and shared by all its
blocks (the published layer queries again in every block, on the same
points, so the indices are the same).

Where ``attention_reason`` is None (eval mode, no gradient, float32 on
the card, a shape the kernel's plan takes) the attention and its block's
``bn2`` pair run as one pass, ``kernels/pt_attention.py``, which forms no
neighbourhood tensor. Elsewhere (train mode, a gradient, bfloat16, the
CPU) the attention is composed: every BatchNorm + ReLU pair goes through
``nn/layers.py`` ``bn_relu_pair`` or a ``PointwiseMLP`` (the eval passes of
``kernels/bn_relu.py`` on the card), and the neighbourhood tensors it
forms are counted through ``ops/grouping.py`` ``count_grouped``. The
stride-4 TransitionDown groups its one-layer MLP's input and takes the max
in the pooled eval pass (``PointwiseMLP.forward_max``): the per-point route
of ``nn/set_abstraction.py`` wants two layers.
"""

from __future__ import annotations

import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.kernels.pt_attention import pt_attention, pt_attention_plan
from pointnet_like_pose_estimation_tpu_torch.nn.layers import BatchNormF32, Linear, PointwiseMLP, bn_relu_pair
from pointnet_like_pose_estimation_tpu_torch.ops.geometry import index_points
from pointnet_like_pose_estimation_tpu_torch.ops.grouping import count_grouped, knn_group, query_knn
from pointnet_like_pose_estimation_tpu_torch.ops.sampling import farthest_point_sample


class PointTransformerLayer(nn.Module):
    """Vector self-attention of each point over its neighbours ``idx [B,
    N, K]`` (itself among them) at C channels, the weights shared by
    ``share_planes`` groups of C / share_planes channels:

    - ``q, k, v``: Linears with bias;
    - ``delta_ij = pos(p_j - p_i)``: Linear 3->3, BN, ReLU, Linear 3->C;
    - ``w_ij = weight_mlp(relu(weight_bn(k_j - q_i + delta_ij)))``: BN,
      ReLU, Linear C->C/s, BN, ReLU, Linear C/s->C/s; a softmax over j;
    - ``y_i[g C/s + t] = sum_j (v_j + delta_ij)[g C/s + t] w_ij[t]``.

    The softmax and the weighted sum run in float32. ``forward`` gives
    ``relu(bn2(y))``, its block's pair ``bn2`` taken with it."""

    def __init__(self, channels: int, share_planes: int = 8):
        super().__init__()
        self.channels, self.share_planes = channels, share_planes
        self.q = Linear(channels, channels)
        self.k = Linear(channels, channels)
        self.v = Linear(channels, channels)
        self.pos = PointwiseMLP(3, [3, channels], final_activation=False)
        self.weight_bn = BatchNormF32(channels)
        self.weight_mlp = PointwiseMLP(channels, [channels // share_planes] * 2, final_activation=False)

    def forward(self, p: torch.Tensor, x: torch.Tensor, idx: torch.Tensor, bn2: nn.Module) -> torch.Tensor:
        """``relu(bn2(y))``: in one pass (``kernels/pt_attention.py``)
        where ``attention_reason`` is None, else composed."""
        q, k, v = self.q(x), self.k(x), self.v(x)
        if attention_reason(self, x, idx, bn2) is None:
            return pt_attention(p, q, k, v, idx, self, bn2)
        return bn_relu_pair(self._composed(p, q, k, v, idx), bn2)

    def _composed(self, p, q, k, v, idx) -> torch.Tensor:
        B, N, K = idx.shape
        s, c = self.share_planes, self.channels // self.share_planes
        delta = self.pos(knn_group(p, None, p, idx))
        k_j, v_j = index_points(k, idx), index_points(v, idx)
        a = k_j - q[:, :, None, :] + delta
        h = bn_relu_pair(a, self.weight_bn)
        w = self.weight_mlp(h)
        w_soft = torch.softmax(w.float(), dim=2)
        vd = (v_j + delta).float()
        prod = vd.view(B, N, K, s, c) * w_soft[:, :, :, None, :]
        for t in (delta, k_j, v_j, a, h, w, w_soft, vd, prod):
            count_grouped(t)
        return prod.sum(dim=2).view(B, N, self.channels)


def attention_reason(attn: PointTransformerLayer, x: torch.Tensor, idx: torch.Tensor, bn2: nn.Module) -> str | None:
    """Why the attention of ``attn`` over ``idx`` on its input ``x``, with
    its block's pair ``bn2``, is composed, or None where it runs as one
    pass (``kernels/pt_attention.py``): ``"train"`` (``attn`` or ``bn2``
    in train mode), ``"grad"`` (a gradient wanted of the output: the pass
    has no backward), ``"dtype"`` (``x`` not float32, or a Linear
    computing in another dtype: the bfloat16 path), ``"share"`` (channels
    no multiple of ``share_planes``), ``"plan"`` (a shape the kernel's plan
    refuses) or ``"device"`` (not a CUDA tensor: the CPU, where the port is
    held against the plain reference)."""
    if attn.training or bn2.training:
        return "train"
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for m in (attn, bn2)
                                                            for t in m.parameters())):
        return "grad"
    if x.dtype != torch.float32 or any(m.compute_dtype is not None for m in attn.modules() if isinstance(m, Linear)):
        return "dtype"
    B, N, K = idx.shape
    if attn.channels % attn.share_planes:
        return "share"
    try:
        pt_attention_plan(B, N, K, attn.channels, attn.share_planes)
    except ValueError:
        return "plan"
    if not x.is_cuda:
        return "device"
    return None


class PointTransformerBlock(nn.Module):
    """``relu(bn3(linear3(relu(bn2(attn(relu(bn1(linear1 x)))))) + x)``,
    linear1 and linear3 without bias (``mlp1`` holds linear1 and bn1)."""

    def __init__(self, channels: int, share_planes: int = 8):
        super().__init__()
        self.mlp1 = PointwiseMLP(channels, [channels], bias=False)
        self.attn = PointTransformerLayer(channels, share_planes)
        self.bn2 = BatchNormF32(channels)
        self.linear3 = Linear(channels, channels, bias=False)
        self.bn3 = BatchNormF32(channels)

    def forward(self, p: torch.Tensor, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        y = self.attn(p, self.mlp1(x), idx, self.bn2)
        return torch.relu(self.bn3(self.linear3(y)) + x)


class TransitionDown(nn.Module):
    """Stride 1: ``relu(bn(W x))``. Stride s > 1: N // s centroids by FPS
    from the first point, and for each the max over its ``nsample``
    nearest points of ``relu(bn(W [p_j - c_i, x_j]))``. W has no bias."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, nsample: int):
        super().__init__()
        self.stride, self.nsample = stride, nsample
        self.mlp = PointwiseMLP(in_channels + (3 if stride > 1 else 0), [out_channels], bias=False)

    def forward(self, p: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.stride == 1:
            return p, self.mlp(x)
        S = p.shape[1] // self.stride
        if S == 0:
            raise ValueError(f"TransitionDown: {p.shape[1]} points at stride {self.stride} leave none")
        centroids = index_points(p, farthest_point_sample(p, S))
        grouped = knn_group(p, x, centroids, query_knn(self.nsample, p, centroids))
        return centroids, self.mlp.forward_max(grouped)
