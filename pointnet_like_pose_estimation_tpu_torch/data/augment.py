"""Batch preparation (counterpart of ``data/augment.py`` of the JAX
package): the one-hot splice, the cloud centroid and the eval-time
normalisation. The random train-time augmentations are not ported yet."""

from __future__ import annotations

import torch

from pointnet_like_pose_estimation_tpu_torch.ops.geometry import normalize_cloud


def splice_onehot(points: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Append a one-hot class vector to every point's channels:
    ``[B, N, C]`` + ``[B]`` labels -> ``[B, N, C + num_classes]``."""
    B, N, _ = points.shape
    oh = torch.nn.functional.one_hot(labels.long(), num_classes).to(points.dtype)
    return torch.cat([points, oh[:, None, :].expand(B, N, num_classes)], dim=-1)


def cloud_mean(points: torch.Tensor, *, compat_first3: bool = False) -> torch.Tensor:
    """Cloud centroid ``[B, C]`` fed to the translation heads' mean-MLP.
    ``compat_first3`` reproduces the reference's quirk, the mean of the
    first three POINTS; the default is the centroid of all of them."""
    if compat_first3:
        return points[:, :3, :].mean(dim=1)
    return points.mean(dim=1)


def eval_preprocess(points: torch.Tensor) -> torch.Tensor:
    """Eval-time preprocessing: normalise into the unit sphere, nothing else."""
    return normalize_cloud(points)
