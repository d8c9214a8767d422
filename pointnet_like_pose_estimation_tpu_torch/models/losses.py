"""Loss and metric functions on tensors (counterparts of
``models/losses.py`` of the JAX package)."""

from __future__ import annotations

import torch

from pointnet_like_pose_estimation_tpu_torch.nn.tnet import orthogonality_regularizer


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over int labels; ``log_probs [B, C]``."""
    return -log_probs.gather(1, labels[:, None].long()).mean()


def classification_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    trans_feat: torch.Tensor | None = None,
    mat_diff_scale: float = 0.001,
) -> torch.Tensor:
    """NLL, plus the orthogonality penalty of a ``[B, k, k]`` feature transform."""
    loss = nll_loss(log_probs, labels)
    if trans_feat is not None and trans_feat.dim() == 3:
        loss = loss + mat_diff_scale * orthogonality_regularizer(trans_feat)
    return loss


def regression_loss(
    pred: torch.Tensor, target: torch.Tensor, kind: str = "L2_loss", reduction: str = "mean"
) -> torch.Tensor:
    """MSE (``L2_loss``) or L1, reduced by mean or sum."""
    err = pred - target
    per_elem = err * err if kind == "L2_loss" else err.abs()
    return per_elem.sum() if reduction == "sum" else per_elem.mean()


def sign_loss(
    prob: torch.Tensor, sign_target: torch.Tensor, *, compat_pm1: bool = False, eps: float = 1e-7
) -> torch.Tensor:
    """Binary cross-entropy on sigmoid outputs ``[B, 1]``. Targets of +-1
    are mapped to {0, 1} unless ``compat_pm1`` feeds them in unmapped."""
    t = sign_target.reshape(prob.shape).to(prob.dtype)
    if not compat_pm1:
        t = torch.where(t > 0, 1.0, 0.0)
    p = prob.clamp(eps, 1.0 - eps)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()


def accuracy(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Instance accuracy from log-probabilities."""
    return (log_probs.argmax(dim=-1) == labels).float().mean()


def sign_accuracy(hard_sign: torch.Tensor, sign_target: torch.Tensor) -> torch.Tensor:
    """Match rate of the hard sign against the sign of the target."""
    t = sign_target.reshape(hard_sign.shape).to(hard_sign.dtype)
    return (hard_sign == torch.where(t > 0, 1.0, -1.0)).float().mean()


def mean_abs_error(pred: torch.Tensor, target: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Mean absolute error over every axis, times ``scale`` (100 for cm)."""
    return (pred - target).abs().mean() * scale
