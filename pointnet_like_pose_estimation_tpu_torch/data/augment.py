"""Batch preparation (counterpart of ``data/augment.py`` of the JAX
package): the random train-time augmentations, the one-hot splice, the
cloud centroid and the eval-time normalisation.

Each augmentation is split in two: a *draw* of its random numbers from a
``torch.Generator`` (on the generator's device), and an *apply*, a pure
function of the points and those numbers. The draws are unit uniforms
(normals for ``jitter``, a permutation for ``shuffle_points``) in the
shapes JAX draws them, and the apply maps them to a range the way
``jax.random.uniform(minval, maxval)`` does, so the same numbers give the
same result in both packages and on any device. ``random_*`` is the two in
one, as the JAX functions of the same names.

Distributions (the reference's provider.py):
- point dropout: per-cloud ratio U[0, 0.875), dropped points replaced by
  the cloud's first point;
- scale: per-cloud U[0.8, 1.25);
- shift: per-cloud U[-0.1, 0.1)^C;
- jitter: clipped gaussian, sigma 0.01, clip 0.05;
- shuffle: one permutation of the points shared by the batch.
"""

from __future__ import annotations

import torch

from pointnet_like_pose_estimation_tpu_torch.ops.geometry import normalize_cloud

# the reference's distributions; the label-consistent branch of the train
# step draws from the same constants
SCALE_LO, SCALE_HI = 0.8, 1.25
SHIFT_RANGE = 0.1
MAX_DROPOUT_RATIO = 0.875


def uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """Unit uniforms U[0, 1) of ``shape`` from ``gen``, on its device."""
    return torch.rand(shape, generator=gen, device=gen.device)


def _in_range(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` from its unit draw:
    ``max(lo, u * (hi - lo) + lo)`` with the bounds in float32."""
    # made on the device (a fill, no copy from the host, which a captured
    # train step could not make)
    lo32 = torch.full((), lo, dtype=torch.float32, device=u.device)
    hi32 = torch.full((), hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo32, u * (hi32 - lo32) + lo32)


def draw_point_dropout(gen: torch.Generator, points: torch.Tensor):
    """``(ratio [B, 1], drop [B, N])`` unit uniforms."""
    B, N, _ = points.shape
    return uniform(gen, (B, 1)), uniform(gen, (B, N))


def point_dropout(points: torch.Tensor, u_ratio: torch.Tensor, u_drop: torch.Tensor,
                  max_ratio: float = MAX_DROPOUT_RATIO) -> torch.Tensor:
    """Replace each point whose draw is at most the cloud's ratio
    (``u_ratio * max_ratio``) with the cloud's first point."""
    drop = u_drop <= u_ratio * max_ratio                       # [B, N]
    return torch.where(drop[..., None], points[:, :1, :], points)


def random_point_dropout(gen: torch.Generator, points: torch.Tensor,
                         max_ratio: float = MAX_DROPOUT_RATIO) -> torch.Tensor:
    return point_dropout(points, *draw_point_dropout(gen, points), max_ratio)


def draw_scale(gen: torch.Generator, points: torch.Tensor) -> torch.Tensor:
    """``[B, 1, 1]`` unit uniforms."""
    return uniform(gen, (points.shape[0], 1, 1))


def scale_factor(u: torch.Tensor, lo: float = SCALE_LO, hi: float = SCALE_HI) -> torch.Tensor:
    """The per-cloud factor in [lo, hi) that the unit draw ``u`` gives."""
    return _in_range(u, lo, hi)


def scale(points: torch.Tensor, u: torch.Tensor, lo: float = SCALE_LO,
          hi: float = SCALE_HI) -> torch.Tensor:
    return points * scale_factor(u, lo, hi)


def random_scale(gen: torch.Generator, points: torch.Tensor, lo: float = SCALE_LO,
                 hi: float = SCALE_HI) -> torch.Tensor:
    return scale(points, draw_scale(gen, points), lo, hi)


def draw_shift(gen: torch.Generator, points: torch.Tensor) -> torch.Tensor:
    """``[B, 1, C]`` unit uniforms."""
    return uniform(gen, (points.shape[0], 1, points.shape[-1]))


def shift_offset(u: torch.Tensor, rng: float = SHIFT_RANGE) -> torch.Tensor:
    """The per-cloud offset in [-rng, rng) that the unit draw ``u`` gives."""
    return _in_range(u, -rng, rng)


def shift(points: torch.Tensor, u: torch.Tensor, rng: float = SHIFT_RANGE) -> torch.Tensor:
    return points + shift_offset(u, rng)


def random_shift(gen: torch.Generator, points: torch.Tensor, rng: float = SHIFT_RANGE) -> torch.Tensor:
    return shift(points, draw_shift(gen, points), rng)


def draw_jitter(gen: torch.Generator, points: torch.Tensor) -> torch.Tensor:
    """Standard normals of the points' shape."""
    return torch.randn(points.shape, generator=gen, device=gen.device)


def jitter(points: torch.Tensor, normal: torch.Tensor, sigma: float = 0.01,
           clip: float = 0.05) -> torch.Tensor:
    """Add ``clip(sigma * normal, -clip, clip)`` to every coordinate."""
    return points + torch.clamp(sigma * normal, -clip, clip)


def random_jitter(gen: torch.Generator, points: torch.Tensor, sigma: float = 0.01,
                  clip: float = 0.05) -> torch.Tensor:
    return jitter(points, draw_jitter(gen, points), sigma, clip)


def draw_shuffle(gen: torch.Generator, points: torch.Tensor) -> torch.Tensor:
    """One permutation of the N points."""
    return torch.randperm(points.shape[1], generator=gen, device=gen.device)


def shuffle_points(points: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The points of every cloud in the order ``perm`` (this changes FPS)."""
    return points[:, perm.to(points.device), :]


def random_shuffle_points(gen: torch.Generator, points: torch.Tensor) -> torch.Tensor:
    return shuffle_points(points, draw_shuffle(gen, points))


def draw_augment(gen: torch.Generator, points: torch.Tensor) -> dict:
    """The draws of the train step's augmentation, in the order it makes
    them: point dropout (``ratio``, ``drop``), ``scale``, ``shift``."""
    ratio, drop = draw_point_dropout(gen, points)
    return {"ratio": ratio, "drop": drop, "scale": draw_scale(gen, points),
            "shift": draw_shift(gen, points)}


def train_augment(points: torch.Tensor, draws: dict) -> torch.Tensor:
    """The classification train-time pipeline on ``draw_augment``'s draws:
    dropout -> scale -> shift -> normalise."""
    p = point_dropout(points, draws["ratio"], draws["drop"])
    return normalize_cloud(shift(scale(p, draws["scale"]), draws["shift"]))


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
