"""Point sub-sampling: farthest point sampling and random sampling
(counterpart of ``ops/sampling.py`` of the JAX package). The device of the
tensor picks the FPS implementation: the plain version on the CPU, the CUDA
kernel on a card.

Where the JAX package takes a PRNG key, the port takes a ``torch.Generator``
on the CPU: the random numbers are drawn there and moved to the points'
device, so the card and the CPU take the same draws from one seed. Each
sampler is split into a draw (``draw_start``, ``draw_scores``) and a
function of the draw, so that the JAX package's own draws can be fed in.
"""

from __future__ import annotations

import torch

from pointnet_like_pose_estimation_tpu_torch.kernels.fps import fps
from pointnet_like_pose_estimation_tpu_torch.ops.geometry import index_points


def draw_start(B: int, N: int, generator: torch.Generator) -> torch.Tensor:
    """``[B]`` int32 first centroids, uniform in ``[0, N)``, on the CPU."""
    return torch.randint(0, N, (B,), generator=generator, dtype=torch.int32)


def farthest_point_sample(
    points: torch.Tensor, num_samples: int, start_idx=0, generator: torch.Generator | None = None
) -> torch.Tensor:
    """``[B, N, C]`` clouds -> ``[B, S]`` int32 indices of the FPS points,
    starting from ``start_idx`` (an int or a ``[B]`` tensor). A
    ``generator`` replaces ``start_idx`` with ``draw_start``'s uniform
    draw, as the JAX package's ``key`` does."""
    if generator is not None:
        start_idx = draw_start(points.shape[0], points.shape[1], generator).to(points.device)
    return fps(points, int(num_samples), start_idx)


def draw_scores(B: int, N: int, generator: torch.Generator) -> torch.Tensor:
    """``[B, N]`` float32 unit uniforms, on the CPU: the keys that
    ``sample_by_scores`` ranks."""
    return torch.rand((B, N), generator=generator)


def sample_by_scores(points: torch.Tensor, scores: torch.Tensor, num_samples: int) -> torch.Tensor:
    """``[B, S, C]``: the S points of each ``[B, N, C]`` cloud with the
    largest ``scores``, highest first (top-k, then a gather)."""
    _, idx = torch.topk(scores.to(points.device), num_samples, dim=-1)
    return index_points(points, idx)


def random_sample(points: torch.Tensor, num_samples: int, generator: torch.Generator) -> torch.Tensor:
    """``num_samples`` distinct points of each ``[B, N, C]`` cloud, uniformly
    (a random permutation cut to S, as top-k over uniform scores)."""
    B, N, _ = points.shape
    return sample_by_scores(points, draw_scores(B, N, generator), num_samples)
