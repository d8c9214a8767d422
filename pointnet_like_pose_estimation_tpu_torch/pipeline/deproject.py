"""Depth image to point cloud, the pinhole model on the device (counterpart
of ``pipeline/deproject.py`` of the JAX package).

The camera file is the reference's ``camera.json``: width, height, fps and
``depth_``/``color_`` fx, fy, ppx, ppy; without a file the defaults below
(a D4xx at 640x480) apply.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics; ``depth_scale`` turns raw depth units into metres."""

    width: int = 640
    height: int = 480
    fps: int = 30
    fx: float = 384.9848022460938
    fy: float = 384.9848022460938
    ppx: float = 317.2736206054688
    ppy: float = 241.2351684570312
    depth_scale: float = 0.001

    @classmethod
    def from_json(cls, path: str, stream: str = "depth") -> "CameraIntrinsics":
        with open(path) as f:
            d = json.load(f)
        return cls(width=d["width"], height=d["height"], fps=d.get("fps", 30),
                   fx=d[f"{stream}_fx"], fy=d[f"{stream}_fy"],
                   ppx=d[f"{stream}_ppx"], ppy=d[f"{stream}_ppy"])


def deproject_depth(depth, intr: CameraIntrinsics, color=None, *, flip_yz: bool = True,
                    device="cuda") -> torch.Tensor:
    """``[H, W]`` depth (raw units) -> ``[H*W, 3]`` float32 points on
    ``device``, ``[H*W, 6]`` with an ``[H, W, 3]`` colour in [0, 1]
    appended. ``flip_yz`` negates y and z, as the reference does. A pixel of
    depth 0 lands on the origin; the distance cut removes it downstream.

    Every step is one float32 operation in the JAX package's order, so the
    result is the JAX package's bit for bit.
    """
    device = resolve_device(device, "deproject_depth")
    depth = torch.as_tensor(np.asarray(depth)).to(device)
    H, W = depth.shape
    z = depth.to(torch.float32) * intr.depth_scale
    u = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    x = (u - intr.ppx) / intr.fx * z
    y = (v - intr.ppy) / intr.fy * z
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    if flip_yz:
        pts = pts * torch.tensor([1.0, -1.0, -1.0], device=device)
    if color is not None:
        rgb = torch.as_tensor(np.asarray(color)).to(device).reshape(-1, 3).to(torch.float32)
        pts = torch.cat([pts, rgb], dim=-1)
    return pts
