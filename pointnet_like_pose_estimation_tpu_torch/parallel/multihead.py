"""The four pose heads fanned out over devices (counterpart of
``parallel/multihead.py`` of the JAX package).

The classifier and the rotation, sign, translation and width heads are
placed round-robin over ``devices``, the heads first, as the JAX package
places them. The classifier's front (normalise, classify, splice the
predicted class) runs on its device; then every head is launched before any
result is read, each on a CUDA stream of its own, so heads that share a
card may run side by side and heads on other cards run at once. On the CPU
the heads run one after another.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Sequence

import numpy as np
import torch
from torch import nn

from pointnet_like_pose_estimation_tpu_torch.data.augment import splice_onehot
from pointnet_like_pose_estimation_tpu_torch.ops import euler_rotation_matrix, normalize_cloud
from pointnet_like_pose_estimation_tpu_torch.utils.device import resolve_device

_HEADS = ("rotation", "sign", "translation", "width")


class MultiHeadParallel:
    """Classifier and four pose heads placed round-robin over ``devices``.

    Args:
      models: name -> ``nn.Module`` for classifier, rotation, sign,
        translation and width (``GraspPipeline.models``); a copy of each
        goes to its device, in eval mode.
      num_classes: the one-hot width spliced onto the pose inputs.
      devices: the devices to fan out over; by default every visible card
        (raising where there is none). Fewer devices than models share them.
    """

    def __init__(self, models: dict[str, nn.Module], *, num_classes: int = 7,
                 devices: Sequence | None = None):
        if devices is None:
            resolve_device("cuda", "MultiHeadParallel")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = [resolve_device(d, "MultiHeadParallel") for d in devices]
        order = list(_HEADS) + ["classifier"]
        self.placement = {n: devices[i % len(devices)] for i, n in enumerate(order)}
        self.num_classes = num_classes
        self.models = {n: copy.deepcopy(models[n]).to(self.placement[n]).eval() for n in order}
        self._streams = {n: torch.cuda.Stream(d) for n, d in self.placement.items() if d.type == "cuda"}

    def __call__(self, xyz) -> dict[str, np.ndarray]:
        """``[K, N, 3]`` raw cluster clouds -> the grasp dict of
        ``GraspPipeline.infer_clusters``, as host numpy arrays."""
        with torch.inference_mode():
            home = self.placement["classifier"]
            xyz = torch.as_tensor(np.ascontiguousarray(xyz, np.float32)).to(home)
            mean = xyz.mean(dim=1)
            normed = normalize_cloud(xyz)
            log_probs, _, pred_class = self.models["classifier"](normed)
            spliced = splice_onehot(normed, pred_class, self.num_classes)
            front = torch.cuda.current_stream(home) if home.type == "cuda" else None
            out = {}
            for name in _HEADS:
                dev, stream = self.placement[name], self._streams.get(name)
                if stream is not None and front is not None:       # the head starts after the front
                    stream.wait_stream(front)
                with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                    args = (spliced.to(dev, non_blocking=True),)
                    if name == "translation":
                        args += (mean.to(dev, non_blocking=True),)
                    out[name] = self.models[name](*args)
            for name, stream in self._streams.items():
                if name in out:          # the copies below run on the current streams
                    torch.cuda.current_stream(stream.device).wait_stream(stream)
                    torch.cuda.current_stream(home).wait_stream(stream)
            rot = out["rotation"].float().to(home)
            sign_prob, hard_sign = (t.to(home) for t in out["sign"])
            signed_rot = torch.cat([rot[:, :2], rot[:, 2:] * hard_sign], dim=1)
            res = {
                "log_probs": log_probs,
                "pred_class": pred_class.to(torch.int32),
                "rotation_deg": signed_rot,
                "rotation_matrix": euler_rotation_matrix(torch.deg2rad(signed_rot)),
                "sign_prob": sign_prob[:, 0],
                "translation": out["translation"].float().to(home),
                "width": out["width"].float().to(home)[:, 0],
            }
            return {k: v.cpu().numpy() for k, v in res.items()}

