"""Live RealSense capture (counterpart of ``pipeline/camera.py`` of the JAX
package). ``pyrealsense2`` is imported when a camera is opened, and its
absence raises; ``data.io_utils.ReplayCamera`` serves saved frames instead.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pointnet_like_pose_estimation_tpu_torch.pipeline.deproject import (
    CameraIntrinsics,
    deproject_depth,
)


class RealSenseCamera:
    """A RealSense D4xx streaming aligned depth and colour at the intrinsics
    of ``config_path`` (the reference's ``camera.json``); ``get_cloud``
    deprojects a frame on ``device`` and returns it as a host array, and
    ``close`` writes the intrinsics the camera reported back to
    ``config_path``."""

    def __init__(self, config_path: str = "camera.json", device="cuda"):
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise RuntimeError(
                "pyrealsense2 is not installed; replay saved frames with "
                "data.io_utils.ReplayCamera instead") from e
        self._rs = rs
        self.intr = (CameraIntrinsics.from_json(config_path) if os.path.exists(config_path)
                     else CameraIntrinsics())
        self.config_path = config_path
        self.device = device
        self._pipeline = None

    def start(self) -> None:
        rs = self._rs
        self._pipeline = rs.pipeline()
        cfg = rs.config()
        for stream, fmt in ((rs.stream.depth, rs.format.z16), (rs.stream.color, rs.format.bgr8)):
            cfg.enable_stream(stream, self.intr.width, self.intr.height, fmt, self.intr.fps)
        profile = self._pipeline.start(cfg)
        d = profile.get_stream(rs.stream.depth).as_video_stream_profile().get_intrinsics()
        self.intr = CameraIntrinsics(width=d.width, height=d.height, fps=self.intr.fps,
                                     fx=d.fx, fy=d.fy, ppx=d.ppx, ppy=d.ppy)
        self._align = rs.align(rs.stream.color)

    def get_cloud(self) -> np.ndarray | None:
        frames = self._align.process(self._pipeline.wait_for_frames())
        depth, color = frames.get_depth_frame(), frames.get_color_frame()
        if not depth or not color:
            return None
        d = np.asanyarray(depth.get_data())
        c = np.asanyarray(color.get_data())[..., ::-1] / 255.0        # bgr -> rgb
        return deproject_depth(d, self.intr, c, device=self.device).cpu().numpy()

    def close(self) -> None:
        if self._pipeline is not None:
            self._pipeline.stop()
        i = self.intr
        fields = {"width": i.width, "height": i.height, "fps": i.fps}
        for stream in ("depth", "color"):
            fields.update({f"{stream}_ppx": i.ppx, f"{stream}_ppy": i.ppy,
                           f"{stream}_fx": i.fx, f"{stream}_fy": i.fy})
        with open(self.config_path, "w") as f:
            json.dump(fields, f, indent=4)
