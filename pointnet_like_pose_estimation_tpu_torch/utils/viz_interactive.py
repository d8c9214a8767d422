"""Interactive viewers with headless fallbacks (counterpart of
``utils/viz_interactive.py`` of the JAX package, which this module copies).

The reference opens live windows: an OpenCV side-by-side RGBD stream and
Open3D geometry viewers. Each viewer here uses a window where one can open
(OpenCV with a display, or a matplotlib GUI backend) and otherwise writes
PNGs through the headless renderers of ``utils.viz``:

  RGBDStream: cv2 and $DISPLAY -> a live cv2 window (a waitKey loop);
              otherwise -> a PNG frame sequence in ``out_dir``
  show_cloud / show_clusters: a matplotlib GUI backend -> plt.show();
              otherwise -> a PNG of four azimuths (clouds) or one view
              (clusters)

cv2, matplotlib and PIL are imported inside the functions only.
"""

from __future__ import annotations

import os

import numpy as np

from pointnet_like_pose_estimation_tpu_torch.utils import viz


def _cv2_window_available() -> bool:
    if not os.environ.get("DISPLAY") and os.name != "nt":
        return False
    try:  # pragma: no cover - requires a display
        import cv2  # noqa: F401

        return True
    except Exception:
        return False


def _gui_matplotlib_available() -> bool:
    if not os.environ.get("DISPLAY") and os.name != "nt":
        return False
    try:  # pragma: no cover - requires a display
        import matplotlib

        return matplotlib.get_backend().lower() not in ("agg", "pdf", "svg")
    except Exception:
        return False


class RGBDStream:
    """Live RGBD side-by-side viewer with headless frame-dump fallback.

    Parity: ``visualization_RGBD`` (realsense.py:112-122) — color with the
    background removed past ``depth_clip_m``, next to colorized depth.

    Usage (both backends):
        stream = RGBDStream(out_dir="log/rgbd")   # out_dir used headless
        for color, depth in camera.frames():
            if not stream.show(color, depth):     # False once user quits
                break
        stream.close()
    """

    def __init__(self, *, depth_clip_m: float | None = 1.0,
                 depth_scale: float = 1e-3, out_dir: str = "log/rgbd_frames",
                 max_frames: int = 300):
        self.depth_clip_m = depth_clip_m
        self.depth_scale = depth_scale
        self.out_dir = out_dir
        self.max_frames = max_frames
        self.frame_idx = 0
        self.interactive = _cv2_window_available()
        if not self.interactive:
            os.makedirs(out_dir, exist_ok=True)

    def _compose(self, color: np.ndarray, depth: np.ndarray) -> np.ndarray:
        """The reference's composition (realsense.py:114-121): grey out
        background by depth, stack beside a jet-colorized depth map."""
        color = np.asarray(color)
        depth_m = np.asarray(depth, np.float32) * self.depth_scale
        shown = color.copy()
        if self.depth_clip_m is not None:
            mask = (depth_m <= 0) | (depth_m > self.depth_clip_m)
            shown[mask] = 153
        # colorize depth without cv2: jet-map through matplotlib's LUT.
        # NOTE: the LUT lookup needs no canvas, so do NOT force a backend
        # here — matplotlib.use("Agg") would silently switch the whole
        # process to headless and break a later interactive show_cloud()
        from matplotlib import colormaps

        dmax = max(float(depth_m.max()), 1e-6)
        dm = colormaps["jet"](np.clip(depth_m / dmax, 0, 1))[..., :3]
        dm = (dm * 255).astype(np.uint8)
        return np.concatenate([shown, dm], axis=1)

    def show(self, color: np.ndarray, depth: np.ndarray) -> bool:
        """Display (or dump) one frame; returns False when the viewer should
        stop (keypress in the live window, or max_frames headless)."""
        frame = self._compose(color, depth)
        self.frame_idx += 1
        if self.interactive:  # pragma: no cover - requires a display
            import cv2

            cv2.imshow("RGBD", frame[..., ::-1])  # RGB -> BGR
            return cv2.waitKey(1) in (-1, 255)
        from PIL import Image

        Image.fromarray(frame).save(
            os.path.join(self.out_dir, f"frame_{self.frame_idx:05d}.png")
        )
        return self.frame_idx < self.max_frames

    def close(self):
        if self.interactive:  # pragma: no cover
            import cv2

            cv2.destroyAllWindows()


def show_cloud(points: np.ndarray, *, title: str | None = None,
               path: str | None = None):
    """Open3D ``draw_geometries`` counterpart for one cloud.

    Interactive: opens a matplotlib 3-D window (rotatable). Headless:
    renders 4 azimuth views to ``path`` (default log/cloud_views.png) so
    the geometry is inspectable without a display.
    """
    points = np.asarray(points)
    if _gui_matplotlib_available():  # pragma: no cover - requires a display
        # build the figure on the CURRENT (GUI) backend — the viz.* helpers
        # force Agg internally, which would make plt.show() a silent no-op
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        color = np.clip(points[:, 3:6], 0, 1) if points.shape[-1] >= 6 else None
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=1.5, c=color)
        if title:
            ax.set_title(title)
        plt.show()
        return None
    path = path or "log/cloud_views.png"
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 3.2))
    color = None
    if points.shape[-1] >= 6:
        color = np.clip(points[:, 3:6], 0.0, 1.0)
    lo, hi = points[:, :3].min(), points[:, :3].max()
    for i, azim in enumerate((0, 90, 180, 270)):
        ax = fig.add_subplot(1, 4, i + 1, projection="3d")
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=1.2, c=color)
        ax.view_init(elev=20, azim=azim)
        ax.set_xlim(lo, hi), ax.set_ylim(lo, hi), ax.set_zlim(lo, hi)
        ax.set_title(f"azim {azim}°", fontsize=8)
    if title:
        fig.suptitle(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def show_clusters(clusters, *, path: str | None = None):
    """Cluster-array viewer (colledt_data_structure/collect.py:104-117
    counterpart): interactive window when possible, else a PNG via
    ``viz.plot_clusters``."""
    if _gui_matplotlib_available():  # pragma: no cover - requires a display
        import matplotlib.pyplot as plt
        from matplotlib import colormaps

        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        cmap = colormaps["tab10"]
        for i, cl in enumerate(clusters):
            cl = np.asarray(cl)
            ax.scatter(cl[:, 0], cl[:, 1], cl[:, 2], s=1.5,
                       color=cmap(i % 10), label=f"cluster {i}")
        ax.legend(loc="upper right", fontsize=7)
        plt.show()
        return None
    path = path or "log/cluster_views.png"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    viz.plot_clusters(clusters, path=path)
    return path
