"""Headless visualisation (counterpart of ``utils/viz.py`` of the JAX
package, which this module copies).

The reference draws in windows: an OpenCV side-by-side RGBD view, 3-D
scatters of the generated clouds, a viewer of a ``[n_clusters, K, C]``
cluster array. These functions render with matplotlib's Agg backend and
return the figure; ``path=`` saves a PNG. Inputs are host numpy arrays.
matplotlib is imported inside the functions, so the module imports where
it is not installed.
"""

from __future__ import annotations

import numpy as np


def _fig(figsize):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt.figure(figsize=figsize)


def _finish(fig, path):
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        import matplotlib.pyplot as plt

        plt.close(fig)
    return fig


def plot_cloud(points: np.ndarray, *, color=None, path: str | None = None,
               title: str | None = None, point_size: float = 1.5):
    """3-D scatter of one cloud ``[N, C>=3]``.

    With ``C >= 6`` and no explicit color, channels 3:6 are treated as RGB
    (the xyzrgb layout of pipeline/deproject.py), matching the reference's
    Open3D color rendering.
    """
    points = np.asarray(points)
    if points.size == 0:
        raise ValueError("plot_cloud: empty cloud")
    if color is None and points.shape[-1] >= 6:
        color = np.clip(points[:, 3:6], 0.0, 1.0)
    fig = _fig((6, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=point_size, c=color)
    if title:
        ax.set_title(title)
    # equal aspect so boxes look like boxes (matplotlib 3d default skews)
    lo, hi = points[:, :3].min(), points[:, :3].max()
    ax.set_xlim(lo, hi), ax.set_ylim(lo, hi), ax.set_zlim(lo, hi)
    return _finish(fig, path)


def plot_clusters(clusters: np.ndarray | list, *, path: str | None = None,
                  point_size: float = 1.5):
    """Scatter a ``[n_clusters, K, C]`` array (or list of ``[K_i, C]``)
    with one categorical color per cluster — the 3D-array-aware visualizer
    of colledt_data_structure/collect.py:104-117."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import colormaps

    if len(clusters) == 0:
        raise ValueError("plot_clusters: no clusters")
    fig = _fig((6, 6))
    ax = fig.add_subplot(projection="3d")
    cmap = colormaps["tab10"]
    allpts = []
    for i, cl in enumerate(clusters):
        cl = np.asarray(cl)
        ax.scatter(cl[:, 0], cl[:, 1], cl[:, 2], s=point_size,
                   color=cmap(i % 10), label=f"cluster {i}")
        allpts.append(cl[:, :3])
    allpts = np.concatenate(allpts, axis=0)
    lo, hi = allpts.min(), allpts.max()
    ax.set_xlim(lo, hi), ax.set_ylim(lo, hi), ax.set_zlim(lo, hi)
    ax.legend(loc="upper right", fontsize=7)
    return _finish(fig, path)


def plot_rgbd(color: np.ndarray, depth: np.ndarray, *,
              depth_clip_m: float | None = None, depth_scale: float = 1e-3,
              path: str | None = None):
    """Side-by-side color + colorized depth, with the color image's
    background removed past ``depth_clip_m`` — visualization_RGBD
    (realsense.py:112-122) without OpenCV windows.

    ``depth`` is raw sensor units; ``depth_scale`` converts to meters
    (RealSense default 1 mm/unit).
    """
    color = np.asarray(color)
    depth_m = np.asarray(depth, np.float32) * depth_scale
    shown = color.copy()
    if depth_clip_m is not None:
        mask = (depth_m <= 0) | (depth_m > depth_clip_m)
        shown[mask] = 153  # the reference's grey fill
    fig = _fig((10, 4))
    ax1 = fig.add_subplot(1, 2, 1)
    ax1.imshow(shown)
    ax1.set_title("color (bg removed)" if depth_clip_m else "color")
    ax1.axis("off")
    ax2 = fig.add_subplot(1, 2, 2)
    im = ax2.imshow(depth_m, cmap="jet")
    ax2.set_title("depth (m)")
    ax2.axis("off")
    fig.colorbar(im, ax=ax2, fraction=0.046)
    return _finish(fig, path)


def plot_history(history: list[dict], *, path: str | None = None):
    """Training-curve plot from ``train()``'s history rows — the
    machine-readable replacement for the reference's assets/*.png
    screenshots."""
    fig = _fig((10, 4))
    ax1 = fig.add_subplot(1, 2, 1)
    epochs = [row["epoch"] for row in history]
    ax1.plot(epochs, [row["train_loss"] for row in history], label="train loss")
    if any("test_loss" in row for row in history):
        ax1.plot(epochs, [row.get("test_loss", np.nan) for row in history],
                 label="test loss")
    ax1.set_xlabel("epoch"), ax1.legend(), ax1.grid(alpha=0.3)
    ax2 = fig.add_subplot(1, 2, 2)
    for key in ("test_instance_acc", "test_class_acc", "test_mean_err",
                "test_metric"):
        if any(key in row for row in history):
            ax2.plot(epochs, [row.get(key, np.nan) for row in history],
                     label=key)
    ax2.set_xlabel("epoch"), ax2.legend(fontsize=7), ax2.grid(alpha=0.3)
    return _finish(fig, path)
