"""The 7 object categories' surface samplers: a frozen copy of
``pointnet_like_pose_estimation_tpu_torch/data/generators.py`` at commit
aa745b2 (numpy only), which transcribes the reference's data_build/*.py.

The benchmark makes every cloud it sends from these functions, so that a
change to the program's own generator changes no input of the benchmark.
"""

from __future__ import annotations

import numpy as np

CATEGORIES = (
    "cube",
    "cuboid",
    "cylinder",
    "h_structure",
    "double_cube",
    "double_cylinder",
    "cube_cylinder",
)


def _num(lo: float, hi: float, delta: float) -> int:
    """Reference grid count: int(length/delta), min 1 (Cube.py:31-35)."""
    n = int((hi - lo) / delta)
    return max(n, 1)


def _grid(x_range, y_range, delta) -> np.ndarray:
    """Dense plane grid at z=0 (Cube.plane, Cube.py:37-42), vectorized."""
    xs = np.linspace(x_range[0], x_range[1], num=_num(*x_range, delta))
    ys = np.linspace(y_range[0], y_range[1], num=_num(*y_range, delta))
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    out = np.zeros((gx.size, 3))
    out[:, 0] = gx.ravel()
    out[:, 1] = gy.ravel()
    return out


def _stack_z(layer: np.ndarray, z_range, delta) -> np.ndarray:
    """Replicate a z=0 layer over z levels (Cube.stack, Cube.py:44-48)."""
    zs = np.linspace(z_range[0], z_range[1], num=_num(*z_range, delta))
    out = np.tile(layer, (len(zs), 1))
    out[:, 2] += np.repeat(zs, len(layer))
    return out


def cube_surface(length: float, width: float, height: float, delta: float = 1 / 500) -> np.ndarray:
    """Box surface lattice (Cube.__init__, Cube.py:5-29): 4 side walls from
    stacked boundary lines + top/bottom cap grids."""
    xr = [-length / 2, length / 2]
    yr = [-width / 2, width / 2]
    zr = [-height / 2, height / 2]
    sides = np.concatenate(
        [
            _grid([xr[0], xr[0]], yr, delta),
            _grid([xr[1], xr[1]], yr, delta),
            _grid(xr, [yr[0], yr[0]], delta),
            _grid(xr, [yr[1], yr[1]], delta),
        ]
    )
    sides = _stack_z(sides, zr, delta)
    cap = _grid(xr, yr, delta)
    caps = np.concatenate([cap + [0, 0, zr[0]], cap + [0, 0, zr[1]]])
    return np.concatenate([sides, caps])


def _circle_boundary(radius: float, delta: float) -> np.ndarray:
    """Circle boundary points (Cylinder.circle_boundary, Cylinder.py:30-38)."""
    n = _num(0, 2 * radius * np.pi, delta)
    theta = np.linspace(0, 2 * np.pi, num=n)
    out = np.zeros((n, 3))
    out[:, 0] = radius * np.cos(theta)
    out[:, 1] = radius * np.sin(theta)
    return out


def _circle_plane(radius: float, delta: float) -> np.ndarray:
    """Filled disc from vertical chords over half-circle angles
    (Cylinder.circle_plane, Cylinder.py:40-51)."""
    cols = []
    for ang in np.linspace(0, np.pi, num=_num(0, radius * np.pi, delta)):
        x = radius * np.cos(ang)
        y = radius * np.sin(ang)
        ys = np.linspace(-y, y, num=_num(-y, y, delta))
        col = np.zeros((len(ys), 3))
        col[:, 0] = x
        col[:, 1] = ys
        cols.append(col)
    return np.concatenate(cols)


def cylinder_surface(radius: float, height: float, delta: float = 1 / 500) -> np.ndarray:
    """Cylinder lateral surface + filled end caps (Cylinder.py:5-22)."""
    zr = [-height / 2, height / 2]
    lateral = _stack_z(_circle_boundary(radius, delta), zr, delta)
    disc = _circle_plane(radius, delta)
    caps = np.concatenate([disc + [0, 0, zr[0]], disc + [0, 0, zr[1]]])
    return np.concatenate([lateral, caps])


def h_structure_surface(
    H: float = 0.1,
    B: float = 0.1,
    t1: float = 0.02,
    t2: float = 0.02,
    height: float = 0.1,
    delta: float = 1 / 250,
) -> np.ndarray:
    """H-beam surface lattice (H_structure.__init__, H_structure.py:5-42).

    Cross-section: 4 flange outer/inner lines, 2 web lines, 4 flange edge
    segments, minus the inner-line spans crossing the web; stacked over z
    with end caps; pre-rotated 90° about x like the reference (:39). The
    reference's FPS-to-1024 (:37) happens downstream in build_dataset.
    """
    xr_max = [-B / 2, B / 2]
    xr_min = [-t1 / 2, t1 / 2]
    yr_max = [-H / 2, H / 2]
    yr_min = [-(H / 2 - t2), H / 2 - t2]
    zr = [-height / 2, height / 2]

    sec = []
    # horizontal full-width lines at y in yr_max + yr_min (copy_line, :15-16)
    l1 = _grid(xr_max, [0, 0], delta)
    for dy in yr_max + yr_min:
        sec.append(l1 + [0, dy, 0])
    # vertical web lines at x = ±t1/2 (:18-19)
    l2 = _grid([0, 0], yr_min, delta)
    for dx in xr_min:
        sec.append(l2 + [dx, 0, 0])
    # flange edge segments at (±B/2, ±(H-t2)/2) (:21-22)
    l3 = _grid([0, 0], [-t2 / 2, t2 / 2], delta)
    for dx in xr_max:
        for dy in [-(H - t2) / 2, (H - t2) / 2]:
            sec.append(l3 + [dx, dy, 0])
    sec = np.concatenate(sec)

    # delete inner-line points crossing the web opening (:24-25)
    on_inner = (
        (sec[:, 0] >= xr_min[0])
        & (sec[:, 0] <= xr_min[1])
        & (
            np.isclose(sec[:, 1], yr_min[0], atol=1e-12)
            | np.isclose(sec[:, 1], yr_min[1], atol=1e-12)
        )
    )
    sec = sec[~on_inner]

    body = _stack_z(sec, zr, delta)

    # end caps: two flange strips + web plate (:29-35)
    strip = _grid(xr_max, [-t2 / 2, t2 / 2], delta)
    cap = np.concatenate(
        [
            strip + [0, -(H - t2) / 2, 0],
            strip + [0, (H - t2) / 2, 0],
            _grid(xr_min, yr_min, delta),
        ]
    )
    pts = np.concatenate([body, cap + [0, 0, zr[0]], cap + [0, 0, zr[1]]])

    # pre-rotation 90° about x (H_structure.py:39)
    rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], dtype=float)
    return pts @ rot.T


def double_cube_surface(size_1, size_2, excursion: bool = True, delta: float = 1 / 500) -> np.ndarray:
    """Two stacked cubes with optional lateral offset (Double_cube.py:6-20)."""
    c1 = cube_surface(*size_1, delta)
    c2 = cube_surface(*size_2, delta)
    off = np.array([0.0, 0.0, (size_1[2] + size_2[2]) / 2])
    if excursion:
        off += [(size_2[0] - size_1[0]) / 3, (size_2[1] - size_1[1]) / 4, 0]
    return np.concatenate([c1 + off, c2])


def double_cylinder_surface(size_1, size_2, excursion: bool = True, delta: float = 1 / 500) -> np.ndarray:
    """Two stacked cylinders (Double_cylinder.py:6-18); sizes are
    (radius, height)."""
    c1 = cylinder_surface(*size_1, delta)
    c2 = cylinder_surface(*size_2, delta)
    off = np.array([0.0, 0.0, (size_1[1] + size_2[1]) / 2])
    if excursion:
        off += [(size_2[0] - size_1[0]) / 3, (size_2[0] - size_1[0]) / 2, 0]
    return np.concatenate([c1 + off, c2])


def cube_cylinder_surface(size_cylinder, size_cube, excursion: bool = True, delta: float = 1 / 500) -> np.ndarray:
    """Cylinder stacked on a cube (Cube_cylinder.py:7-18). The z-offset uses
    the cube's *y*-size, faithfully reproducing the reference quirk (:14)."""
    cyl = cylinder_surface(*size_cylinder, delta)
    cub = cube_surface(*size_cube, delta)
    off = np.array([0.0, 0.0, size_cylinder[1] / 2 + size_cube[1] / 2])
    if excursion:
        off += [
            (size_cube[0] - size_cylinder[0]) / 4,
            (size_cube[1] - size_cylinder[0]) / 3,
            0,
        ]
    return np.concatenate([cyl + off, cub])


def clip_half(points: np.ndarray) -> np.ndarray:
    """Keep the upper-z half (single-view capture sim, Cube.py:74-79)."""
    thresh = (points[:, 2].max() + points[:, 2].min()) / 2
    return points[points[:, 2] >= thresh]


def sample_category_params(category: str, rng: np.random.Generator) -> dict:
    """Draw one sample's shape/pose parameters.

    Transcribes data_build/build_data.py:62-174: per-category size
    distributions, position x,y ∈ ±0.5, z ∈ [-1.0, -0.6], Euler angles ±45°
    (±90° roll for non-cube categories). ``randint(a,b)/k`` becomes
    ``rng.integers(a, b+1)/k``.
    """
    p = {
        "px": rng.integers(-50, 51) / 100,
        "py": rng.integers(-50, 51) / 100,
        "pz": rng.integers(-100, -59) / 100,
        "theta": float(rng.integers(-45, 46)),
        "psi": float(rng.integers(-45, 46)),
    }
    p["phi"] = float(rng.integers(-45, 46) if category == "cube" else rng.integers(-90, 91))

    if category == "cube":
        s = rng.integers(5, 11) / 100
        p["surface"] = ("cube", (s, s, s))
    elif category == "cuboid":
        p["surface"] = (
            "cube",
            (rng.integers(3, 7) / 100, rng.integers(7, 11) / 100, rng.integers(4, 9) / 100),
        )
    elif category == "cylinder":
        p["surface"] = ("cylinder", (rng.integers(15, 41) / 1000, rng.integers(4, 9) / 100))
    elif category == "h_structure":
        p["surface"] = (
            "h_structure",
            (
                rng.integers(8, 11) / 100,
                rng.integers(8, 11) / 100,
                rng.integers(1, 4) / 100,
                rng.integers(1, 4) / 100,
                rng.integers(5, 11) / 100,
            ),
        )
    elif category == "double_cube":
        s1 = [[0.08, 0.03, 0.05], [0.04, 0.06, 0.08], [0.02, 0.07, 0.03]]
        s2 = [[0.08, 0.03, 0.08], [0.07, 0.09, 0.09], [0.10, 0.04, 0.09]]
        p["surface"] = ("double_cube", (s1[rng.integers(0, 3)], s2[rng.integers(0, 3)]))
    elif category == "double_cylinder":
        s1 = [[0.02, 0.07], [0.03, 0.06], [0.015, 0.09]]
        s2 = [[0.04, 0.08], [0.05, 0.10], [0.035, 0.09]]
        p["surface"] = ("double_cylinder", (s1[rng.integers(0, 3)], s2[rng.integers(0, 3)]))
    elif category == "cube_cylinder":
        s1 = [[0.02, 0.07], [0.03, 0.06], [0.015, 0.09]]
        s2 = [[0.08, 0.05, 0.08], [0.07, 0.09, 0.09], [0.10, 0.04, 0.09]]
        p["surface"] = ("cube_cylinder", (s1[rng.integers(0, 3)], s2[rng.integers(0, 3)]))
    else:
        raise ValueError(f"unknown category {category!r}")
    return p


_SURFACE_FNS = {
    "cube": cube_surface,
    "cylinder": cylinder_surface,
    "h_structure": h_structure_surface,
    "double_cube": double_cube_surface,
    "double_cylinder": double_cylinder_surface,
    "cube_cylinder": cube_cylinder_surface,
}


def dense_surface(params: dict) -> np.ndarray:
    """Build the dense axis-aligned surface cloud for sampled params."""
    kind, args = params["surface"]
    return _SURFACE_FNS[kind](*args)
