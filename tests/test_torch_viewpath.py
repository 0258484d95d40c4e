"""The port's copy of the free-view camera paths against the JAX
package's module (both numpy): equal to 1e-12."""

import numpy as np
import pytest

from topfusion_tpu.geometry import viewpath as jvp
from topfusion_tpu_torch.geometry import viewpath as tvp

TOL = 1e-12


def anchor():
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = q
    T[:3, 3] = [0.3, -0.2, -0.5]
    return T


@pytest.mark.parametrize("up", [(0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (0.3, -0.8, 0.1)])
def test_look_at(up):
    """The second hint is parallel to the view ray (the fallback axis)."""
    eye, target = np.array([0.1, -0.3, -0.4]), np.array([0.1, -0.3, 1.1])
    a = tvp.look_at(eye, target, np.array(up))
    b = jvp.look_at(eye, target, np.array(up))
    assert a.dtype == b.dtype == np.float32 and a.shape == (4, 4)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    R = a[:3, :3].astype(np.float64)
    np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(R[:, 2], [0, 0, 1], atol=1e-6)


@pytest.mark.parametrize("n,sweep", [(4, 40.0), (12, 360.0), (1, 90.0)])
def test_orbit_path(n, sweep):
    center = np.array([0.05, 0.1, 1.2], np.float32)
    a = tvp.orbit_path(center, anchor(), n, max_sweep_deg=sweep)
    b = jvp.orbit_path(center, anchor(), n, max_sweep_deg=sweep)
    assert len(a) == len(b) == n
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL)
    # The path starts at the anchor's eye and keeps its distance.
    np.testing.assert_allclose(a[0][:3, 3], anchor()[:3, 3], atol=1e-6)
    r = [np.linalg.norm(T[:3, 3] - center) for T in a]
    np.testing.assert_allclose(r, r[0], atol=1e-5)


def test_orbit_path_from_the_center_itself():
    T = anchor()
    a = tvp.orbit_path(T[:3, 3], T, 3)
    b = jvp.orbit_path(T[:3, 3], T, 3)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL)


@pytest.mark.parametrize("key", list("wsadrfjlik") + ["x"])
def test_move_pose(key):
    """Every key of the viewer, and an unknown one (no move)."""
    a = tvp.move_pose(anchor(), key, step_m=0.07, step_deg=7.0)
    b = jvp.move_pose(anchor(), key, step_m=0.07, step_deg=7.0)
    assert a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert (key == "x") == np.array_equal(a, anchor())


@pytest.mark.parametrize("num_blocks", [0, 1, 57])
def test_map_centroid(num_blocks):
    coords = np.random.default_rng(8).integers(-30, 30, size=(64, 3)).astype(np.int32)
    a = tvp.map_centroid(coords, num_blocks, 0.04)
    b = jvp.map_centroid(coords, num_blocks, 0.04)
    assert a.dtype == np.float32 and a.shape == (3,)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_the_copy_imports_numpy_only():
    import ast
    import pathlib

    tree = ast.parse(pathlib.Path(tvp.__file__).read_text())
    mods = {n.module if isinstance(n, ast.ImportFrom) else a.name
            for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in n.names}
    assert mods == {"__future__", "typing", "numpy"}
