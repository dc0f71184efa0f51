"""Rendered visualization (viz/render.py): the headless stand-in for the
reference's rviz output (LeggedRobotVisualizer.cpp:75-369). Asserts the PNG
artifact exists, parses as an image, and that the manifest covers every
series family the reference visualizer draws: feet, CoM, CoP, support
polygon, desired trajectory, per-leg forces."""

import numpy as np

from cheeta_mpc.viz.helpers import LeggedVisualizer
from cheeta_mpc.viz.render import render_run


def _capture(n=25):
    viz = LeggedVisualizer(max_update_frequency=1e9)
    rng = np.random.default_rng(0)
    feet0 = np.array([[0.35, 0.25, 0.0], [0.35, -0.25, 0.0],
                      [-0.35, -0.25, 0.0], [-0.35, 0.25, 0.0]])
    for k in range(n):
        t = 0.02 * k
        state = np.zeros(24)
        state[6] = 0.25 * t  # forward CoM
        state[8] = 0.3 + 0.002 * np.sin(8 * t)
        state[10] = 0.01 * np.sin(5 * t)  # pitch
        state[11] = 0.01 * np.cos(5 * t)  # roll
        feet = feet0 + np.array([0.25 * t, 0.0, 0.0])
        flags = np.array([1.0, k % 2, 1.0, (k + 1) % 2])
        forces = np.zeros((4, 3))
        forces[:, 2] = flags * (80.0 + rng.normal(0, 2, 4))
        viz.update(t, state, feet, forces, flags,
                   desired_com=np.array([0.25 * t, 0.0, 0.3]))
    return viz


def test_render_from_visualizer(tmp_path):
    out = str(tmp_path / "run.png")
    manifest = render_run(_capture(), out, title="test run")
    import matplotlib.image as mpimg
    img = mpimg.imread(out)
    assert img.ndim == 3 and img.shape[0] > 400 and img.shape[1] > 600
    flat = [s for series in manifest.values() for s in series]
    for expected in ("foot path LF", "foot path LH", "CoM path", "CoP path",
                     "support polygon", "desired CoM path", "Fz RF",
                     "base z", "pitch", "roll"):
        assert expected in flat, (expected, flat)


def test_render_from_demo_npz(tmp_path):
    """The legged_demo *_traj.npz format (no contact flags / cop in file)
    renders too — flags derived from forces, CoP computed."""
    viz = _capture(10)
    npz = str(tmp_path / "traj.npz")
    np.savez(npz,
             times=np.array([f.time for f in viz.frames]),
             states=np.stack([f.state for f in viz.frames]),
             feet=np.stack([f.feet for f in viz.frames]),
             forces=np.stack([f.forces for f in viz.frames]))
    out = str(tmp_path / "demo.png")
    manifest = render_run(npz, out)
    assert "forces" in manifest and "topdown" in manifest
    import os
    assert os.path.getsize(out) > 20_000  # a real, non-blank figure
