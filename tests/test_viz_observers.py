"""Visualization data products + multiplier observer."""

import numpy as np

from cheeta_mpc.mpc.runtime import PolicyData
from cheeta_mpc.mpc.solver_observer import ConstraintMultiplierObserver
from cheeta_mpc.viz.helpers import (LeggedVisualizer, center_of_pressure,
                                    support_polygon)

FEET = np.array([[0.3, 0.2, 0.0], [0.3, -0.2, 0.0],
                 [-0.3, 0.2, 0.0], [-0.3, -0.2, 0.0]])


def test_center_of_pressure():
    forces = np.zeros((4, 3))
    forces[:, 2] = [10.0, 10.0, 10.0, 10.0]
    np.testing.assert_allclose(center_of_pressure(FEET, forces),
                               [0.0, 0.0, 0.0], atol=1e-12)
    forces[:, 2] = [20.0, 0.0, 0.0, 0.0]
    np.testing.assert_allclose(center_of_pressure(FEET, forces), FEET[0])
    # No load: mean foot position.
    np.testing.assert_allclose(center_of_pressure(FEET, np.zeros((4, 3))),
                               FEET.mean(axis=0))


def test_support_polygon():
    # All four feet: full hull (4 vertices).
    poly = support_polygon(FEET, np.ones(4))
    assert poly.shape == (4, 3)
    # Diagonal pair (trot): a line segment.
    poly2 = support_polygon(FEET, np.array([1.0, 0.0, 0.0, 1.0]))
    assert poly2.shape == (2, 3)
    # Flight: empty.
    assert support_polygon(FEET, np.zeros(4)).shape == (0, 3)
    # Interior point dropped: center foot inside triangle of others.
    feet5 = FEET.copy()
    feet5[3] = [0.0, 0.0, 0.0]  # strictly inside the other three
    poly3 = support_polygon(feet5, np.ones(4))
    assert poly3.shape == (3, 3)


def test_visualizer_rate_limit_and_save(tmp_path):
    viz = LeggedVisualizer(max_update_frequency=100.0)
    x = np.zeros(24)
    f = np.zeros((4, 3))
    assert viz.update(0.000, x, FEET, f, np.ones(4))
    assert not viz.update(0.005, x, FEET, f, np.ones(4))  # < 10 ms later
    assert viz.update(0.012, x, FEET, f, np.array([1.0, 0, 0, 1.0]))
    assert len(viz.frames) == 2
    out = tmp_path / "viz.npz"
    viz.save(str(out))
    data = np.load(str(out))
    assert data["times"].shape == (2,)
    assert data["cop"].shape == (2, 3)
    assert data["polygon"].shape[0] == 2


def test_multiplier_observer():
    N, ng = 5, 3
    times = 0.1 * np.arange(N + 1)
    lam_l = np.arange((N + 1) * ng, dtype=np.float64).reshape(N + 1, ng)
    pol = PolicyData(times=times, x_traj=np.zeros((N + 1, 2)),
                     u_traj=np.zeros((N, 1)), lam_l=lam_l,
                     lam_u=np.zeros((N + 1, ng)))
    obs = ConstraintMultiplierObserver(time_offsets=(0.0, 0.25),
                                       interpolation="nearest")
    obs(pol)
    assert len(obs.samples) == 1
    s = obs.samples[0]
    np.testing.assert_array_equal(s.lam_l[0], lam_l[0])
    # 0.25 s -> nearest node is index 2 or 3 (0.2 / 0.3); argmin picks 2.
    np.testing.assert_array_equal(s.lam_l[1], lam_l[2])
    lin = ConstraintMultiplierObserver(time_offsets=(0.25,),
                                       interpolation="linear")
    lin(pol)
    np.testing.assert_allclose(lin.samples[0].lam_l[0],
                               0.5 * (lam_l[2] + lam_l[3]))
    # Policies without duals are skipped.
    obs(PolicyData(times=times, x_traj=np.zeros((N + 1, 2)),
                   u_traj=np.zeros((N, 1))))
    assert len(obs.samples) == 1
