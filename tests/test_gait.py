"""Gait layer: mode encoding, schedule tiling, swing splines."""

import numpy as np
import pytest

from cheeta_mpc.gait.motion_phase import (contact_flags_of_mode,
                                          mode_from_name, mode_name,
                                          mode_number)
from cheeta_mpc.gait.schedule import (GaitSchedule, ModeSchedule,
                                      stance_template, trot_template)
from cheeta_mpc.gait.swing import (CubicSpline, SplineCpg, SwingConfig,
                                   SwingTrajectoryPlanner,
                                   swing_trajectory_scaling)


def test_mode_roundtrip():
    """All 16 modes round-trip through flags (reference
    MotionPhaseDefinition.h:46-150 bitmask semantics)."""
    for mode in range(16):
        flags = contact_flags_of_mode(mode)
        assert mode_number(flags) == mode
    assert mode_name(15) == "STANCE"
    assert mode_name(0) == "FLY"
    assert mode_from_name("LF_RH") == 9
    np.testing.assert_allclose(contact_flags_of_mode(9), [1, 0, 0, 1])
    np.testing.assert_allclose(contact_flags_of_mode(6), [0, 1, 1, 0])


def test_mode_schedule_lookup_and_table():
    ms = ModeSchedule(event_times=[0.5, 1.0], mode_sequence=[15, 9, 6])
    assert ms.mode_at(0.0) == 15
    assert ms.mode_at(0.7) == 9
    assert ms.mode_at(1.5) == 6
    table = ms.contact_table(t0=0.4, dt=0.2, horizon=4)
    # midpoints at 0.5, 0.7, 0.9, 1.1 -> modes 9 (0.5 boundary -> right), 9, 9, 6
    np.testing.assert_allclose(table[1], [1, 0, 0, 1])
    np.testing.assert_allclose(table[3], [0, 1, 1, 0])


def test_gait_schedule_insert_and_tile():
    gs = GaitSchedule.stance(stance_template(), t0=0.0)
    gs.insert_template(trot_template(cycle=0.8), insert_time=1.0)
    ms = gs.get_mode_schedule(0.0, 4.0)
    # Stance until 1.0 + 0.4 transition stance, then alternating trot modes.
    assert ms.mode_at(0.5) == 15
    assert ms.mode_at(1.2) == 15  # transition stance
    m_a = ms.mode_at(1.5)
    m_b = ms.mode_at(1.9)
    assert {m_a, m_b} == {9, 6}
    # Periodicity: one full cycle later, same modes.
    assert ms.mode_at(1.5 + 0.8) == m_a
    assert ms.mode_at(1.9 + 0.8) == m_b
    # Tiling covers the requested window.
    assert ms.event_times[-1] >= 4.0 - 0.8


def test_cubic_spline_endpoint_conditions():
    s = CubicSpline(t0=1.0, t1=1.5, p0=0.0, v0=0.2, p1=0.3, v1=-0.4)
    np.testing.assert_allclose(s.position(1.0), 0.0, atol=1e-12)
    np.testing.assert_allclose(s.velocity(1.0), 0.2, atol=1e-12)
    np.testing.assert_allclose(s.position(1.5), 0.3, atol=1e-12)
    np.testing.assert_allclose(s.velocity(1.5), -0.4, atol=1e-12)
    # Velocity is the derivative of position (finite difference check).
    ts = np.linspace(1.01, 1.49, 7)
    eps = 1e-7
    fd = (s.position(ts + eps) - s.position(ts - eps)) / (2 * eps)
    np.testing.assert_allclose(s.velocity(ts), fd, atol=1e-5)


def test_spline_cpg_apex():
    cpg = SplineCpg(lift_time=0.0, lift_height=0.0, lift_velocity=0.2,
                    mid_height=0.1, touch_time=0.3, touch_height=0.0,
                    touch_velocity=-0.4)
    np.testing.assert_allclose(cpg.position(0.15), 0.1, atol=1e-12)
    np.testing.assert_allclose(cpg.velocity(0.15), 0.0, atol=1e-9)
    np.testing.assert_allclose(cpg.position(0.0), 0.0, atol=1e-12)
    np.testing.assert_allclose(cpg.position(0.3), 0.0, atol=1e-12)


def test_swing_planner_over_trot():
    planner = SwingTrajectoryPlanner(SwingConfig(), num_feet=4)
    # Schedules must start from a phase where each swing leg has a preceding
    # liftoff event (the reference asserts this too,
    # SwingTrajectoryPlanner.cpp checkThatIndicesAreValid).
    ms2 = ModeSchedule(event_times=[0.3, 0.65, 1.0],
                       mode_sequence=[15, 9, 6, 9])
    planner.update(ms2, terrain_height=0.0)
    # During (0.3, 0.65) mode 9: legs RF(1), LH(2) swing.
    apex_t = 0.5 * (0.3 + 0.65)
    s = swing_trajectory_scaling(0.3, 0.65, 0.15)
    assert s == 1.0
    np.testing.assert_allclose(planner.z_position(1, apex_t), 0.1, atol=1e-9)
    np.testing.assert_allclose(planner.z_velocity(1, apex_t), 0.0, atol=1e-9)
    # Stance legs stay at terrain height with zero velocity.
    np.testing.assert_allclose(planner.z_position(0, 0.45), 0.0, atol=1e-12)
    np.testing.assert_allclose(planner.z_velocity(0, 0.45), 0.0, atol=1e-12)
    # Short swing phases get scaled apex.
    ms3 = ModeSchedule(event_times=[0.1, 0.2], mode_sequence=[15, 9, 15])
    planner.update(ms3)
    s3 = swing_trajectory_scaling(0.1, 0.2, 0.15)
    assert s3 == pytest.approx(0.1 / 0.15)
    np.testing.assert_allclose(planner.z_position(1, 0.15), s3 * 0.1,
                               atol=1e-9)
    z_pos, z_vel = planner.sample_grid(t0=0.0, dt=0.05, horizon=5)
    assert z_pos.shape == (4, 5) and z_vel.shape == (4, 5)


def test_swing_planner_rejects_initial_swing_without_liftoff():
    ms = ModeSchedule(event_times=[0.5], mode_sequence=[9, 15])
    planner = SwingTrajectoryPlanner(SwingConfig(), num_feet=4)
    with pytest.raises(ValueError):
        planner.update(ms)
