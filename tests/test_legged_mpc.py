"""Legged-robot SQP MPC: physics sanity on standing + trot tasks.

Model-level test strategy mirrors the reference's (real config files, not
mocks — AnymalFactoryFunctions.cpp builds from the shipped task.info; here
the config is ingested from the same file).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cheeta_mpc.gait.schedule import ModeSchedule
from cheeta_mpc.gait.swing import SwingConfig, SwingTrajectoryPlanner
from cheeta_mpc.models.quadruped_kinematics import foot_positions_world
from cheeta_mpc.models.srbd_legged import (GRAVITY, SrbdParams,
                                           foot_velocity_constraint_values,
                                           srbd_step, unpack_srbd_state)
from cheeta_mpc.mpc.legged_mpc import (LeggedMpcConfig, LeggedSolution,
                                       build_legged_solver,
                                       make_standing_reference)
from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.solvers.scp import ScpSettings

TASK_INFO = "/root/reference/ocs2_legged_robot/config/mpc/task.info"

# Default joint configuration: legs slightly bent, feet under hips.
DEFAULT_JOINTS = np.array([0.0, 0.4, -0.8,  # LF
                           0.0, -0.4, 0.8,  # LH
                           0.0, 0.4, -0.8,  # RF
                           0.0, -0.4, 0.8])  # RH

CFG = LeggedMpcConfig.from_task_info(TASK_INFO, horizon=10,
                                     dtype=jnp.float64)
SCP = ScpSettings(iterations=3, ipm=IpmSettings(iters=12))


def standing_state():
    """Base height chosen so the default-joint feet touch z = 0."""
    feet_b = np.asarray(foot_positions_world(
        CFG.params.desc, jnp.zeros(3), jnp.zeros(3),
        jnp.asarray(DEFAULT_JOINTS)))
    height = -feet_b[:, 2].mean()
    x0 = np.zeros(24)
    x0[8] = height
    x0[12:] = DEFAULT_JOINTS
    return x0


@pytest.fixture(scope="module")
def standing_solution():
    x0 = standing_state()
    solve = jax.jit(build_legged_solver(CFG, SCP))
    x_ref = make_standing_reference(CFG, x0)
    N = CFG.horizon
    enable = np.ones((N, 4))
    zref = np.zeros((N, 4))
    sol = solve(jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(enable),
                jnp.asarray(zref), jnp.asarray(zref))
    return x0, sol


def test_config_ingested_from_task_info():
    assert CFG.params.dt == 0.015
    assert CFG.friction_mu == 0.5
    assert CFG.position_error_gain == 20.0
    assert len(CFG.q_diag) == 24 and len(CFG.r_diag) == 24


def test_standing_forces_share_weight(standing_solution):
    _, sol = standing_solution
    f = np.asarray(sol.forces)  # (N, 4, 3)
    mg = CFG.params.desc.mass * GRAVITY
    np.testing.assert_allclose(f[:, :, 2].sum(axis=1), mg, rtol=0.05)
    # Roughly equal share, small tangential forces.
    assert np.abs(f[:, :, 2] - mg / 4).max() < 0.25 * mg
    assert np.abs(f[:, :, :2]).max() < 0.3 * mg / 4


def test_standing_feet_pinned(standing_solution):
    """Stance zero-velocity equalities hold: feet don't move."""
    _, sol = standing_solution
    for k in [0, CFG.horizon // 2, CFG.horizon - 1]:
        v = np.asarray(foot_velocity_constraint_values(
            CFG.params, sol.x_traj[k], sol.u_traj[k]))
        assert np.abs(v).max() < 1e-4, f"foot velocity at node {k}: {v}"
    # Foot positions across the horizon stay fixed.
    feet = []
    for k in range(CFG.horizon + 1):
        _, _, pb, eul, q = unpack_srbd_state(sol.x_traj[k])
        feet.append(np.asarray(foot_positions_world(CFG.params.desc, pb, eul,
                                                    q)))
    feet = np.stack(feet)
    assert np.abs(feet - feet[0]).max() < 2e-3


def test_standing_base_stays(standing_solution):
    x0, sol = standing_solution
    x = np.asarray(sol.x_traj)
    assert np.abs(x[:, 8] - x0[8]).max() < 0.01  # height hold
    assert np.abs(x[:, 0:3]).max() < 0.05  # near-zero momentum
    assert np.abs(x[:, 9:12]).max() < 0.02  # level attitude


def test_standing_dynamics_feasible(standing_solution):
    _, sol = standing_solution
    for k in range(CFG.horizon):
        xn = srbd_step(CFG.params, sol.x_traj[k], sol.u_traj[k],
                       jnp.ones(4))
        np.testing.assert_allclose(np.asarray(xn),
                                   np.asarray(sol.x_traj[k + 1]), atol=1e-5)


def test_trot_swing_feet_track_reference():
    x0 = standing_state()
    N = CFG.horizon
    dt = CFG.params.dt
    # Gait: stance phase then LF+RH swing (mode 6 = RF_LH in contact).
    ms = ModeSchedule(event_times=[2 * dt, (N + 2) * dt],
                      mode_sequence=[15, 6, 15])
    planner = SwingTrajectoryPlanner(SwingConfig(), num_feet=4)
    planner.update(ms, terrain_height=0.0)
    z_pos, z_vel = planner.sample_grid(t0=0.5 * dt, dt=dt, horizon=N)
    enable = np.stack([
        np.asarray(ms.contact_flags_at((k + 0.5) * dt)) for k in range(N)])
    x_ref = make_standing_reference(CFG, x0)
    solve = jax.jit(build_legged_solver(CFG, SCP))
    sol = solve(jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(enable),
                jnp.asarray(z_pos.T)[..., :],
                jnp.asarray(z_vel.T))
    # During the swing phase, LF (leg 0) foot z should rise toward the
    # planner's reference.
    heights = []
    for k in range(N + 1):
        _, _, pb, eul, q = unpack_srbd_state(sol.x_traj[k])
        feet = np.asarray(foot_positions_world(CFG.params.desc, pb, eul, q))
        heights.append(feet[0, 2])
    heights = np.asarray(heights)
    apex_ref = z_pos[0].max()
    assert apex_ref > 0.02  # planner commands a real swing
    assert heights.max() > 0.5 * apex_ref, (
        f"LF foot never lifted: max {heights.max()} vs ref {apex_ref}")
    # Stance legs stay planted.
    feet0 = []
    for k in range(N + 1):
        _, _, pb, eul, q = unpack_srbd_state(sol.x_traj[k])
        feet0.append(np.asarray(foot_positions_world(CFG.params.desc, pb,
                                                     eul, q))[1])  # RF stance
    feet0 = np.stack(feet0)
    assert np.abs(feet0 - feet0[0]).max() < 5e-3
    # Swing-leg forces are exactly zero.
    f = np.asarray(sol.forces)
    for k in range(N):
        for i in range(4):
            if enable[k, i] == 0:
                np.testing.assert_allclose(f[k, i], 0.0, atol=1e-12)
