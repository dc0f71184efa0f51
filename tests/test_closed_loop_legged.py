"""Closed-loop legged MPC in the deterministic lock-step dummy loop.

The reference's integration harness is MRT_ROS_Dummy_Loop in synchronized
mode with plant == model (MRT_ROS_Dummy_Loop.cpp:76-129,171-185; SURVEY.md §4
calls out this determinism trick as the thing to keep for CI). Here: the
legged SQP MPC plans at 1/mpc_update_ratio of the control rate; between
plans, the MRT layer evaluates the buffered policy (feedforward +
interpolation); the plant integrates the same SRBD model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cheeta_mpc.gait.schedule import GaitSchedule, ModeSchedule, trot_template
from cheeta_mpc.gait.swing import SwingConfig, SwingTrajectoryPlanner
from cheeta_mpc.models.quadruped_kinematics import foot_positions_world
from cheeta_mpc.models.srbd_legged import srbd_step, unpack_srbd_state
from cheeta_mpc.mpc.legged_mpc import (LeggedMpcConfig,
                                       build_legged_solver,
                                       make_velocity_command_reference)
from cheeta_mpc.mpc.runtime import (MpcMrtInterface, PolicyData,
                                    SystemObservation, run_dummy_loop)
from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.solvers.scp import ScpSettings

TASK_INFO = "/root/reference/ocs2_legged_robot/config/mpc/task.info"
DEFAULT_JOINTS = np.array([0., 0.4, -0.8, 0., -0.4, 0.8,
                           0., 0.4, -0.8, 0., -0.4, 0.8])

CFG = LeggedMpcConfig.from_task_info(TASK_INFO, horizon=10, dtype=jnp.float64)
N = CFG.horizon
DT = CFG.params.dt


def standing_state():
    feet_b = np.asarray(foot_positions_world(
        CFG.params.desc, jnp.zeros(3), jnp.zeros(3),
        jnp.asarray(DEFAULT_JOINTS)))
    x0 = np.zeros(24)
    x0[8] = -feet_b[:, 2].mean()
    x0[12:] = DEFAULT_JOINTS
    return x0


def test_closed_loop_stand_then_walk():
    solve = jax.jit(build_legged_solver(
        CFG, ScpSettings(iterations=2, ipm=IpmSettings(iters=10))))

    # Gait: stance for 0.2 s, then trot.
    gs = GaitSchedule.stance(trot_template(0.6), t0=0.0)
    gs.phase_transition_stance_time = 0.1
    gs.insert_template(trot_template(0.6), insert_time=0.2)
    ms = gs.get_mode_schedule(0.0, 3.0)
    planner = SwingTrajectoryPlanner(SwingConfig(), num_feet=4)
    planner.update(ms, terrain_height=0.0)

    v_cmd = np.array([0.25, 0.0, 0.0])

    def solve_fn(obs: SystemObservation) -> PolicyData:
        t = obs.time
        x = obs.state
        x_ref = make_velocity_command_reference(CFG, x, v_cmd,
                                                com_height=standing_state()[8])
        enable = np.stack([np.asarray(ms.contact_flags_at(t + (k + 0.5) * DT))
                           for k in range(N)])
        z_pos, z_vel = planner.sample_grid(t0=t + 0.5 * DT, dt=DT, horizon=N)
        sol = solve(jnp.asarray(x), jnp.asarray(x_ref), jnp.asarray(enable),
                    jnp.asarray(z_pos.T), jnp.asarray(z_vel.T))
        times = t + DT * np.arange(N + 1)
        return PolicyData(times=times, x_traj=np.asarray(sol.x_traj),
                          u_traj=np.asarray(sol.u_traj),
                          K=np.asarray(sol.gains_K))

    def plant_step(t, x, u):
        enable = np.asarray(ms.contact_flags_at(t + 0.5 * DT))
        return np.asarray(srbd_step(CFG.params, jnp.asarray(x),
                                    jnp.asarray(u), jnp.asarray(enable)))

    iface = MpcMrtInterface(solve_fn)
    x0 = standing_state()
    n_steps = 60  # 0.9 s of sim: stance + ~1 full trot cycle
    res = run_dummy_loop(iface, plant_step, x0=x0, mrt_dt=DT,
                         mpc_update_ratio=2, n_steps=n_steps,
                         use_feedback=True)

    xs = res.states
    assert np.isfinite(xs).all()
    # The robot stays upright (attitude and height within bounds).
    assert np.abs(xs[:, 10:12]).max() < 0.25, "robot tipped over"
    assert np.abs(xs[:, 8] - x0[8]).max() < 0.08, "height lost"
    # After the stance phase it makes forward progress.
    t_end = n_steps * DT
    progress = xs[-1, 6] - x0[6]
    assert progress > 0.3 * v_cmd[0] * (t_end - 0.2), (
        f"no forward progress: {progress:.3f} m in {t_end:.2f} s")
    # Deterministic re-run.
    iface2 = MpcMrtInterface(solve_fn)
    res2 = run_dummy_loop(iface2, plant_step, x0=x0, mrt_dt=DT,
                          mpc_update_ratio=2, n_steps=n_steps,
                          use_feedback=True)
    np.testing.assert_array_equal(res.states, res2.states)
