"""GaitReceiver: live gait switching against a *running* MPC loop (round-1
VERDICT component #67: insert-at-finalTime semantics untested live).

Mirrors the reference's flow (GaitKeyboardPublisher -> GaitReceiver
-> preSolverRun insert at finalTime -> SwitchedModelReferenceManager
regenerates the schedule): the robot starts standing, a trot command arrives
mid-run, the receiver applies it at the commanding solve's finalTime, and
the closed loop transitions to trot without falling."""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.gait.receiver import GaitReceiver
from cheeta_mpc.gait.schedule import (GaitSchedule, stance_template,
                                      trot_template)
from cheeta_mpc.gait.swing import SwingConfig, SwingTrajectoryPlanner
from cheeta_mpc.models.quadruped_kinematics import foot_positions_world
from cheeta_mpc.models.srbd_legged import srbd_step
from cheeta_mpc.mpc.legged_mpc import (LeggedMpcConfig,
                                       build_legged_solver,
                                       make_velocity_command_reference)
from cheeta_mpc.mpc.runtime import (MpcMrtInterface, PolicyData,
                                    SystemObservation)
from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.solvers.scp import ScpSettings

TASK_INFO = "/root/reference/ocs2_legged_robot/config/mpc/task.info"
DEFAULT_JOINTS = np.array([0., 0.4, -0.8, 0., -0.4, 0.8,
                           0., 0.4, -0.8, 0., -0.4, 0.8])
CFG = LeggedMpcConfig.from_task_info(TASK_INFO, horizon=10,
                                     dtype=jnp.float64)
N, DT = CFG.horizon, CFG.params.dt


def test_receiver_applies_at_final_time():
    gs = GaitSchedule.stance(trot_template(0.6), t0=0.0)
    gs.phase_transition_stance_time = 0.0
    rec = GaitReceiver(gs)
    # No command: nothing applied.
    assert not rec.pre_solver_run(0.0, 1.0)
    rec.on_command("trot", trot_template(0.6))
    assert rec.pre_solver_run(0.3, 1.3)
    assert rec.applied == [("trot", 1.3)]
    ms = gs.get_mode_schedule(0.0, 3.0)
    # Full stance strictly before the insert time; trot phases after.
    assert ms.contact_flags_at(1.29).sum() == 4
    assert ms.contact_flags_at(1.4).sum() == 2


def test_live_gait_switch_in_running_loop():
    solve = jax.jit(build_legged_solver(
        CFG, ScpSettings(iterations=2, ipm=IpmSettings(iters=10))))

    gs = GaitSchedule.stance(trot_template(0.6), t0=0.0)
    gs.phase_transition_stance_time = 0.0
    rec = GaitReceiver(gs)
    planner = SwingTrajectoryPlanner(SwingConfig(), num_feet=4)

    feet_b = np.asarray(foot_positions_world(
        CFG.params.desc, jnp.zeros(3), jnp.zeros(3),
        jnp.asarray(DEFAULT_JOINTS)))
    x0 = np.zeros(24)
    x0[8] = -feet_b[:, 2].mean()
    x0[12:] = DEFAULT_JOINTS
    v_cmd = np.array([0.2, 0.0, 0.0])
    horizon_s = N * DT

    state = {"ms": gs.get_mode_schedule(0.0, 3.0)}
    planner.update(state["ms"], terrain_height=0.0)

    def solve_fn(obs: SystemObservation) -> PolicyData:
        t, x = obs.time, obs.state
        # Solver-synchronized hook: apply buffered gait commands at
        # finalTime, then regenerate schedule + swing plans (the reference's
        # preSolverRun -> modifyReferences flow).
        if rec.pre_solver_run(t, t + horizon_s):
            state["ms"] = gs.get_mode_schedule(0.0, 3.0)
            planner.update(state["ms"], terrain_height=0.0)
        ms = state["ms"]
        x_ref = make_velocity_command_reference(CFG, x, v_cmd,
                                                com_height=x0[8])
        enable = np.stack([np.asarray(ms.contact_flags_at(t + (k + 0.5) * DT))
                           for k in range(N)])
        z_pos, z_vel = planner.sample_grid(t0=t + 0.5 * DT, dt=DT, horizon=N)
        sol = solve(jnp.asarray(x), jnp.asarray(x_ref), jnp.asarray(enable),
                    jnp.asarray(z_pos.T), jnp.asarray(z_vel.T))
        return PolicyData(times=t + DT * np.arange(N + 1),
                          x_traj=np.asarray(sol.x_traj),
                          u_traj=np.asarray(sol.u_traj),
                          K=np.asarray(sol.gains_K))

    def plant_step(t, x, u):
        e = np.asarray(state["ms"].contact_flags_at(t + 0.5 * DT))
        return np.asarray(srbd_step(CFG.params, jnp.asarray(x),
                                    jnp.asarray(u), jnp.asarray(e)))

    iface = MpcMrtInterface(solve_fn)
    t, x = 0.0, x0.copy()
    iface.set_current_observation(SystemObservation(time=t, state=x))
    iface.advance_mpc()
    assert iface.update_policy()
    switch_tick = 10
    n_steps = 70
    for step in range(n_steps):
        if step == switch_tick:
            rec.on_command("trot", trot_template(0.6))  # async command
        if step > 0 and step % 2 == 0:
            iface.set_current_observation(SystemObservation(time=t, state=x))
            iface.advance_mpc()
            iface.update_policy()
        u = iface.evaluate_policy(t, x)
        x = plant_step(t, x, u)
        t += DT

    # The command was applied exactly once, at a solve's finalTime.
    assert len(rec.applied) == 1
    name, t_insert = rec.applied[0]
    assert name == "trot"
    # Insert time = (solve time) + horizon: beyond the then-current horizon.
    assert t_insert >= switch_tick * DT + horizon_s - 1e-9
    # The schedule actually switched: stance before, trot after.
    ms = state["ms"]
    assert ms.contact_flags_at(t_insert - 1e-3).sum() == 4
    assert ms.contact_flags_at(t_insert + 0.2).sum() == 2
    # And the robot is still upright after trotting.
    assert np.isfinite(x).all()
    assert abs(x[8] - x0[8]) < 0.08
    assert np.abs(x[10:12]).max() < 0.25
