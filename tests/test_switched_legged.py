"""Event-aligned discretization wired into the legged solver.

The reference duplicates event nodes so mode switches land exactly between
two shooting nodes (timeDiscretizationWithEvents, TimeDiscretization.cpp:
36-114) and tests it on a mode-switched problem (testSwitchedProblem.cpp:
96-196: input correctness on both sides of the switch). Static shapes
replace node duplication with event *snapping* (discretize_fixed) +
per-interval contact flags + per-interval durations — this test asserts the
same observable behavior: the grid contains the event time exactly, the
contact flags flip exactly at that node, forces are zero from the first
post-switch interval on, and the uniform grid (by contrast) smears the
switch by up to dt/2.
"""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.gait.schedule import GaitSchedule, trot_template
from cheeta_mpc.mpc.legged_mpc import (LeggedMpcConfig,
                                       build_legged_solver,
                                       make_standing_reference)
from cheeta_mpc.models.quadruped_kinematics import foot_positions_world
from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.solvers.discretization import (discretize_fixed,
                                               interval_contact_flags)
from cheeta_mpc.solvers.scp import ScpSettings

TASK_INFO = "/root/reference/ocs2_legged_robot/config/mpc/task.info"
DEFAULT_JOINTS = np.array([0., 0.4, -0.8, 0., -0.4, 0.8,
                           0., 0.4, -0.8, 0., -0.4, 0.8])
CFG = LeggedMpcConfig.from_task_info(TASK_INFO, horizon=10,
                                     dtype=jnp.float64)
N, DT = CFG.horizon, CFG.params.dt


def standing_state():
    feet_b = np.asarray(foot_positions_world(
        CFG.params.desc, jnp.zeros(3), jnp.zeros(3),
        jnp.asarray(DEFAULT_JOINTS)))
    x0 = np.zeros(24)
    x0[8] = -feet_b[:, 2].mean()
    x0[12:] = DEFAULT_JOINTS
    return x0


def _switched_schedule(t_event):
    """Stance until t_event, then trot (an off-grid gait switch)."""
    gs = GaitSchedule.stance(trot_template(0.6), t0=0.0)
    gs.phase_transition_stance_time = 0.0
    gs.insert_template(trot_template(0.6), insert_time=t_event)
    return gs.get_mode_schedule(0.0, 2.0)


def test_grid_snaps_to_event():
    t_event = 0.5 * DT + 3 * DT  # deliberately mid-interval on uniform grid
    ms = _switched_schedule(t_event)
    times = discretize_fixed(0.0, N * DT, N + 1, ms.event_times)
    assert np.any(np.abs(times - t_event) < 1e-12), (
        f"event {t_event} not on grid {times}")
    flags = interval_contact_flags(times, ms)
    k = int(np.argmin(np.abs(times - t_event)))
    # All-stance before the event node, trot pattern from it on.
    assert (flags[:k] == 1.0).all()
    assert (flags[k:].sum(axis=1) == 2.0).all()
    # Grid spacing remains bounded (snapping, not degenerate collapse).
    d = np.diff(times)
    assert d.min() > 0.3 * DT and d.max() < 1.7 * DT


def test_switched_solve_forces_flip_at_event():
    """Forces of the legs leaving contact are exactly zero from the first
    post-event interval (the reference's 'input correct on both sides of
    the switch', testSwitchedProblem.cpp:155-196)."""
    t_event = 3.5 * DT
    ms = _switched_schedule(t_event)
    times = discretize_fixed(0.0, N * DT, N + 1, ms.event_times)
    flags = interval_contact_flags(times, ms)
    dts = np.diff(times)

    solve = jax.jit(build_legged_solver(
        CFG, ScpSettings(iterations=2, ipm=IpmSettings(iters=10))))
    x0 = standing_state()
    x_ref = make_standing_reference(CFG, x0)
    zp = np.zeros((N, 4))
    zv = np.zeros((N, 4))
    sol = solve(x0, x_ref, flags, zp, zv, dts=jnp.asarray(dts))
    forces = np.asarray(sol.forces)
    assert np.isfinite(forces).all()
    k = int(np.argmin(np.abs(times - t_event)))
    swing = np.where(flags[k] == 0.0)[0]
    # Zero force on swing legs from the event node; positive before it.
    np.testing.assert_allclose(forces[k:, swing, :], 0.0, atol=1e-12)
    assert (forces[:k, swing, 2] > 1.0).all()
    # Dynamics defects stay tight across the variable-dt grid.
    from cheeta_mpc.models.srbd_legged import srbd_step
    for i in range(N):
        xn = srbd_step(CFG.params, jnp.asarray(sol.x_traj[i]),
                       jnp.asarray(sol.u_traj[i]), jnp.asarray(flags[i]),
                       float(dts[i]))
        np.testing.assert_allclose(np.asarray(xn),
                                   np.asarray(sol.x_traj[i + 1]), atol=1e-5)


def test_uniform_grid_smears_switch():
    """Contrast case: on the plain uniform grid the same event lands
    mid-interval, so the midpoint-sampled flags flip one half-interval
    early/late — the timing error the event-aligned grid removes."""
    t_event = 3.5 * DT
    ms = _switched_schedule(t_event)
    times_u = np.arange(N + 1) * DT
    flags_u = interval_contact_flags(times_u, ms)
    times_e = discretize_fixed(0.0, N * DT, N + 1, ms.event_times)
    flags_e = interval_contact_flags(times_e, ms)
    # The uniform grid has no node at the event; the aligned grid does.
    assert not np.any(np.abs(times_u - t_event) < 1e-9)
    assert np.any(np.abs(times_e - t_event) < 1e-12)
    # Total stance time differs between the two samplings (the smear).
    stance_u = (flags_u.sum(axis=1) * np.diff(times_u)).sum()
    stance_e = (flags_e.sum(axis=1) * np.diff(times_e)).sum()
    assert abs(stance_u - stance_e) > 1e-3
