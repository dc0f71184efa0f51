"""Legged-robot demo node: closed-loop walking with metrics + viz capture.

The application-node equivalent of the reference's LeggedRobotSqpMpcNode /
LeggedRobotDdpMpcNode + LeggedRobotDummyNode + LeggedRobotVisualizer +
MultiplotRemap (SURVEY.md §2.7): runs the MPC/MRT loop in deterministic
lock-step with plant == model, streams per-solve PerformanceIndex metrics as
JSONL (the reference republishes PerformanceIndex for rqt_multiplot), and
saves the trajectory + footholds + GRFs to an .npz for plotting.

The MPC grid is event-aligned (solvers/discretization.discretize_fixed — the
reference's timeDiscretizationWithEvents role), so gait switches land exactly
on shooting nodes.

Usage:
    python -m cheeta_mpc.cli.legged_demo [--seconds 1.5] [--vx 0.25]
        [--out /tmp/legged_demo] [--gait trot] [--solver sqp|ddp]
        [--cone soft|pyramid]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--vx", type=float, default=0.25)
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--solver", choices=("sqp", "ddp"), default="sqp",
                    help="sqp = LeggedRobotSqpMpcNode role; "
                         "ddp = LeggedRobotDdpMpcNode role")
    ap.add_argument("--cone", choices=("soft", "pyramid"), default="soft",
                    help="friction treatment (soft = reference task.info)")
    ap.add_argument("--out", default="/tmp/legged_demo")
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="render the run to a PNG (feet/CoM/CoP/support "
                         "polygon, per-leg forces, height, attitude — the "
                         "LeggedRobotVisualizer rviz role, headless)")
    ap.add_argument("--task-info", default=
                    "/root/reference/ocs2_legged_robot/config/mpc/task.info")
    ap.add_argument("--gait-info", default=
                    "/root/reference/ocs2_legged_robot/config/command/gait.info")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from cheeta_mpc.gait.schedule import GaitSchedule
    from cheeta_mpc.gait.swing import SwingConfig, SwingTrajectoryPlanner
    from cheeta_mpc.models.quadruped_kinematics import \
        foot_positions_world
    from cheeta_mpc.models.srbd_legged import srbd_step
    from cheeta_mpc.mpc.legged_mpc import (LeggedMpcConfig,
                                           build_legged_solver,
                                           make_velocity_command_reference)
    from cheeta_mpc.mpc.runtime import (MpcMrtInterface, PolicyData,
                                        SystemObservation, run_dummy_loop)
    from cheeta_mpc.ops.ocpqp import IpmSettings
    from cheeta_mpc.solvers.discretization import (discretize_fixed,
                                                   interval_contact_flags)
    from cheeta_mpc.solvers.scp import ScpSettings
    from cheeta_mpc.utils.info_config import load_gait_library
    from cheeta_mpc.utils.timing import Benchmarker

    cfg = LeggedMpcConfig.from_task_info(args.task_info,
                                         horizon=args.horizon,
                                         cone_mode=args.cone,
                                         dtype=jnp.float32)
    N, DT = cfg.horizon, cfg.params.dt
    default_joints = np.array([0., 0.4, -0.8, 0., -0.4, 0.8,
                               0., 0.4, -0.8, 0., -0.4, 0.8])
    feet_b = np.asarray(foot_positions_world(
        cfg.params.desc, jnp.zeros(3), jnp.zeros(3),
        jnp.asarray(default_joints)))
    x0 = np.zeros(24)
    x0[8] = -feet_b[:, 2].mean()
    x0[12:] = default_joints

    library = load_gait_library(args.gait_info)
    template = library[args.gait]
    gs = GaitSchedule.stance(template, t0=0.0)
    gs.phase_transition_stance_time = 0.1
    gs.insert_template(template, insert_time=0.2)
    ms = gs.get_mode_schedule(0.0, args.seconds + 2.0)
    planner = SwingTrajectoryPlanner(SwingConfig(), num_feet=4)
    planner.update(ms, terrain_height=0.0)

    if args.solver == "sqp":
        solve = jax.jit(build_legged_solver(
            cfg, ScpSettings(iterations=2, ipm=IpmSettings(iters=10))))
    else:
        from cheeta_mpc.mpc.legged_ddp import build_legged_ddp_solver
        from cheeta_mpc.solvers.ddp import DdpSettings
        # Configured from the task.info ddp block (reference
        # LeggedRobotDdpMpcNode), with a deeper iteration budget than the
        # file's RTI setting for the from-scratch demo.
        ddp = DdpSettings.from_task_info(args.task_info, iterations=5)
        solve = jax.jit(build_legged_ddp_solver(
            cfg, ddp, eq_penalty=max(ddp.constraint_penalty, 100.0)))
    bench = Benchmarker()
    metrics_path = f"{args.out}_metrics.jsonl"
    metrics_f = open(metrics_path, "w")
    v_cmd = np.array([args.vx, 0.0, 0.0])
    prev_policy = [None]

    def solve_fn(obs: SystemObservation) -> PolicyData:
        from cheeta_mpc.mpc.runtime import shift_warm_start
        t, x = obs.time, obs.state
        x_ref = make_velocity_command_reference(cfg, x, v_cmd,
                                                com_height=x0[8])
        # Event-aligned shooting grid: gait switches land on nodes.
        times = discretize_fixed(t, t + N * DT, N + 1, ms.event_times)
        enable = interval_contact_flags(times, ms)
        dts = np.diff(times)
        mids = 0.5 * (times[:-1] + times[1:])
        z_pos, z_vel = planner.sample_times(mids)  # (4, N) each
        z_pos, z_vel = z_pos.T, z_vel.T
        warm = None
        if args.solver == "sqp" and prev_policy[0] is not None:
            # Reference warm start: previous primal interpolated onto the
            # shifted grid (MultipleShootingSolver.cpp:229-265).
            xw, uw = shift_warm_start(prev_policy[0], times)
            warm = (jnp.asarray(xw, jnp.float32),
                    jnp.asarray(uw, jnp.float32))
        with bench.phase("mpc_solve"):
            kw = {"warm": warm} if args.solver == "sqp" else {}
            sol = solve(jnp.asarray(x, jnp.float32),
                        jnp.asarray(x_ref, jnp.float32),
                        jnp.asarray(enable, jnp.float32),
                        jnp.asarray(z_pos, jnp.float32),
                        jnp.asarray(z_vel, jnp.float32),
                        dts=jnp.asarray(dts, jnp.float32), **kw)
            jax.block_until_ready(sol.u_traj)
        bench.record_solve_ms(bench.phase("mpc_solve").latest_ms)
        # PerformanceIndex stream (MultiplotRemap analogue).
        entry = {"t": round(t, 4),
                 "solve_ms": round(bench.phase("mpc_solve").latest_ms, 3)}
        if args.solver == "sqp":
            perf = sol.performance
            entry.update({
                "merit": float(sol.merit), "qp_mu": float(sol.qp_mu),
                "cost": float(perf.cost),
                "dyn_sse": float(perf.dyn_violation_sse),
                "eq_sse": float(perf.eq_constraint_sse),
                "ineq_sse": float(perf.ineq_constraint_sse),
                "convergence": int(sol.convergence)})
            P = np.asarray(sol.gains_P, np.float64)
            pv = np.asarray(sol.gains_p, np.float64)
        else:
            entry.update({"cost": float(sol.cost)})
            P = pv = None
        metrics_f.write(json.dumps(entry) + "\n")
        pol = PolicyData(times=times,
                         x_traj=np.asarray(sol.x_traj, np.float64),
                         u_traj=np.asarray(sol.u_traj, np.float64),
                         K=np.asarray(sol.gains_K, np.float64),
                         P=P, p=pv)
        prev_policy[0] = pol
        return pol

    def plant_step(t, x, u):
        e = np.asarray(ms.contact_flags_at(t + 0.5 * DT))
        return np.asarray(srbd_step(cfg.params, jnp.asarray(x, jnp.float32),
                                    jnp.asarray(u, jnp.float32),
                                    jnp.asarray(e, jnp.float32)), np.float64)

    n_steps = int(round(args.seconds / DT))
    t_wall = time.perf_counter()
    res = run_dummy_loop(MpcMrtInterface(solve_fn), plant_step, x0=x0,
                         mrt_dt=DT, mpc_update_ratio=2, n_steps=n_steps)
    wall = time.perf_counter() - t_wall
    metrics_f.close()

    xs = res.states
    feet = np.stack([np.asarray(foot_positions_world(
        cfg.params.desc, jnp.asarray(x[6:9]), jnp.asarray(x[9:12]),
        jnp.asarray(x[12:]))) for x in xs])
    forces = res.inputs[:, :12].reshape(-1, 4, 3)
    np.savez(f"{args.out}_traj.npz", times=res.times, states=xs, feet=feet,
             forces=forces)

    # Real-time delay guard (reference MPC_MRT_Interface.cpp:98-104).
    budget_ms = 1e3 * DT * 2  # planning period
    avg = bench.phase("mpc_solve").avg_ms
    rt_ok = avg < budget_ms
    print(f"simulated {n_steps * DT:.2f} s in {wall:.1f} s wall "
          f"({res.solves} solves, {args.solver} solver, {args.cone} cone)")
    print(f"  forward progress: {xs[-1, 6] - x0[6]:+.3f} m at "
          f"cmd {args.vx} m/s; height drift "
          f"{np.abs(xs[:, 8] - x0[8]).max():.3f} m")
    print(f"  solve: {bench.report()}")
    print(f"  realtime budget {budget_ms:.0f} ms/solve: "
          f"{'OK' if rt_ok else 'EXCEEDED'} (avg {avg:.1f} ms)"
          + ("" if rt_ok else "  [reference delay-guard warning]"))
    print(f"  wrote {args.out}_traj.npz, {metrics_path}")
    if args.plot:
        from cheeta_mpc.viz.render import render_run
        render_run(f"{args.out}_traj.npz", args.plot,
                   title=f"legged {args.solver} ({args.cone} cone), "
                         f"vx={args.vx} m/s")
        print(f"  wrote {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
