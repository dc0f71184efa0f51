"""Multi-process launch orchestration: the reference's roslaunch topology.

The reference deploys as separate OS processes wired by ROS topics
(`ocs2_legged_robot_ros/launch/legged_robot_sqp.launch`: the
`legged_robot_sqp_mpc` planning node, the `legged_robot_dummy` tracking/
plant node, plus `legged_robot_target` and `legged_robot_gait_command`
command terminals). This launcher reproduces that topology with REAL
processes over the POSIX shared-memory bus (`native/shm_bus.cpp`):

    python -m cheeta_mpc.cli.launch --seconds 1.0 --gait trot

spawns
  - an MPC process (`--role mpc`): LeggedPlannerAssembly behind an MpcNode —
    the LeggedRobotSqpMpcNode / LeggedRobotDdpMpcNode role;
  - a dummy/MRT process (`--role dummy`): plant == model forward simulation
    through MrtNode in synchronized lock-step — the LeggedRobotDummyNode +
    MRT_ROS_Dummy_Loop role (MRT_ROS_Dummy_Loop.cpp:76-129). It runs on the
    CPU backend, so one accelerator card is opened by one process only;

and any process may attach to the same bus and publish gait/target commands
(`transport.mpc_mrt.CommandClient` — the command-terminal roles). The
`--switch-gait NAME@T` flag has the dummy publish a live gait command
mid-run, exercising the full cross-process solver-synchronized path.

Topic-name contract: every process constructs the bus with
`transport.mpc_mrt.TOPICS` (like ROS topic names agreed by convention).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

DEFAULT_TASK_INFO = "/root/reference/ocs2_legged_robot/config/mpc/task.info"
DEFAULT_GAIT_INFO = \
    "/root/reference/ocs2_legged_robot/config/command/gait.info"


def _add_shared_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--bus", default=None,
                    help="shared-memory segment name (default: generated)")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--vx", type=float, default=0.25)
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--solver", choices=("sqp", "ddp"), default="sqp")
    ap.add_argument("--cone", choices=("soft", "pyramid"), default="soft")
    ap.add_argument("--mpc-update-ratio", type=int, default=2,
                    help="MRT ticks per MPC solve (reference mpcUpdateRatio)")
    ap.add_argument("--switch-gait", default=None, metavar="NAME@T",
                    help="publish a live gait command at sim time T")
    ap.add_argument("--out", default="/tmp/cheeta_launch")
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="render the dummy-side run to a PNG (LeggedRobotVisualizer role)")
    ap.add_argument("--task-info", default=DEFAULT_TASK_INFO)
    ap.add_argument("--gait-info", default=DEFAULT_GAIT_INFO)
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu) in every process")
    ap.add_argument("--f64", action="store_true",
                    help="solve in float64 (CPU oracle runs)")


def _setup_jax(args, platform=None):
    """``platform`` (else ``--platform``) pins the jax backend."""
    import jax

    from cheeta_mpc.utils.compile_cache import enable_compile_cache
    platform = platform or args.platform
    if platform:
        jax.config.update("jax_platforms", platform)
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    # Persistent compile cache: node processes are short-lived relative to
    # a cold XLA compile of the legged solver, so warm launches matter.
    enable_compile_cache(min_compile_time_secs=1.0)
    return jax


def _build_config(args):
    import jax.numpy as jnp

    from cheeta_mpc.mpc.legged_mpc import LeggedMpcConfig
    return LeggedMpcConfig.from_task_info(
        args.task_info, horizon=args.horizon, cone_mode=args.cone,
        dtype=jnp.float64 if args.f64 else jnp.float32)


def _gait_schedule(args):
    from cheeta_mpc.gait.schedule import GaitSchedule
    from cheeta_mpc.utils.info_config import load_gait_library
    library = load_gait_library(args.gait_info)
    template = library[args.gait]
    gs = GaitSchedule.stance(template, t0=0.0)
    gs.phase_transition_stance_time = 0.1
    gs.insert_template(template, insert_time=0.2)
    return gs, library


def run_mpc(args) -> int:
    """The planning process (LeggedRobotSqpMpcNode.cpp:42-78 role)."""
    _setup_jax(args)
    from cheeta_mpc.mpc.legged_node import (LeggedPlannerAssembly,
                                            PlannerSettings,
                                            default_stance_state)
    from cheeta_mpc.transport.mpc_mrt import TOPICS, MpcNode
    from cheeta_mpc.transport.shm import ShmMessageBus

    cfg = _build_config(args)
    gs, _ = _gait_schedule(args)
    x0 = default_stance_state(cfg)
    assembly = LeggedPlannerAssembly(
        cfg, gs, x0, v_cmd=np.array([args.vx, 0.0, 0.0]),
        settings=PlannerSettings(solver=args.solver))
    bus = ShmMessageBus(TOPICS, args.bus)
    node = MpcNode(bus, assembly.solve_fn,
                   on_gait_command=assembly.on_gait_command,
                   on_target_command=assembly.set_velocity_command)
    node.launch()
    print(f"[mpc] node up ({args.solver}, {args.cone} cone, "
          f"N={args.horizon})", flush=True)
    # Serve until the launcher tears us down (SIGTERM), like a ROS node.
    try:
        while True:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        node.shutdown()
        bus.close()
    return 0


def run_dummy(args) -> int:
    """The tracking/plant process (LeggedRobotDummyNode.cpp:43-89 +
    MRT_ROS_Dummy_Loop synchronized mode, MRT_ROS_Dummy_Loop.cpp:76-129):
    plant == model, lock-step with the MPC across the process boundary.
    Runs on the CPU backend, so only the planner process opens the
    accelerator."""
    _setup_jax(args, platform="cpu")
    import jax.numpy as jnp

    from cheeta_mpc.mpc.legged_node import default_stance_state
    from cheeta_mpc.models.srbd_legged import srbd_step
    from cheeta_mpc.mpc.runtime import SystemObservation
    from cheeta_mpc.transport.mpc_mrt import (TOPICS, CommandClient,
                                              MrtNode)
    from cheeta_mpc.transport.shm import ShmMessageBus

    cfg = _build_config(args)
    gs, library = _gait_schedule(args)
    x0 = default_stance_state(cfg)
    N, DT = cfg.horizon, float(cfg.params.dt)
    horizon_s = N * DT
    ratio = args.mpc_update_ratio

    switch_name, switch_t = None, None
    if args.switch_gait:
        switch_name, t_str = args.switch_gait.rsplit("@", 1)
        switch_t = float(t_str)
        if switch_name not in library:
            print(f"[dummy] unknown gait {switch_name!r}", file=sys.stderr)
            return 2

    bus = ShmMessageBus(TOPICS, args.bus)
    mrt = MrtNode(bus)
    commands = CommandClient(bus)
    if not mrt.reset_mpc(timeout_s=20.0):
        print("[dummy] MPC reset handshake failed", file=sys.stderr)
        return 3
    obs = SystemObservation(time=0.0, state=x0.copy(), input=None, mode=0)
    if not mrt.wait_for_initial_policy(obs, timeout_s=300.0):
        print("[dummy] no initial policy", file=sys.stderr)
        return 4
    print("[dummy] initial policy received", flush=True)

    def plant_step(t, x, u):
        e = np.asarray(gs.get_mode_schedule(
            max(0.0, t - 1.0), t + 1.0).contact_flags_at(t + 0.5 * DT))
        return np.asarray(srbd_step(cfg.params, jnp.asarray(x, cfg.dtype),
                                    jnp.asarray(u, cfg.dtype),
                                    jnp.asarray(e, cfg.dtype)), np.float64)

    n_steps = int(round(args.seconds / DT))
    t, x = 0.0, x0.copy()
    states = [x.copy()]
    inputs = []
    times = [0.0]
    switched_at = None
    t_wall = time.perf_counter()
    for step in range(n_steps):
        if step > 0 and step % ratio == 0:
            # Live gait command: published BEFORE the observation so the
            # MPC applies it at THIS solve's finalTime = t + horizon — a
            # deterministic time the plant schedule can mirror exactly
            # (reference GaitReceiver preSolverRun insert-at-finalTime).
            if switch_t is not None and t >= switch_t:
                commands.publish_gait(switch_name, library[switch_name])
                gs.insert_template(library[switch_name],
                                   insert_time=t + horizon_s)
                switched_at = t + horizon_s
                switch_t = None
            mrt.set_current_observation(
                SystemObservation(time=t, state=x, input=None, mode=0))
            # Synchronized mode: block for the fresh policy (the reference
            # busy-waits for a policy matching the current time,
            # MRT_ROS_Dummy_Loop.cpp:96-118).
            seq = mrt._bus.wait_for("mpc_policy", mrt._last_policy_seq,
                                    timeout_s=30.0)
            if seq <= mrt._last_policy_seq:
                print(f"[dummy] no policy for t={t:.3f}", file=sys.stderr)
                return 5
            mrt.spin_once()
            mrt.update_policy()
        u = mrt.evaluate_policy(t, x)
        x = plant_step(t, x, u)
        t += DT
        states.append(x.copy())
        inputs.append(np.asarray(u, np.float64).copy())
        times.append(t)
    wall = time.perf_counter() - t_wall

    xs = np.asarray(states)
    summary = {
        "sim_seconds": round(n_steps * DT, 4),
        "wall_seconds": round(wall, 2),
        "mrt_ticks": n_steps,
        "solves": int(mrt._last_policy_seq),
        "forward_m": round(float(xs[-1, 6] - x0[6]), 4),
        "height_drift_m": round(float(np.abs(xs[:, 8] - x0[8]).max()), 4),
        "finite": bool(np.isfinite(xs).all()),
        "switched_at": switched_at,
        "trylock_failures": mrt.trylock_failures,
    }
    us = np.asarray(inputs)
    np.savez(f"{args.out}_traj.npz", times=np.asarray(times), states=xs,
             inputs=us)
    if getattr(args, "plot", None):
        # Rendered visualization (LeggedRobotVisualizer role): derive feet
        # by FK and forces from the applied inputs, then draw the PNG.
        import jax.numpy as jnp

        from cheeta_mpc.models.quadruped_kinematics import \
            foot_positions_world
        from cheeta_mpc.viz.render import render_run
        feet = np.stack([np.asarray(foot_positions_world(
            cfg.params.desc, jnp.asarray(s[6:9]), jnp.asarray(s[9:12]),
            jnp.asarray(s[12:]))) for s in xs[1:]])
        # align on post-step samples: inputs are one shorter than states
        np.savez(f"{args.out}_viz.npz", times=np.asarray(times[1:]),
                 states=xs[1:], feet=feet,
                 forces=us[:, :12].reshape(-1, 4, 3))
        render_run(f"{args.out}_viz.npz", args.plot,
                   title=f"launch topology run ({args.solver})")
        print(f"[dummy] wrote {args.plot}", flush=True)
    with open(f"{args.out}_summary.json", "w") as f:
        json.dump(summary, f)
    print("[dummy] " + json.dumps(summary), flush=True)
    bus.close()
    return 0


def run_launch(args, extra_argv) -> int:
    """The roslaunch role: create the bus, spawn the node processes, wait."""
    from cheeta_mpc.transport.mpc_mrt import TOPICS
    from cheeta_mpc.transport.shm import ShmMessageBus

    name = args.bus or f"/cheeta_launch_{os.getpid()}"
    bus = ShmMessageBus(TOPICS, name, create=True)
    child_argv = [a for a in extra_argv if a not in ("--role",)]
    base = [sys.executable, "-m", "cheeta_mpc.cli.launch",
            "--bus", name] + child_argv
    env = dict(os.environ)
    procs = {}
    try:
        procs["mpc"] = subprocess.Popen(base + ["--role", "mpc"], env=env)
        procs["dummy"] = subprocess.Popen(base + ["--role", "dummy"],
                                          env=env)
        rc = procs["dummy"].wait()
        return rc
    finally:
        for name_, p in procs.items():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=10.0)
        bus.close()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=("launch", "mpc", "dummy"),
                    default="launch",
                    help="launch (default) spawns one mpc and one dummy "
                         "process; only the mpc (planner) process opens the "
                         "accelerator, the dummy (plant) runs on the CPU")
    _add_shared_args(ap)
    args = ap.parse_args(argv)
    if args.role == "mpc":
        return run_mpc(args)
    if args.role == "dummy":
        return run_dummy(args)
    # Strip --role/--bus from the argv we forward to children.
    fwd = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--role", "--bus"):
            skip = True
            continue
        fwd.append(a)
    return run_launch(args, fwd)


if __name__ == "__main__":
    sys.exit(main())
