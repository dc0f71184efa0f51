"""Legged planner assembly: the reference's SQP/DDP MPC-node main() as a
reusable object.

The reference assembles its planning node in `LeggedRobotSqpMpcNode.cpp:42-78`
(and `LeggedRobotDdpMpcNode.cpp:42-78`): LeggedRobotInterface (task.info ->
OCP) -> GaitReceiver + RosReferenceManager (solver-synchronized command
injection) -> MultipleShootingMpc -> MPC_ROS_Interface::launchNodes. This
module is that assembly for this framework: a jitted legged solver, a
GaitSchedule + SwingTrajectoryPlanner regenerated per solve (the
SwitchedModelReferenceManager::modifyReferences role), a GaitReceiver for
async gait commands, a velocity-command target (the
TargetTrajectoriesKeyboardPublisher role) and warm starting from the
previous policy — exposed as a single ``solve_fn(obs) -> PolicyData``
suitable for :class:`~cheeta_mpc.transport.mpc_mrt.MpcNode` (in-process
bus or cross-process shared memory, see ``cli/launch.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from cheeta_mpc.gait.receiver import GaitReceiver
from cheeta_mpc.gait.schedule import GaitSchedule, ModeSequenceTemplate
from cheeta_mpc.gait.swing import SwingConfig, SwingTrajectoryPlanner
from cheeta_mpc.mpc.legged_mpc import (LeggedMpcConfig,
                                       build_legged_solver,
                                       make_velocity_command_reference)
from cheeta_mpc.mpc.runtime import (PolicyData, SystemObservation,
                                    shift_warm_start)
from cheeta_mpc.utils.timing import Benchmarker


@dataclass
class PlannerSettings:
    """Knobs of the planning node (solver choice + loop config)."""

    solver: str = "sqp"  # 'sqp' (LeggedRobotSqpMpcNode) | 'ddp' (DdpMpcNode)
    sqp_iterations: int = 2
    ipm_iterations: int = 10
    ddp_iterations: int = 5
    # Full DDP settings object (e.g. DdpSettings.from_task_info on the
    # task.info ddp block); when set it wins over ddp_iterations.
    ddp: Optional[object] = None
    com_height: Optional[float] = None  # default: from initial stance
    terrain_height: float = 0.0
    schedule_margin: float = 1.5  # seconds of schedule kept past the horizon


class LeggedPlannerAssembly:
    """Solver + references + commands behind one ``solve_fn``.

    Thread-safety: ``set_velocity_command`` / ``on_gait_command`` may be
    called from any thread (they buffer under locks); ``solve_fn`` applies
    them between solves — the reference's solver-synchronized-module
    contract (GaitReceiver.cpp:49-57).
    """

    def __init__(self, cfg: LeggedMpcConfig, gait_schedule: GaitSchedule,
                 x0: np.ndarray, v_cmd: np.ndarray,
                 settings: PlannerSettings = PlannerSettings(),
                 swing_config: SwingConfig = None):
        import jax
        import jax.numpy as jnp

        from cheeta_mpc.ops.ocpqp import IpmSettings
        from cheeta_mpc.solvers.scp import ScpSettings

        self.cfg = cfg
        self.settings = settings
        self._np_dtype = np.float64 if cfg.dtype == jnp.float64 \
            else np.float32
        self.N, self.DT = cfg.horizon, float(cfg.params.dt)
        self.horizon_s = self.N * self.DT
        self.gait_schedule = gait_schedule
        self.receiver = GaitReceiver(gait_schedule)
        self.planner = SwingTrajectoryPlanner(swing_config or SwingConfig(),
                                              num_feet=4)
        self.x0 = np.asarray(x0, np.float64)
        self.com_height = (settings.com_height if settings.com_height
                           is not None else float(self.x0[8]))
        self._v_lock = threading.Lock()
        self._v_cmd = np.asarray(v_cmd, np.float64)
        self.bench = Benchmarker()
        self._prev_policy: Optional[PolicyData] = None
        self._jnp = jnp

        if settings.solver == "sqp":
            scp = ScpSettings(iterations=settings.sqp_iterations,
                              ipm=IpmSettings(iters=settings.ipm_iterations))
            self._solve = jax.jit(build_legged_solver(cfg, scp))
        elif settings.solver == "ddp":
            from cheeta_mpc.mpc.legged_ddp import build_legged_ddp_solver
            from cheeta_mpc.solvers.ddp import DdpSettings
            if settings.ddp is not None:
                # Configured from the task.info ddp block. The file's
                # constraintPenaltyInitialValue (20.0) is meant as the START
                # of an AL growth schedule the reference runs; this DDP uses
                # a single fixed penalty, so floor it at 1e2 (the solver's
                # effective default) like cli/legged_demo.py does — otherwise
                # stance/swing equality enforcement weakens ~5x.
                ddp = settings.ddp
                self._solve = jax.jit(build_legged_ddp_solver(
                    cfg, ddp,
                    eq_penalty=max(ddp.constraint_penalty, 1e2)))
            else:
                self._solve = jax.jit(build_legged_ddp_solver(
                    cfg, DdpSettings(iterations=settings.ddp_iterations)))
        else:
            raise ValueError(f"unknown solver {settings.solver!r}")

    # -- command side (any thread) -------------------------------------
    def set_velocity_command(self, v_cmd: np.ndarray) -> None:
        """Target command entry: [vx, vy, yaw_rate] (the `_mpc_target`
        subscriber role). Accepts any vector; the first three entries are
        used."""
        v = np.zeros(3)
        arr = np.ravel(np.asarray(v_cmd, np.float64))
        v[:min(3, arr.size)] = arr[:3]
        with self._v_lock:
            self._v_cmd = v

    def on_gait_command(self, name: str,
                        template: ModeSequenceTemplate) -> None:
        """Gait command entry (the `_mpc_mode_schedule` subscriber role)."""
        self.receiver.on_command(name, template)

    # -- solve side (planner thread) ------------------------------------
    def solve_fn(self, obs: SystemObservation) -> PolicyData:
        from cheeta_mpc.solvers.discretization import (
            discretize_fixed, interval_contact_flags)

        jnp = self._jnp
        t, x = obs.time, np.asarray(obs.state, np.float64)
        N, DT = self.N, self.DT
        s = self.settings
        # Solver-synchronized hooks: buffered gait command lands at
        # finalTime, then regenerate schedule + swing references
        # (SwitchedModelReferenceManager::modifyReferences over
        # [t0 - T, tf + T], SwitchedModelReferenceManager.cpp:54-61).
        self.receiver.pre_solver_run(t, t + self.horizon_s)
        ms = self.gait_schedule.get_mode_schedule(
            max(0.0, t - s.schedule_margin),
            t + self.horizon_s + s.schedule_margin)
        self.planner.update(ms, terrain_height=s.terrain_height)
        with self._v_lock:
            v_cmd = self._v_cmd.copy()

        x_ref = make_velocity_command_reference(self.cfg, x, v_cmd,
                                                com_height=self.com_height)
        # Event-aligned shooting grid (timeDiscretizationWithEvents role).
        times = discretize_fixed(t, t + self.horizon_s, N + 1,
                                 ms.event_times)
        enable = interval_contact_flags(times, ms)
        dts = np.diff(times)
        mids = 0.5 * (times[:-1] + times[1:])
        z_pos, z_vel = self.planner.sample_times(mids)
        z_pos, z_vel = z_pos.T, z_vel.T

        dt_np = self._np_dtype
        kw = {}
        if s.solver == "sqp":
            if self._prev_policy is not None:
                xw, uw = shift_warm_start(self._prev_policy, times)
            else:
                # First tick: replicate the solver's own initializer
                # (hold state + weight-compensating input,
                # LeggedRobotInitializer role) so `warm` is ALWAYS a pair
                # of arrays — warm=None vs warm=arrays are different jit
                # signatures and would cost a second full XLA compile.
                from cheeta_mpc.models.srbd_legged import \
                    weight_compensating_input
                xw = np.tile(x[None], (N + 1, 1))
                uw = np.stack([np.asarray(weight_compensating_input(
                    self.cfg.params, jnp.asarray(e, dt_np), self.cfg.dtype))
                    for e in enable])
            kw["warm"] = (jnp.asarray(xw, dt_np), jnp.asarray(uw, dt_np))
        with self.bench.phase("mpc_solve"):
            sol = self._solve(jnp.asarray(x, dt_np),
                              jnp.asarray(x_ref, dt_np),
                              jnp.asarray(enable, dt_np),
                              jnp.asarray(z_pos, dt_np),
                              jnp.asarray(z_vel, dt_np),
                              dts=jnp.asarray(dts, dt_np), **kw)
            u_host = np.asarray(sol.u_traj, np.float64)
        self.bench.record_solve_ms(self.bench.phase("mpc_solve").latest_ms)
        self.last_metrics = {"t": round(t, 6),
                             "solve_ms": round(
                                 self.bench.phase("mpc_solve").latest_ms, 3)}
        P = p = None
        if s.solver == "sqp":
            perf = sol.performance
            self.last_metrics.update({
                "merit": float(sol.merit), "cost": float(perf.cost),
                "dyn_sse": float(perf.dyn_violation_sse),
                "eq_sse": float(perf.eq_constraint_sse),
                "ineq_sse": float(perf.ineq_constraint_sse),
                "convergence": int(sol.convergence)})
            P = np.asarray(sol.gains_P, np.float64)
            p = np.asarray(sol.gains_p, np.float64)
        else:
            self.last_metrics.update({"cost": float(sol.cost),
                                      "converged": bool(sol.converged)})
            # DDP value-function surface: same policy fields as SQP mode.
            P = np.asarray(sol.gains_P, np.float64)
            p = np.asarray(sol.gains_p, np.float64)
        policy = PolicyData(times=times,
                            x_traj=np.asarray(sol.x_traj, np.float64),
                            u_traj=u_host,
                            K=np.asarray(sol.gains_K, np.float64),
                            P=P, p=p)
        self._prev_policy = policy
        return policy


def default_stance_state(cfg: LeggedMpcConfig) -> np.ndarray:
    """Nominal standing state from the default joint pose (the reference's
    initialState ingestion role, task.info:112-137)."""
    import jax.numpy as jnp

    from cheeta_mpc.models.quadruped_kinematics import \
        foot_positions_world

    default_joints = np.array([0., 0.4, -0.8, 0., -0.4, 0.8,
                               0., 0.4, -0.8, 0., -0.4, 0.8])
    feet_b = np.asarray(foot_positions_world(
        cfg.params.desc, jnp.zeros(3), jnp.zeros(3),
        jnp.asarray(default_joints)))
    x0 = np.zeros(24)
    x0[8] = -feet_b[:, 2].mean()
    x0[12:] = default_joints
    return x0
