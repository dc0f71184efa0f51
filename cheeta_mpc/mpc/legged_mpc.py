"""Legged-robot SQP MPC: the OCS2-style kinodynamic task (SURVEY.md §2.5).

The capability equivalent of the reference's ``LeggedRobotInterface``
(``ocs2_legged_robot/src/LeggedRobotInterface.cpp:67-196``): assembles the
optimal-control problem — SRBD dynamics, base-tracking cost from the
task.info Q/R matrices, and the four per-foot constraint families — and
solves it with the SQP layer over the equality-aware interior-point solver.

Constraint families (reference LeggedRobotInterface.cpp:177-183):
- zeroForce (swing):    structural, F_eff = enable * u_F.
- frictionCone (stance): pyramid rows on u_F, masked by contact flags.
  (The reference uses a smoothed second-order cone as a relaxed-barrier
  *soft* constraint with mu 0.5 / delta 5.0 (task.info:215-222); a hard
  pyramid inside the IPM enforces the same physics strictly.)
- zeroVelocity (stance): v_foot(x, u) = 0 (3 rows/leg) — stage equalities.
- normalVelocity (swing): v_foot_z + gain (p_z - z_ref) = zdot_ref (1
  row/leg) with the swing-planner references (SwingTrajectoryPlanner).

Equality rows are handled by the masked equality-Riccati elimination
(ops/riccati.riccati_factorize_eq) — static 16 rows per node whose activity
follows the contact mode, replacing the reference's per-node projection.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import (CostApprox, DynamicsLin, OcpQpData,
                                   StageConstraint, StageEquality)
from cheeta_mpc.models.quadruped_kinematics import (QuadrupedDescription,
                                                    foot_positions_world)
from cheeta_mpc.models.srbd_legged import (GRAVITY, NU, NX, SrbdParams,
                                           foot_velocity_constraint_values,
                                           srbd_linearize, srbd_step,
                                           unpack_srbd_state,
                                           weight_compensating_input)
from cheeta_mpc.ops.ocpqp import IpmSettings, solve_ocp_qp
from cheeta_mpc.solvers.scp import (ScpSettings, make_performance,
                                    solve_nonlinear_ocp)

NL = 4
NC_EQ = 16  # 3 velocity rows/leg (stance) + 1 normal-velocity row/leg (swing)
NG = 20  # 5 friction-pyramid rows per leg


class LeggedMpcConfig(NamedTuple):
    params: SrbdParams = SrbdParams()
    horizon: int = 20  # nodes; reference: timeHorizon 1.0 s / dt 0.015 ~ 67
    q_diag: Tuple[float, ...] = ()  # (24,) from task.info Q
    r_diag: Tuple[float, ...] = ()  # (24,) from task.info R
    friction_mu: float = 0.5  # task.info frictionConeSoftConstraint
    position_error_gain: float = 20.0  # task.info model_settings
    force_max: float = 700.0
    # Friction treatment: 'soft' = the reference's configuration (smoothed
    # SOC under a relaxed log barrier, FrictionConeConstraint.cpp +
    # task.info:215-222 — no inequality rows reach the QP, the stage-equality
    # Riccati solves exactly); 'pyramid' = hard 5-row pyramid enforced by the
    # interior-point QP (strict physics; slower).
    cone_mode: str = 'pyramid'
    barrier_mu: float = 0.1  # task.info frictionConeSoftConstraint.mu
    barrier_delta: float = 5.0  # .delta
    dtype: jnp.dtype = jnp.float32

    @classmethod
    def from_task_info(cls, task_info_path: str, horizon: Optional[int] = None,
                       cone_mode: str = 'soft',
                       dtype=jnp.float32) -> "LeggedMpcConfig":
        """Ingest the reference's task.info verbatim (config layer parity).
        Defaults to the soft cone — the reference task's own treatment."""
        from cheeta_mpc.utils.info_config import as_matrix, load_info
        tree = load_info(task_info_path)
        Q = as_matrix(tree["Q"])
        R = as_matrix(tree["R"])
        ms = tree["multiple_shooting"]
        dt = float(ms["dt"])
        T = float(tree["mpc"]["timeHorizon"])
        N = horizon if horizon is not None else int(round(T / dt))
        fc = tree["frictionConeSoftConstraint"]
        return cls(
            params=SrbdParams(dt=dt, integrator=str(
                ms.get("integratorType", "RK2")).lower()),
            horizon=N,
            q_diag=tuple(np.diag(Q).tolist()),
            r_diag=tuple(np.diag(R).tolist()),
            friction_mu=float(fc["frictionCoefficient"]),
            position_error_gain=float(
                tree["model_settings"]["positionErrorGain"]),
            cone_mode=cone_mode,
            barrier_mu=float(fc.get("mu", 0.1)),
            barrier_delta=float(fc.get("delta", 5.0)),
            dtype=dtype)


class LeggedSolution(NamedTuple):
    x_traj: jnp.ndarray  # (N+1, 24)
    u_traj: jnp.ndarray  # (N, 24)
    forces: jnp.ndarray  # (N, 4, 3) effective contact forces
    joint_vel: jnp.ndarray  # (N, 12)
    gains_K: jnp.ndarray  # (N, 24, 24)
    merit: jnp.ndarray
    qp_mu: jnp.ndarray
    gains_P: jnp.ndarray  # (N+1, 24, 24) value-function Hessians
    gains_p: jnp.ndarray  # (N+1, 24) value-function gradients
    performance: object  # PerformanceIndex at the final iterate
    convergence: jnp.ndarray  # int32 CONV_* code


def _pyramid(mu, dtype):
    # numpy: build-time constant, usable even if the builder runs under an
    # outer trace.
    return np.array([[-1.0, 0.0, mu], [1.0, 0.0, mu], [0.0, -1.0, mu],
                     [0.0, 1.0, mu], [0.0, 0.0, 1.0]], dtype)


def build_legged_solver(cfg: LeggedMpcConfig,
                        scp: ScpSettings = ScpSettings(
                            iterations=2, ipm=IpmSettings(iters=10))):
    """Returns jittable ``solve(x0, x_ref_traj, enable_table, z_pos_ref,
    z_vel_ref) -> LeggedSolution``.

    Args of the returned function:
        x0: (24,) current state.
        x_ref_traj: (N+1, 24) tracking reference (TargetTrajectories).
        enable_table: (N, 4) gait contact flags.
        z_pos_ref, z_vel_ref: (N, 4) swing-foot height/velocity references
            from the swing planner (SwingTrajectoryPlanner.sample_grid).
    """
    from cheeta_mpc.mpc.friction_cone import (FrictionConeConfig,
                                              RelaxedBarrierConfig,
                                              barrier_cost_quadratic,
                                              cone_value, relaxed_barrier)

    p = cfg.params
    N = cfg.horizon
    dt_ = cfg.dtype
    # numpy (not device) constants: they lower as HLO literals.
    Qd = np.asarray(cfg.q_diag, dt_)
    Rd = np.asarray(cfg.r_diag, dt_)
    gain = cfg.position_error_gain
    pyr = _pyramid(cfg.friction_mu, dt_)
    soft = cfg.cone_mode == 'soft'
    cone_cfg = FrictionConeConfig(friction_coefficient=cfg.friction_mu)
    bar_cfg = RelaxedBarrierConfig(mu=cfg.barrier_mu, delta=cfg.barrier_delta)

    def node_eq_constraint(x, u, enable, zp_ref, zv_ref):
        """(16,) equality values at a node (mask applied by caller)."""
        v = foot_velocity_constraint_values(p, x, u)  # (4, 3)
        _, _, p_base, eul, q = unpack_srbd_state(x)
        feet = foot_positions_world(p.desc, p_base, eul, q)
        stance_rows = v.reshape(-1)  # 12
        swing_rows = v[:, 2] + gain * (feet[:, 2] - zp_ref) - zv_ref  # 4
        return jnp.concatenate([stance_rows, swing_rows])

    def eq_mask_of(enable):
        return jnp.concatenate([jnp.repeat(enable, 3), 1.0 - enable])

    def u_ref_of(enable):
        return weight_compensating_input(p, enable, dt_)

    def total_cost(x_traj, u_traj, x_ref, enable_table):
        dx = x_traj - x_ref
        u_ref = jax.vmap(u_ref_of)(enable_table)
        du = u_traj - u_ref
        c = (0.5 * jnp.sum(dx * Qd * dx)
             + 0.5 * jnp.sum(du * Rd * du))
        if soft:
            # Relaxed-barrier soft cone on stance-leg forces (the reference
            # task's friction treatment, LeggedRobotInterface.cpp:313-325).
            F = u_traj[:, :3 * NL].reshape(N, NL, 3)
            h = cone_value(cone_cfg, F)
            c = c + jnp.sum(enable_table * relaxed_barrier(bar_cfg, h))
        return c

    def build_eq(x_traj, u_traj, enable_table, z_pos_ref, z_vel_ref):
        def node(x, u, e, zp, zv):
            mask = eq_mask_of(e)
            c_fn = lambda xx, uu: (mask
                                   * node_eq_constraint(xx, uu, e, zp, zv))
            val = c_fn(x, u)
            Cx = jax.jacfwd(c_fn, argnums=0)(x, u)
            Du = jax.jacfwd(c_fn, argnums=1)(x, u)
            return Cx, Du, val, mask

        C, D, e_val, mask = jax.vmap(node)(x_traj[:-1], u_traj, enable_table,
                                           z_pos_ref, z_vel_ref)
        return StageEquality(C=C, D=D, e=e_val, mask=mask)

    # Friction-pyramid constraint constants (static per config) — numpy so
    # they lower as HLO literals, not hidden device-buffer args.
    D_np = np.zeros((N + 1, NG, NU), dt_)
    for i in range(NL):
        D_np[:N, 5 * i:5 * (i + 1), 3 * i:3 * (i + 1)] = pyr
    C_np = np.zeros((N + 1, NG, NX), dt_)
    big = 2 * cfg.friction_mu * cfg.force_max + 1.0
    ub_leg = np.array([big, big, big, big, cfg.force_max], dt_)
    ug_np = np.tile(np.tile(ub_leg, NL)[None, :], (N + 1, 1))
    lg_np = np.zeros((N + 1, NG), dt_)

    def build_ineq(u_traj, enable_table):
        """Friction pyramid rows in deviation coordinates around u_traj."""
        mask = jnp.concatenate(
            [jnp.repeat(enable_table, 5, axis=-1),
             np.zeros((1, NG), dt_)], axis=0)
        du_pad = jnp.concatenate([u_traj, jnp.zeros_like(u_traj[:1])], axis=0)
        g_iter = jnp.einsum('nij,nj->ni', D_np, du_pad)
        return StageConstraint(C=C_np, D=D_np, lg=lg_np - g_iter,
                               ug=ug_np - g_iter, mask=mask)

    def solve(x0, x_ref_traj, enable_table, z_pos_ref, z_vel_ref,
              warm: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
              dts: Optional[jnp.ndarray] = None):
        """``dts``: optional (N,) per-interval durations from an
        event-aligned grid (solvers/discretization.discretize_fixed — the
        reference's timeDiscretizationWithEvents role); None = uniform
        params.dt."""
        x0 = jnp.asarray(x0, dt_)
        x_ref_traj = jnp.asarray(x_ref_traj, dt_)
        enable_table = jnp.asarray(enable_table, dt_)
        z_pos_ref = jnp.asarray(z_pos_ref, dt_)
        z_vel_ref = jnp.asarray(z_vel_ref, dt_)
        dts_v = (np.full((N,), p.dt, dt_) if dts is None
                 else jnp.asarray(dts, dt_))

        if warm is None:
            # Reference LeggedRobotInitializer: hold state, weight-comp input.
            u_init = jax.vmap(u_ref_of)(enable_table)
            x_init = jnp.tile(x0[None], (N + 1, 1))
        else:
            x_init, u_init = warm
            x_init = x_init.at[0].set(x0)

        def linearize(x_traj, u_traj):
            A, B, f = jax.vmap(
                lambda x, u, e, d: srbd_linearize(p, x, u, e, d)
            )(x_traj[:-1], u_traj, enable_table, dts_v)
            dyn = DynamicsLin(A=A, B=B, b=f - x_traj[1:])
            dx = x_traj - x_ref_traj
            u_ref = jax.vmap(u_ref_of)(enable_table)
            du = u_traj - u_ref
            # numpy constants lower as HLO literals; traced terms are added
            # via pad/concatenate, never scattered into constant bases.
            Qm = np.tile(np.diag(Qd)[None], (N + 1, 1, 1))
            Rm = np.tile(np.diag(Rd)[None], (N, 1, 1))
            r_lin = Rd * du
            if soft:
                # Analytic quadratic of the relaxed-barrier cone cost on the
                # per-leg force blocks (chain rule with the NSD-corrected
                # constraint Hessian, FrictionConeConstraint.cpp:128-210).
                F = u_traj[:, :3 * NL].reshape(N, NL, 3)
                _, bgrad, bhess = barrier_cost_quadratic(cone_cfg, bar_cfg, F)
                bgrad = bgrad * enable_table[..., None]
                bhess = bhess * enable_table[..., None, None]
                blk = jnp.einsum('nlij,lm->nlimj', bhess,
                                 np.eye(NL, dtype=dt_))
                pad_f = NU - 3 * NL
                Rm = Rm + jnp.pad(blk.reshape(N, 3 * NL, 3 * NL),
                                  ((0, 0), (0, pad_f), (0, pad_f)))
                r_lin = r_lin + jnp.pad(bgrad.reshape(N, 3 * NL),
                                        ((0, 0), (0, pad_f)))
            cost = CostApprox(Q=Qm, q=Qd * dx, R=Rm, r=r_lin,
                              S=np.zeros((N, NU, NX), dt_))
            eq = build_eq(x_traj, u_traj, enable_table, z_pos_ref, z_vel_ref)
            con = None if soft else build_ineq(u_traj, enable_table)
            return OcpQpData(dyn=dyn, cost=cost, con=con,
                             dx0=np.zeros((NX,), dt_), eq=eq)

        def dyn_defects(x_traj, u_traj):
            xn = jax.vmap(lambda x, u, e, d: srbd_step(p, x, u, e, d))(
                x_traj[:-1], u_traj, enable_table, dts_v)
            return xn - x_traj[1:]

        def eq_values(x_traj, u_traj):
            eq = build_eq(x_traj, u_traj, enable_table, z_pos_ref, z_vel_ref)
            return eq.mask * eq.e

        def ineq_violations(x_traj, u_traj):
            con = build_ineq(u_traj, enable_table)
            return con.mask * (jnp.maximum(con.lg, 0.0)
                               + jnp.maximum(-con.ug, 0.0))

        performance = make_performance(
            total_cost=lambda x, u: total_cost(x, u, x_ref_traj,
                                               enable_table),
            dyn_defects=dyn_defects, eq_values=eq_values,
            ineq_violations=None if soft else ineq_violations)

        res = solve_nonlinear_ocp(linearize, performance, x_init, u_init, scp)
        forces = (res.u[:, :12].reshape(N, NL, 3)
                  * enable_table[:, :, None])
        return LeggedSolution(x_traj=res.x, u_traj=res.u, forces=forces,
                              joint_vel=res.u[:, 12:], gains_K=res.gains_K,
                              merit=res.merit, qp_mu=res.qp_mu,
                              gains_P=res.gains_P, gains_p=res.gains_p,
                              performance=res.performance,
                              convergence=res.convergence)

    return solve


def make_standing_reference(cfg: LeggedMpcConfig, x0, com_height=None):
    """(N+1, 24) hold-position reference (the reference DummyNode's initial
    target: current state held, reference.info comHeight)."""
    x_ref = np.tile(np.asarray(x0, np.float64), (cfg.horizon + 1, 1))
    x_ref[:, 0:6] = 0.0  # zero momentum
    if com_height is not None:
        x_ref[:, 8] = com_height
    return x_ref


def make_velocity_command_reference(cfg: LeggedMpcConfig, x0, v_cmd,
                                    yaw_rate=0.0, com_height=None):
    """(N+1, 24) constant-velocity command reference (the reference's
    TargetTrajectories from cmdVel, reference.info)."""
    x0 = np.asarray(x0, np.float64)
    N = cfg.horizon
    dt = cfg.params.dt
    x_ref = np.tile(x0, (N + 1, 1))
    ts = np.arange(N + 1) * dt
    x_ref[:, 0:3] = np.asarray(v_cmd)
    x_ref[:, 3:6] = 0.0
    x_ref[:, 6:9] = x0[None, 6:9] + ts[:, None] * np.asarray(v_cmd)
    if com_height is not None:
        x_ref[:, 8] = com_height
    x_ref[:, 9] = x0[9] + ts * yaw_rate
    x_ref[:, 10:12] = 0.0
    return x_ref
