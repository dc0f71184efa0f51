"""Legged-robot DDP/SLQ MPC: the reference's alternative solver node.

The capability equivalent of ``LeggedRobotDdpMpcNode``
(`/root/reference/ocs2_legged_robot_ros/src/LeggedRobotDdpMpcNode.cpp:42-78`:
`GaussNewtonDDP_MPC` with `ddp.algorithm SLQ`, task.info:50-99) assembled on
the same SRBD kinodynamic task as the SQP path (mpc/legged_mpc.py), driven by
the generic Gauss-Newton DDP engine (solvers/ddp.py).

Constraint treatment in DDP mode (all through the cost, as SLQ does):
- friction cone: relaxed-barrier penalty on the smoothed SOC — the exact
  configuration of the reference's DDP task (`LeggedRobotInterface.cpp:
  313-325` + task.info:215-222);
- stance zero-velocity and swing normal-velocity equalities: quadratic
  penalties (the reference SLQ projects state-input equalities; a stiff
  quadratic penalty is the standard unconstrained-DDP equivalent and keeps
  the backward pass a plain Riccati recursion);
- swing zero-force: structural, forces multiplied by the contact flag inside
  the dynamics, so swing forces cannot act (and a small regularizer pins
  them to zero).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.mpc.friction_cone import (FrictionConeConfig,
                                          RelaxedBarrierConfig,
                                          cone_value, relaxed_barrier)
from cheeta_mpc.mpc.legged_mpc import NL, LeggedMpcConfig
from cheeta_mpc.models.quadruped_kinematics import foot_positions_world
from cheeta_mpc.models.srbd_legged import (
    foot_velocity_constraint_values, srbd_step, unpack_srbd_state,
    weight_compensating_input)
from cheeta_mpc.solvers.ddp import DdpSettings, solve_ddp


class LeggedDdpSolution(NamedTuple):
    x_traj: jnp.ndarray  # (N+1, 24)
    u_traj: jnp.ndarray  # (N, 24)
    forces: jnp.ndarray  # (N, 4, 3) effective contact forces
    joint_vel: jnp.ndarray  # (N, 12)
    gains_K: jnp.ndarray  # (N, 24, 24) feedback of the last backward pass
    gains_P: jnp.ndarray  # (N+1, 24, 24) value-function Hessians (the DDP
    #                       cost-to-go surface, matching the SQP path)
    gains_p: jnp.ndarray  # (N+1, 24) value-function gradients
    cost: jnp.ndarray
    converged: jnp.ndarray  # bool (ddp.minRelCost classification)


def build_legged_ddp_solver(cfg: LeggedMpcConfig,
                            ddp: DdpSettings = DdpSettings(iterations=5),
                            eq_penalty: float = 1e2,
                            force_reg: float = 1e-4):
    """Returns jittable ``solve(x0, x_ref_traj, enable_table, z_pos_ref,
    z_vel_ref) -> LeggedDdpSolution`` (same signature as the SQP builder, so
    the two solvers are drop-in interchangeable behind MpcMrtInterface —
    exactly the relationship of the reference's two MPC nodes)."""
    p = cfg.params
    N = cfg.horizon
    dt_ = cfg.dtype
    # numpy constants: they lower as HLO literals.
    Qd = np.asarray(cfg.q_diag, dt_)
    Rd = np.asarray(cfg.r_diag, dt_)
    gain = cfg.position_error_gain
    cone_cfg = FrictionConeConfig(friction_coefficient=cfg.friction_mu)
    bar_cfg = RelaxedBarrierConfig(mu=cfg.barrier_mu, delta=cfg.barrier_delta)

    def solve(x0, x_ref_traj, enable_table, z_pos_ref, z_vel_ref, dts=None):
        x0 = jnp.asarray(x0, dt_)
        x_ref_traj = jnp.asarray(x_ref_traj, dt_)
        enable_table = jnp.asarray(enable_table, dt_)
        z_pos_ref = jnp.asarray(z_pos_ref, dt_)
        z_vel_ref = jnp.asarray(z_vel_ref, dt_)
        dts_v = (jnp.full((N,), p.dt, dt_) if dts is None
                 else jnp.asarray(dts, dt_))
        u_ref = jax.vmap(
            lambda e: weight_compensating_input(p, e, dt_))(enable_table)

        def step(k, x, u):
            return srbd_step(p, x, u, enable_table[k], dts_v[k])

        def stage_cost(k, x, u):
            e = enable_table[k]
            dx = x - x_ref_traj[k]
            du = u - u_ref[k]
            c = 0.5 * jnp.sum(dx * Qd * dx) + 0.5 * jnp.sum(du * Rd * du)
            # Relaxed-barrier friction cone on stance legs.
            F = u[:3 * NL].reshape(NL, 3)
            h = cone_value(cone_cfg, F)
            c = c + jnp.sum(e * relaxed_barrier(bar_cfg, h))
            # Swing forces: structural in the dynamics; regularize to zero.
            c = c + force_reg * jnp.sum(((1.0 - e)[:, None] * F) ** 2)
            # Equality families as quadratic penalties: stance foot velocity
            # (12 rows) + swing normal velocity with swing-spline reference.
            v = foot_velocity_constraint_values(p, x, u)  # (4, 3)
            _, _, p_base, eul, q = unpack_srbd_state(x)
            feet = foot_positions_world(p.desc, p_base, eul, q)
            swing = (v[:, 2] + gain * (feet[:, 2] - z_pos_ref[k])
                     - z_vel_ref[k])
            c = c + eq_penalty * (jnp.sum(e[:, None] * v ** 2)
                                  + jnp.sum((1.0 - e) * swing ** 2))
            return c

        def terminal_cost(x):
            dx = x - x_ref_traj[-1]
            return 0.5 * jnp.sum(dx * Qd * dx)

        res = solve_ddp(step, stage_cost, terminal_cost, x0,
                        u_init=u_ref, settings=ddp)
        forces = res.u[:, :3 * NL].reshape(N, NL, 3) * enable_table[:, :,
                                                                    None]
        return LeggedDdpSolution(x_traj=res.x, u_traj=res.u, forces=forces,
                                 joint_vel=res.u[:, 3 * NL:], gains_K=res.K,
                                 gains_P=res.P, gains_p=res.p,
                                 cost=res.cost, converged=res.converged)

    return solve
