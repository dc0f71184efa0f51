"""Convex SRB MPC: one-shot QP trot/gait controller.

BASELINE.json config 2 ("ConvexMPC SRB trot gait with friction-cone
constraints, fixed gait schedule"). Builds the OCP-QP directly from the SRB
model (models/srb.py) and solves it with a single structured interior-point
solve — the whole controller is one jitted XLA program, vmappable over
scenario batches.

Cost: diagonal state tracking (rpy, p, omega, v) vs a commanded reference
trajectory + small force regularization (the classic Cheetah convex-MPC
objective). Constraints: per-stance-leg friction pyramid with fz bounds,
masked by the gait's contact table.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cheeta_mpc.core.types import (CostApprox, DynamicsLin, OcpQpData,
                                   StageConstraint)
from cheeta_mpc.models.srb import (GRAVITY, SrbParams,
                                   friction_pyramid_rows,
                                   srb_discrete_dynamics)
from cheeta_mpc.ops.ocpqp import IpmSettings, solve_ocp_qp


class ConvexMpcConfig(NamedTuple):
    params: SrbParams
    horizon: int = 10
    dt: float = 0.03
    # Diagonal state weights [rpy(3), p(3), omega(3), v(3)]:
    q_diag: tuple = (25.0, 25.0, 10.0, 2.0, 2.0, 50.0,
                     0.0, 0.0, 0.3, 0.2, 0.2, 0.2)
    r_force: float = 1e-6
    dtype: jnp.dtype = jnp.float32


def build_convex_mpc(cfg: ConvexMpcConfig,
                     ipm: IpmSettings = IpmSettings(iters=12)):
    """Returns jittable ``solve(x0, x_ref_traj, foot_pos, enable_table) ->
    (forces, qp_solution)``.

    Args of the returned function:
        x0: (13,) current SRB state (rpy, p, omega, v, 1.0).
        x_ref_traj: (N+1, 13) commanded state trajectory (last col 1.0).
        foot_pos: (num_legs, 3) current foot positions (held over horizon,
            the standard convex-MPC simplification).
        enable_table: (N, num_legs) gait contact flags.
    """
    p = cfg.params
    N, nl = cfg.horizon, p.num_legs
    nx, nu = p.nx, p.nu
    dt_ = cfg.dtype

    def solve(x0, x_ref_traj, foot_pos, enable_table):
        x0 = jnp.asarray(x0, dt_)
        x_ref_traj = jnp.asarray(x_ref_traj, dt_)
        foot_pos = jnp.asarray(foot_pos, dt_)
        enable_table = jnp.asarray(enable_table, dt_)
        yaw_ref = x_ref_traj[:, 2]

        def stage_dyn(k):
            return srb_discrete_dynamics(p, yaw_ref[k], x0[3:6], foot_pos,
                                         enable_table[k], cfg.dt, dt_)

        A, B = jax.vmap(stage_dyn)(jnp.arange(N))
        # Deviation coordinates around the reference (dx = x - x_ref, forces
        # absolute): residual b_k = A x_ref_k - x_ref_{k+1} makes the QP
        # exact for the linear model.
        b = jnp.einsum('kij,kj->ki', A, x_ref_traj[:-1]) - x_ref_traj[1:]
        dyn = DynamicsLin(A=A, B=B, b=b)

        qd = jnp.asarray(cfg.q_diag + (0.0,), dt_)
        Q = jnp.tile(jnp.diag(qd)[None], (N + 1, 1, 1))
        q = jnp.zeros((N + 1, nx), dt_)
        # Swing-leg force regularization dominates; stance regularization is
        # r_force (keeps the QP strictly convex).
        reg = (cfg.r_force
               + 1.0 * (1.0 - jnp.repeat(enable_table, 3, axis=-1)))
        R = jax.vmap(jnp.diag)(2.0 * reg)
        # Gravity feedforward: penalize deviation from equal weight share so
        # r = -2*reg*f_ff with f_ff the weight-compensating force.
        stance_count = jnp.maximum(jnp.sum(enable_table, axis=-1), 1.0)
        fz_ff = p.mass * GRAVITY / stance_count  # (N,)
        f_ff = jnp.zeros((N, nl, 3), dt_)
        f_ff = f_ff.at[:, :, 2].set(enable_table * fz_ff[:, None])
        r = -2.0 * reg * f_ff.reshape(N, nu)
        cost = CostApprox(Q=Q, q=q, R=R, r=r,
                          S=jnp.zeros((N, nu, nx), dt_))

        # Friction pyramids (5 rows per leg) on stance steps.
        ng = 5 * nl
        pyr = friction_pyramid_rows(p.mu, dt_)  # (5, 3)
        D = jnp.zeros((N + 1, ng, nu), dt_)
        for i in range(nl):
            D = D.at[:N, 5 * i:5 * (i + 1), 3 * i:3 * (i + 1)].set(
                jnp.broadcast_to(pyr, (N, 5, 3)))
        C = jnp.zeros((N + 1, ng, nx), dt_)
        lg = jnp.zeros((N + 1, ng), dt_)
        lg = lg.at[:N, 4::5].set(p.fz_min)
        ug = jnp.zeros((N + 1, ng), dt_)
        big = jnp.asarray(2.0 * p.mu * p.fz_max + 1.0, dt_)
        ug = ug.at[:N, :].set(jnp.tile(
            jnp.array([big, big, big, big, p.fz_max], dt_), nl))
        mask = jnp.zeros((N + 1, ng), dt_)
        mask = mask.at[:N].set(jnp.repeat(enable_table, 5, axis=-1))
        con = StageConstraint(C=C, D=D, lg=lg, ug=ug, mask=mask)

        data = OcpQpData(dyn=dyn, cost=cost, con=con, dx0=x0 - x_ref_traj[0])
        sol = solve_ocp_qp(data, ipm)
        forces = (sol.du.reshape(N, nl, 3)
                  * enable_table[:, :, None])  # swing legs exactly zero
        return forces, sol

    return solve
