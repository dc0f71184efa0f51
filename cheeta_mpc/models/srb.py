"""Single-rigid-body (SRB) model for convex quadruped MPC.

The "ConvexMPC" formulation (BASELINE.json config 2; the lineage of the
reference's Cheetah-style stack and of OCS2's SRBD option,
``task.info centroidalModelType 1``): rigid-body rotational + translational
dynamics linearized about the commanded yaw, with ground-reaction forces as
the only inputs. The resulting optimal-control problem is a *convex QP* in
standard OCP form — it runs directly on the structured interior-point solver
(:mod:`cheeta_mpc.ops.ocpqp`), no SQP loop needed.

State (nx = 13):  [rpy(3), p(3), omega_world(3), v(3), g_const]
Input (nu = 3*num_legs): per-leg ground reaction forces (world frame).
The gravity constant is folded into the state (the classic trick) so the
dynamics are strictly linear: x_{k+1} = A_k x_k + B_k u_k.

Swing legs: forces enter the dynamics masked by the contact flag and their
friction rows are masked out of the IPM; a small regularizer pins them at
exactly zero (same structural choice as the centroidal model, see
models/centroidal.py docstring).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

GRAVITY = 9.81


class SrbParams(NamedTuple):
    mass: float
    inertia: tuple  # body-frame diagonal inertia (Ixx, Iyy, Izz)
    num_legs: int = 4
    mu: float = 0.4
    fz_min: float = 0.0
    fz_max: float = 500.0

    @property
    def nx(self) -> int:
        return 13

    @property
    def nu(self) -> int:
        return 3 * self.num_legs


def rotz(yaw):
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    return jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], yaw.dtype)


def _skew(v):
    return jnp.array([[0.0, -v[2], v[1]],
                      [v[2], 0.0, -v[0]],
                      [-v[1], v[0], 0.0]], v.dtype)


def srb_discrete_dynamics(params: SrbParams, yaw, com_pos, foot_pos, enable,
                          dt, dtype=jnp.float32):
    """(A, B) of one Euler step linearized about commanded yaw.

    Args:
        yaw: scalar commanded yaw for the linearization.
        com_pos: (3,) CoM position (for foot moment arms).
        foot_pos: (num_legs, 3) world foot positions.
        enable: (num_legs,) contact flags for this step.
    Returns:
        A: (13, 13), B: (13, nu).
    """
    nl = params.num_legs
    Rz = rotz(jnp.asarray(yaw, dtype))
    I_body = jnp.diag(jnp.asarray(params.inertia, dtype))
    I_world = Rz @ I_body @ Rz.T
    I_world_inv = jnp.linalg.inv(I_world)

    A = jnp.eye(13, dtype=dtype)
    # rpy_dot ~= Rz(yaw)^T omega_world (small roll/pitch approximation)
    A = A.at[0:3, 6:9].set(Rz.T * dt)
    # p_dot = v
    A = A.at[3:6, 9:12].set(jnp.eye(3, dtype=dtype) * dt)
    # v_dot includes -g via the constant-state column: v_z += -g*dt * 1
    A = A.at[11, 12].set(-GRAVITY * dt)

    B = jnp.zeros((13, 3 * nl), dtype)
    for i in range(nl):
        r = foot_pos[i] - com_pos
        cols = slice(3 * i, 3 * (i + 1))
        e = enable[i]
        B = B.at[6:9, cols].set(e * (I_world_inv @ _skew(r)) * dt)
        B = B.at[9:12, cols].set(e * jnp.eye(3, dtype=dtype) / params.mass
                                 * dt)
    return A, B


def friction_pyramid_rows(mu, dtype=jnp.float32):
    """5x3 pyramid {(-1,0,mu),(1,0,mu),(0,-1,mu),(0,1,mu),(0,0,1)} — same
    convention as the centroidal model (reference CentroidalMPC.cpp:186-190)."""
    return jnp.array([[-1.0, 0.0, mu], [1.0, 0.0, mu], [0.0, -1.0, mu],
                      [0.0, 1.0, mu], [0.0, 0.0, 1.0]], dtype)
