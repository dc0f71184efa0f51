"""SRBD kinodynamic model for the legged-robot OCP (nx = 24, nu = 24).

The capability equivalent of the reference's ``LeggedRobotDynamicsAD`` +
``ocs2_centroidal_model`` with ``centroidalModelType 1`` (Single Rigid Body
Dynamics, task.info:1): centroidal momentum dynamics with an SRBD inertia
frozen at the default configuration, base kinematics driven by the momentum,
and joint kinematics driven directly by the commanded joint velocities.
CppAD code generation is replaced by ``jax.jacfwd`` over closed-form JAX.

State layout (task.info:112-147):
    x = [vcom(3), L/m(3), p_base(3), eul_zyx(3), q_joints(12)]
Input layout:
    u = [contact forces (12, contact order LF RF LH RH),
         joint velocities (12, task.info order LF LH RF RH)]

Swing-leg forces are gated by the contact flags (F_eff = enable * u_F), the
same structural choice as the centroidal model.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cheeta_mpc.models.quadruped_kinematics import (
    QuadrupedDescription, euler_zyx_rate_matrix_inv, euler_zyx_to_rot,
    foot_positions_world)

GRAVITY = 9.81
NX = 24
NU = 24


class SrbdParams(NamedTuple):
    desc: QuadrupedDescription = QuadrupedDescription()
    dt: float = 0.015  # task.info:33 (multiple_shooting dt)
    integrator: str = "rk2"  # task.info integratorType RK2


def unpack_srbd_state(x):
    return (x[..., 0:3], x[..., 3:6], x[..., 6:9], x[..., 9:12],
            x[..., 12:24])


def unpack_srbd_input(u):
    nl = 4
    forces = u[..., 0:12].reshape(*u.shape[:-1], nl, 3)
    qd = u[..., 12:24]
    return forces, qd


def srbd_continuous_dynamics(params: SrbdParams, x, u, enable):
    """x_dot of the SRBD kinodynamic model. enable: (4,) contact flags."""
    desc = params.desc
    vcom, l_norm, p_base, eul, q = unpack_srbd_state(x)
    u_f, qd = unpack_srbd_input(u)
    e = enable[:, None]
    f_eff = e * u_f  # (4, 3)

    R = euler_zyx_to_rot(eul)
    com = p_base + R @ jnp.asarray(desc.com_offset, x.dtype)
    feet = foot_positions_world(desc, p_base, eul, q)  # (4, 3)

    m = desc.mass
    g_vec = jnp.array([0.0, 0.0, -GRAVITY], x.dtype)
    vcom_dot = g_vec + jnp.sum(f_eff, axis=0) / m
    l_norm_dot = jnp.sum(jnp.cross(feet - com, f_eff), axis=0) / m

    I_b = jnp.diag(jnp.asarray(desc.inertia, x.dtype))
    I_w_inv = R @ jnp.linalg.inv(I_b) @ R.T
    omega = I_w_inv @ (m * l_norm)
    eul_dot = euler_zyx_rate_matrix_inv(eul) @ omega

    return jnp.concatenate([vcom_dot, l_norm_dot, vcom, eul_dot, qd])


def srbd_step(params: SrbdParams, x, u, enable, dt=None):
    """One integration step (Euler or RK2 per task.info integratorType).

    ``dt`` overrides the nominal step — event-aligned grids have per-interval
    durations (reference getIntervalDuration, TimeDiscretization.h:64-78)."""
    dt = params.dt if dt is None else dt
    k1 = srbd_continuous_dynamics(params, x, u, enable)
    if params.integrator == "euler":
        return x + dt * k1
    # RK2 (midpoint), the reference SQP default (task.info:44).
    k2 = srbd_continuous_dynamics(params, x + 0.5 * dt * k1, u, enable)
    return x + dt * k2


def srbd_linearize(params: SrbdParams, x, u, enable, dt=None):
    """(A, B, f) exact Jacobians of the discrete step via forward AD."""
    f = srbd_step(params, x, u, enable, dt)
    A = jax.jacfwd(lambda xx: srbd_step(params, xx, u, enable, dt))(x)
    B = jax.jacfwd(lambda uu: srbd_step(params, x, uu, enable, dt))(u)
    return A, B, f


def foot_velocity_constraint_values(params: SrbdParams, x, u):
    """(4, 3) world foot velocities as a function of (x, u).

    Foot velocity = d/dt FK(p_base, eul, q) with p_base_dot = vcom,
    eul_dot from the momentum map, q_dot = commanded joint velocities —
    the quantity constrained by the reference's zero-velocity (stance,
    ZeroVelocityConstraintCppAd) and normal-velocity (swing) constraints.
    """
    desc = params.desc
    vcom, l_norm, p_base, eul, q = unpack_srbd_state(x)
    _, qd = unpack_srbd_input(u)
    R = euler_zyx_to_rot(eul)
    I_b = jnp.diag(jnp.asarray(desc.inertia, x.dtype))
    omega = (R @ jnp.linalg.inv(I_b) @ R.T) @ (desc.mass * l_norm)
    eul_dot = euler_zyx_rate_matrix_inv(eul) @ omega

    def fk(args):
        bp, be, qj = args
        return foot_positions_world(desc, bp, be, qj)

    _, vel = jax.jvp(fk, ((p_base, eul, q),), ((vcom, eul_dot, qd),))
    return vel


def weight_compensating_input(params: SrbdParams, enable, dtype=jnp.float32):
    """Reference LeggedRobotInitializer / weightCompensatingInput
    (utils.h:63-77): gravity split equally over stance feet, zero joint
    velocity."""
    import numpy as np
    stance = jnp.maximum(jnp.sum(enable), 1.0)
    fz = enable * (params.desc.mass * GRAVITY / stance)  # (4,)
    zc = jnp.zeros_like(fz)
    forces = jnp.stack([zc, zc, fz], axis=-1)  # (4, 3)
    return jnp.concatenate([forces.reshape(-1), np.zeros(12, dtype)])
