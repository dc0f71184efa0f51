"""Centroidal dynamics for quadruped MPC in JAX.

Reimplements (from scratch, in JAX) the behavior of the reference's symbolic
CasADi model (``/root/reference/CentroidalMPC.cpp:41-100``):

    com_pos'  = com_pos + com_vel * dt
    com_vel'  = com_vel + (g + sum_i enable_i / m * F_i) * dt
    L'        = L + sum_i enable_i * cross(foot_pos_i - com_pos, F_i) * dt
    foot_pos' = foot_pos_i + (1 - enable_i) * foot_vel_i * dt

Differences from the reference's representation (NOT from its math):

- Forces are decision variables ``u_F`` with the *effective* force
  ``F_i = enable_i * u_F_i``. For binary enables this is exactly the reference
  dynamics (enable^2 == enable) while making swing-leg forces identically zero
  without degenerate lg==ug equality rows in the interior-point solver.
- The state is augmented with the previous effective force ``F_prev`` so the
  reference's force-rate-of-change cost (``casadi::MX::diff``,
  CentroidalMPC.cpp:227-231) becomes stage-separable for the Riccati-structured
  QP solver:  ``F_prev_{k+1} = enable_k * u_F_k``.

State layout (nx = 9 + 6*num_legs; 33 for a quadruped):
    [com_pos(3), com_vel(3), ang_momentum(3), foot_pos(3*nl), F_prev(3*nl)]
Input layout (nu = 6*num_legs; 24 for a quadruped):
    [foot_vel(3*nl), u_F(3*nl)]

Derivatives come from ``jax.jacfwd`` (replacing CasADi symbolic / CppAD
codegen); the step is a closed-form polynomial so forward-mode is exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from cheeta_mpc.core import struct

GRAVITY = 9.81


@struct.dataclass
class CentroidalParams:
    """Model parameters. ``num_legs`` is static (defines shapes)."""

    mass: jnp.ndarray  # scalar
    mu: jnp.ndarray  # (num_legs,) friction coefficients
    dt: jnp.ndarray  # scalar time step
    num_legs: int = struct.field(pytree_node=False, default=4)

    @property
    def nx(self) -> int:
        return 9 + 6 * self.num_legs

    @property
    def nu(self) -> int:
        return 6 * self.num_legs

    @property
    def nx_ref(self) -> int:
        """Reference-visible state size (no F_prev augmentation): 9 + 3*nl."""
        return 9 + 3 * self.num_legs

    @classmethod
    def create(cls, mass: float, num_legs: int, dt: float,
               mu) -> "CentroidalParams":
        """Leaves are numpy: params are captured into jitted closures,
        where numpy leaves are baked into the HLO as literals."""
        import numpy as np
        mu = np.asarray(mu)
        if mu.ndim == 0:
            mu = np.full((num_legs,), mu)
        return cls(mass=np.asarray(mass, mu.dtype), mu=mu,
                   dt=np.asarray(dt, mu.dtype), num_legs=num_legs)


def pack_state(com_pos, com_vel, ang_mom, foot_pos, f_prev):
    """foot_pos, f_prev: (num_legs, 3)."""
    return jnp.concatenate(
        [com_pos, com_vel, ang_mom, foot_pos.reshape(-1), f_prev.reshape(-1)])


def unpack_state(params: CentroidalParams, x):
    nl = params.num_legs
    com_pos = x[..., 0:3]
    com_vel = x[..., 3:6]
    ang_mom = x[..., 6:9]
    foot_pos = x[..., 9:9 + 3 * nl].reshape(*x.shape[:-1], nl, 3)
    f_prev = x[..., 9 + 3 * nl:9 + 6 * nl].reshape(*x.shape[:-1], nl, 3)
    return com_pos, com_vel, ang_mom, foot_pos, f_prev


def unpack_input(params: CentroidalParams, u):
    nl = params.num_legs
    foot_vel = u[..., 0:3 * nl].reshape(*u.shape[:-1], nl, 3)
    u_f = u[..., 3 * nl:6 * nl].reshape(*u.shape[:-1], nl, 3)
    return foot_vel, u_f


def centroidal_step(params: CentroidalParams, x, u, enable):
    """One explicit-Euler step of the centroidal dynamics.

    Args:
        x: (nx,) augmented state.
        u: (nu,) input.
        enable: (num_legs,) contact flags in {0, 1} for this step.

    Returns:
        x_next: (nx,).
    """
    com_pos, com_vel, ang_mom, foot_pos, _ = unpack_state(params, x)
    foot_vel, u_f = unpack_input(params, u)
    dt = params.dt
    e = enable[:, None]  # (nl, 1)

    f_eff = e * u_f  # (nl, 3) effective contact forces
    gravity = jnp.array([0.0, 0.0, -GRAVITY], x.dtype)
    com_acc = gravity + jnp.sum(f_eff, axis=0) / params.mass
    # enable * cross(p - c, F) == cross(p - c, enable * F) for binary enables
    l_dot = jnp.sum(jnp.cross(foot_pos - com_pos, f_eff), axis=0)

    com_pos_n = com_pos + com_vel * dt
    com_vel_n = com_vel + com_acc * dt
    ang_mom_n = ang_mom + l_dot * dt
    foot_pos_n = foot_pos + (1.0 - e) * foot_vel * dt
    f_prev_n = f_eff

    return pack_state(com_pos_n, com_vel_n, ang_mom_n, foot_pos_n, f_prev_n)


def linearize_step(params: CentroidalParams, x, u, enable):
    """(A, B, f) of the step at (x, u): exact Jacobians via forward-mode AD."""
    f = centroidal_step(params, x, u, enable)
    A = jax.jacfwd(lambda xx: centroidal_step(params, xx, u, enable))(x)
    B = jax.jacfwd(lambda uu: centroidal_step(params, x, uu, enable))(u)
    return A, B, f


def rollout(params: CentroidalParams, x0, u_traj, enable_traj):
    """Forward-simulate the horizon. u_traj: (N, nu), enable_traj: (N, nl).

    Returns the state trajectory (N+1, nx).
    """

    def body(x, inp):
        u, e = inp
        xn = centroidal_step(params, x, u, e)
        return xn, xn

    from cheeta_mpc.ops.riccati import stage_unroll
    _, xs = jax.lax.scan(body, x0, (u_traj, enable_traj),
                         unroll=stage_unroll(u_traj.shape[0]))
    return jnp.concatenate([x0[None], xs], axis=0)
