"""Centroidal dynamics: parity with the reference equations + exact Jacobians.

Reference model: /root/reference/CentroidalMPC.cpp:41-100 (CasADi symbolic
Euler step). The numpy replica below is written directly from those equations
and the framework must match it exactly on the reference-visible state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cheeta_mpc.models.centroidal import (CentroidalParams,
                                          centroidal_step, linearize_step,
                                          pack_state, rollout,
                                          unpack_state)

NL = 4
PARAMS = CentroidalParams.create(mass=8.0, num_legs=NL, dt=0.01, mu=0.8)

step_jit = jax.jit(lambda x, u, e: centroidal_step(PARAMS, x, u, e))
step_batch = jax.jit(jax.vmap(lambda x, u, e: centroidal_step(PARAMS, x, u, e),
                              in_axes=(0, 0, None)))
lin_jit = jax.jit(lambda x, u, e: linearize_step(PARAMS, x, u, e))


def reference_step_numpy(mass, dt, com_pos, com_vel, ang_mom, foot_pos,
                         foot_vel, force, enable):
    """Literal transcription of CentroidalMPC.cpp:85-95 (Euler step)."""
    g = np.array([0.0, 0.0, -9.81])
    com_acc = g.copy()
    l_dot = np.zeros(3)
    for i in range(len(enable)):
        com_acc += enable[i] / mass * force[i]
        l_dot += enable[i] * np.cross(foot_pos[i] - com_pos, force[i])
    com_pos_n = com_pos + com_vel * dt
    com_vel_n = com_vel + com_acc * dt
    ang_mom_n = ang_mom + l_dot * dt
    foot_pos_n = foot_pos + (1 - enable[:, None]) * foot_vel * dt
    return com_pos_n, com_vel_n, ang_mom_n, foot_pos_n


def random_state_input(rng):
    com_pos = rng.normal(size=3)
    com_vel = rng.normal(size=3)
    ang_mom = rng.normal(size=3)
    foot_pos = rng.normal(size=(NL, 3))
    f_prev = rng.normal(size=(NL, 3))
    foot_vel = rng.normal(size=(NL, 3))
    force = rng.normal(size=(NL, 3)) * 10
    enable = rng.integers(0, 2, size=NL).astype(np.float64)
    x = np.concatenate([com_pos, com_vel, ang_mom, foot_pos.reshape(-1),
                        f_prev.reshape(-1)])
    u = np.concatenate([foot_vel.reshape(-1), force.reshape(-1)])
    return (com_pos, com_vel, ang_mom, foot_pos, foot_vel, force, enable, x, u)


def test_matches_reference_equations():
    rng = np.random.default_rng(0)
    for _ in range(5):
        (com_pos, com_vel, ang_mom, foot_pos, foot_vel, force, enable,
         x, u) = random_state_input(rng)
        xn = step_jit(jnp.asarray(x), jnp.asarray(u), jnp.asarray(enable))
        cp, cv, am, fp, f_prev_n = unpack_state(PARAMS, xn)
        rcp, rcv, ram, rfp = reference_step_numpy(
            8.0, 0.01, com_pos, com_vel, ang_mom, foot_pos, foot_vel, force,
            enable)
        np.testing.assert_allclose(np.asarray(cp), rcp, atol=1e-12)
        np.testing.assert_allclose(np.asarray(cv), rcv, atol=1e-12)
        np.testing.assert_allclose(np.asarray(am), ram, atol=1e-12)
        np.testing.assert_allclose(np.asarray(fp), rfp, atol=1e-12)
        # F_prev carries the *effective* force enable_i * F_i
        np.testing.assert_allclose(np.asarray(f_prev_n),
                                   enable[:, None] * force, atol=1e-12)


def test_jacobians_match_finite_differences():
    rng = np.random.default_rng(1)
    (_, _, _, _, _, _, enable, x, u) = random_state_input(rng)
    e = jnp.asarray(enable)
    A, B, f = lin_jit(jnp.asarray(x), jnp.asarray(u), e)
    eps = 1e-6
    nx, nu = PARAMS.nx, PARAMS.nu
    # Batched central differences: one vmapped call per side.
    xs_p = jnp.asarray(x)[None, :] + eps * jnp.eye(nx)
    xs_m = jnp.asarray(x)[None, :] - eps * jnp.eye(nx)
    A_fd = (step_batch(xs_p, jnp.broadcast_to(jnp.asarray(u), (nx, nu)), e)
            - step_batch(xs_m, jnp.broadcast_to(jnp.asarray(u), (nx, nu)), e)
            ).T / (2 * eps)
    np.testing.assert_allclose(np.asarray(A), np.asarray(A_fd), atol=1e-7)
    us_p = jnp.asarray(u)[None, :] + eps * jnp.eye(nu)
    us_m = jnp.asarray(u)[None, :] - eps * jnp.eye(nu)
    B_fd = (step_batch(jnp.broadcast_to(jnp.asarray(x), (nu, nx)), us_p, e)
            - step_batch(jnp.broadcast_to(jnp.asarray(x), (nu, nx)), us_m, e)
            ).T / (2 * eps)
    np.testing.assert_allclose(np.asarray(B), np.asarray(B_fd), atol=1e-7)


def test_rollout_consistency():
    rng = np.random.default_rng(2)
    (_, _, _, _, _, _, _, x, _) = random_state_input(rng)
    N = 6
    u_traj = jnp.asarray(rng.normal(size=(N, PARAMS.nu)))
    e_traj = jnp.asarray(rng.integers(0, 2, size=(N, NL)).astype(np.float64))
    xs = jax.jit(lambda a, b, c: rollout(PARAMS, a, b, c))(
        jnp.asarray(x), u_traj, e_traj)
    assert xs.shape == (N + 1, PARAMS.nx)
    x_manual = jnp.asarray(x)
    expect = [x_manual]
    for k in range(N):
        x_manual = step_jit(x_manual, u_traj[k], e_traj[k])
        expect.append(x_manual)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(jnp.stack(expect)),
                               atol=1e-12)
