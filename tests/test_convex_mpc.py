"""Convex SRB MPC: physical sanity + KKT certification + closed loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cheeta_mpc.examples import NOMINAL_FEET, trot_table
from cheeta_mpc.models.srb import GRAVITY, SrbParams
from cheeta_mpc.mpc.convex_mpc import ConvexMpcConfig, build_convex_mpc
from cheeta_mpc.ops.ocpqp import IpmSettings

PARAMS = SrbParams(mass=9.0, inertia=(0.07, 0.26, 0.24), mu=0.5,
                   fz_max=250.0)
CFG = ConvexMpcConfig(params=PARAMS, horizon=8, dt=0.03, dtype=jnp.float64)
N = CFG.horizon


def standing_reference(x0, N):
    ref = np.tile(np.asarray(x0), (N + 1, 1))
    return ref


@pytest.fixture(scope="module")
def solver():
    return jax.jit(build_convex_mpc(CFG, IpmSettings(iters=20)))


def nominal_state(height=0.3):
    x = np.zeros(13)
    x[5] = height
    x[12] = 1.0
    return x


def test_standing_forces_share_weight(solver):
    """All-stance standing: each leg carries ~mg/4, tangentials ~0."""
    x0 = nominal_state()
    ref = standing_reference(x0, N)
    enable = np.ones((N, 4))
    forces, sol = solver(x0, ref, NOMINAL_FEET, enable)
    forces = np.asarray(forces)
    np.testing.assert_allclose(forces[:, :, 2].sum(axis=1),
                               PARAMS.mass * GRAVITY, rtol=0.02)
    assert np.abs(forces[:, :, :2]).max() < 3.0
    assert float(sol.mu) < 1e-6


def test_trot_swing_forces_zero(solver):
    x0 = nominal_state()
    ref = standing_reference(x0, N)
    enable = trot_table(N)
    forces, sol = solver(x0, ref, NOMINAL_FEET, enable)
    forces = np.asarray(forces)
    for k in range(N):
        for i in range(4):
            if enable[k, i] == 0:
                np.testing.assert_allclose(forces[k, i], 0.0, atol=1e-10)
            else:
                assert forces[k, i, 2] > 0.2 * PARAMS.mass * GRAVITY
    # Friction cone honored.
    for k in range(N):
        for i in range(4):
            if enable[k, i] > 0:
                fx, fy, fz = forces[k, i]
                assert abs(fx) <= PARAMS.mu * fz + 1e-8
                assert abs(fy) <= PARAMS.mu * fz + 1e-8
                assert fz <= PARAMS.fz_max + 1e-8


def test_height_regulation_closed_loop(solver):
    """Dropped CoM: the controller pushes up; closed loop re-tracks height."""
    from cheeta_mpc.models.srb import srb_discrete_dynamics
    x = nominal_state(height=0.27)
    ref = standing_reference(nominal_state(height=0.3), N)
    enable = np.ones((N, 4))
    for _ in range(30):
        forces, _ = solver(x, ref, NOMINAL_FEET, enable)
        A, B = srb_discrete_dynamics(PARAMS, 0.0, jnp.asarray(x[3:6]),
                                     jnp.asarray(NOMINAL_FEET),
                                     jnp.ones(4), CFG.dt, jnp.float64)
        x = np.asarray(A @ x + B @ np.asarray(forces)[0].reshape(-1))
    assert abs(x[5] - 0.3) < 0.01, f"height not regulated: {x[5]}"
    assert abs(x[11]) < 0.05  # vertical velocity settled


def test_batched_vmap(solver):
    x0 = nominal_state()
    ref = standing_reference(x0, N)
    enable = trot_table(N)
    B = 4
    xs = np.tile(x0, (B, 1))
    xs[:, 5] += 0.01 * np.arange(B)
    batched = jax.vmap(lambda x: build_convex_mpc(
        CFG, IpmSettings(iters=20))(x, jnp.asarray(ref),
                                    jnp.asarray(NOMINAL_FEET),
                                    jnp.asarray(enable)))
    forces, sols = jax.jit(batched)(jnp.asarray(xs))
    assert np.isfinite(np.asarray(forces)).all()
    assert float(jnp.max(sols.mu)) < 1e-6
