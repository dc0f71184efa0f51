"""Generic EndEffectorLinearConstraint wrapper: equivalence with the fused
solver rows (reference testEndEffectorLinearConstraint.cpp analogue)."""

import jax.numpy as jnp
import numpy as np

from cheeta_mpc.mpc.ee_constraint import (EeLinearConstraintConfig,
                                          ee_linear_constraint_approx,
                                          ee_linear_constraint_value,
                                          normal_velocity_config,
                                          zero_velocity_config)
from cheeta_mpc.models.quadruped_kinematics import foot_positions_world
from cheeta_mpc.models.srbd_legged import (
    SrbdParams, foot_velocity_constraint_values, unpack_srbd_state)

P = SrbdParams()
RNG = np.random.default_rng(0)


def _random_state_input():
    x = np.zeros(24)
    x[8] = 0.45
    x[12:] = [0., 0.4, -0.8, 0., -0.4, 0.8, 0., 0.4, -0.8, 0., -0.4, 0.8]
    x += 0.05 * RNG.standard_normal(24)
    u = 0.5 * RNG.standard_normal(24)
    return jnp.asarray(x, jnp.float64), jnp.asarray(u, jnp.float64)


def test_zero_velocity_equivalence():
    """Av=I config reproduces the stance rows of the fused constraint."""
    x, u = _random_state_input()
    cfg = zero_velocity_config(jnp.float64)
    for leg in range(4):
        g = ee_linear_constraint_value(P, cfg, leg, x, u)
        v = foot_velocity_constraint_values(P, x, u)[leg]
        np.testing.assert_allclose(np.asarray(g), np.asarray(v), atol=1e-12)


def test_normal_velocity_equivalence():
    """Swing-row config reproduces v_z + gain (p_z - ref) - zdot_ref."""
    x, u = _random_state_input()
    gain, zp, zv = 20.0, 0.05, -0.4
    cfg = normal_velocity_config(gain, zp, zv, jnp.float64)
    for leg in range(4):
        g = ee_linear_constraint_value(P, cfg, leg, x, u)
        _, _, pb, eul, q = unpack_srbd_state(x)
        pz = foot_positions_world(P.desc, pb, eul, q)[leg, 2]
        vz = foot_velocity_constraint_values(P, x, u)[leg, 2]
        expect = vz + gain * (pz - zp) - zv
        np.testing.assert_allclose(float(g[0]), float(expect), atol=1e-12)


def test_linear_approximation_fd():
    """Jacobians match finite differences (reference checks CppAd against
    analytic; here jacfwd against FD)."""
    x, u = _random_state_input()
    cfg = EeLinearConstraintConfig(
        Ax=jnp.asarray(RNG.standard_normal((2, 3))),
        Av=jnp.asarray(RNG.standard_normal((2, 3))),
        b=jnp.asarray(RNG.standard_normal(2)))
    g, Cx, Du = ee_linear_constraint_approx(P, cfg, 1, x, u)
    eps = 1e-6
    for i in range(24):
        dx = np.zeros(24)
        dx[i] = eps
        gp = ee_linear_constraint_value(P, cfg, 1, x + dx, u)
        gm = ee_linear_constraint_value(P, cfg, 1, x - dx, u)
        np.testing.assert_allclose(np.asarray(Cx)[:, i],
                                   np.asarray((gp - gm) / (2 * eps)),
                                   atol=1e-5)
        up = ee_linear_constraint_value(P, cfg, 1, x, u + dx)
        um = ee_linear_constraint_value(P, cfg, 1, x, u - dx)
        np.testing.assert_allclose(np.asarray(Du)[:, i],
                                   np.asarray((up - um) / (2 * eps)),
                                   atol=1e-5)
