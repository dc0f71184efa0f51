"""Quadruped kinematics: geometric invariants + AD consistency."""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.models.quadruped_kinematics import (
    QuadrupedDescription, euler_zyx_rate_matrix, euler_zyx_rate_matrix_inv,
    euler_zyx_to_rot, foot_jacobians, foot_positions_world,
    foot_velocities_world)

DESC = QuadrupedDescription()


def test_rotation_orthonormal():
    rng = np.random.default_rng(0)
    for _ in range(5):
        eul = jnp.asarray(rng.uniform(-1.0, 1.0, 3))
        R = np.asarray(euler_zyx_to_rot(eul))
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)


def test_rate_matrix_inverse():
    rng = np.random.default_rng(1)
    eul = jnp.asarray(rng.uniform(-0.5, 0.5, 3))
    E = np.asarray(euler_zyx_rate_matrix(eul))
    Einv = np.asarray(euler_zyx_rate_matrix_inv(eul))
    np.testing.assert_allclose(Einv @ E, np.eye(3), atol=1e-12)


def test_rate_matrix_consistent_with_rotation_derivative():
    """omega^ = Rdot R' must equal E(eul) @ eul_dot (world angular vel)."""
    rng = np.random.default_rng(2)
    eul = jnp.asarray(rng.uniform(-0.5, 0.5, 3))
    euld = jnp.asarray(rng.normal(size=3))
    _, Rdot = jax.jvp(euler_zyx_to_rot, (eul,), (euld,))
    R = np.asarray(euler_zyx_to_rot(eul))
    Omega = np.asarray(Rdot) @ R.T
    omega = np.array([Omega[2, 1], Omega[0, 2], Omega[1, 0]])
    omega_pred = np.asarray(euler_zyx_rate_matrix(eul)) @ np.asarray(euld)
    np.testing.assert_allclose(omega, omega_pred, atol=1e-10)


def test_nominal_stance_geometry():
    """Zero joints => legs straight down; feet under hips at full leg length."""
    q = jnp.zeros(12)
    feet = np.asarray(foot_positions_world(DESC, jnp.zeros(3), jnp.zeros(3), q))
    leg_len = DESC.thigh_length + DESC.shank_length
    for leg in range(4):
        hip = np.asarray(DESC.hip_offsets[leg])
        np.testing.assert_allclose(feet[leg, 0], hip[0], atol=1e-12)
        np.testing.assert_allclose(feet[leg, 2], -leg_len, atol=1e-12)
    # Left feet have +y offset, right feet -y.
    assert feet[0, 1] > 0 and feet[2, 1] > 0  # LF, LH
    assert feet[1, 1] < 0 and feet[3, 1] < 0  # RF, RH


def test_base_transform_moves_feet_rigidly():
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.uniform(-0.5, 0.5, 12))
    f0 = np.asarray(foot_positions_world(DESC, jnp.zeros(3), jnp.zeros(3), q))
    t = jnp.asarray([0.5, -0.2, 0.1])
    eul = jnp.asarray([0.7, 0.0, 0.0])  # pure yaw
    f1 = np.asarray(foot_positions_world(DESC, t, eul, q))
    R = np.asarray(euler_zyx_to_rot(eul))
    np.testing.assert_allclose(f1, (R @ f0.T).T + np.asarray(t), atol=1e-12)


def test_velocities_match_finite_difference():
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.uniform(-0.5, 0.5, 12))
    qd = jnp.asarray(rng.normal(size=12))
    bp = jnp.asarray(rng.normal(size=3))
    be = jnp.asarray(rng.uniform(-0.3, 0.3, 3))
    bv = jnp.asarray(rng.normal(size=3))
    bed = jnp.asarray(rng.normal(size=3))
    vel = np.asarray(foot_velocities_world(DESC, bp, be, q, bv, bed, qd))
    eps = 1e-7
    f_p = foot_positions_world(DESC, bp + eps * bv, be + eps * bed,
                               q + eps * qd)
    f_m = foot_positions_world(DESC, bp - eps * bv, be - eps * bed,
                               q - eps * qd)
    vel_fd = (np.asarray(f_p) - np.asarray(f_m)) / (2 * eps)
    np.testing.assert_allclose(vel, vel_fd, atol=1e-6)


def test_jacobians_shape_and_consistency():
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.uniform(-0.5, 0.5, 12))
    J = foot_jacobians(DESC, jnp.zeros(3), jnp.zeros(3), q)
    assert J.shape == (4, 3, 18)
    # Base-position block is the identity for every foot.
    for leg in range(4):
        np.testing.assert_allclose(np.asarray(J[leg, :, 0:3]), np.eye(3),
                                   atol=1e-12)
    # Each foot depends only on its own leg's joints.
    joint_slot = {0: 0, 1: 2, 2: 1, 3: 3}
    for leg in range(4):
        for other in range(4):
            blk = np.asarray(J[leg, :, 6 + 3 * joint_slot[other]:
                               6 + 3 * joint_slot[other] + 3])
            if other == leg:
                assert np.abs(blk).max() > 1e-3
            else:
                np.testing.assert_allclose(blk, 0.0, atol=1e-12)
