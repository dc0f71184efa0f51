"""Generic end-effector linear constraint wrapper.

The capability equivalent of the reference's ``EndEffectorLinearConstraint``
(`/root/reference/ocs2_legged_robot/src/constraint/EndEffectorLinearConstraint.cpp:38-113`):
rows ``g = Ax @ p_ee(x) + Av @ v_ee(x, u) + b`` over a foot's world position
and velocity, with per-node reconfigurable coefficients. The reference's
concrete users — ZeroVelocityConstraintCppAd (Av = I, b = 0) and
NormalVelocityConstraintCppAd (one row selecting v_z + gain * p_z - ref) —
are expressible as configs of this wrapper (factories below); the production
solver path keeps its fused ``node_eq_constraint`` for speed, certified
equivalent by tests/test_ee_constraint.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.models.quadruped_kinematics import foot_positions_world
from cheeta_mpc.models.srbd_legged import (
    foot_velocity_constraint_values, unpack_srbd_state)


class EeLinearConstraintConfig(NamedTuple):
    """Per-node coefficients (reference EndEffectorLinearConstraint::Config):
    g = Ax @ p_ee + Av @ v_ee + b, rows nc <= 3."""

    Ax: jnp.ndarray  # (nc, 3) position coefficients (zeros = unused)
    Av: jnp.ndarray  # (nc, 3) velocity coefficients
    b: jnp.ndarray  # (nc,)


def ee_linear_constraint_value(params, cfg: EeLinearConstraintConfig,
                               leg: int, x, u):
    """g(x, u) for one leg on the SRBD model."""
    _, _, p_base, eul, q = unpack_srbd_state(x)
    p_ee = foot_positions_world(params.desc, p_base, eul, q)[leg]
    v_ee = foot_velocity_constraint_values(params, x, u)[leg]
    return cfg.Ax @ p_ee + cfg.Av @ v_ee + cfg.b


def ee_linear_constraint_approx(params, cfg: EeLinearConstraintConfig,
                                leg: int, x, u):
    """(g, dg/dx, dg/du) — the reference's getLinearApproximation via
    jacfwd instead of CppAD codegen."""
    fn_x = lambda xx: ee_linear_constraint_value(params, cfg, leg, xx, u)
    fn_u = lambda uu: ee_linear_constraint_value(params, cfg, leg, x, uu)
    g = fn_x(x)
    return g, jax.jacfwd(fn_x)(x), jax.jacfwd(fn_u)(u)


def zero_velocity_config(dtype=jnp.float32) -> EeLinearConstraintConfig:
    """Stance zero-velocity rows (reference ZeroVelocityConstraintCppAd:
    v_ee = 0, 3 rows)."""
    return EeLinearConstraintConfig(Ax=np.zeros((3, 3), dtype),
                                    Av=np.eye(3, dtype=dtype),
                                    b=np.zeros((3,), dtype))


def normal_velocity_config(position_error_gain: float, z_pos_ref: float,
                           z_vel_ref: float,
                           dtype=jnp.float32) -> EeLinearConstraintConfig:
    """Swing normal-velocity row (reference NormalVelocityConstraintCppAd:
    v_z + gain * (p_z - z_ref) - zdot_ref = 0, 1 row; config injected
    per-node by the pre-computation, LeggedRobotPreComputation.cpp:44-88)."""
    Ax = np.zeros((1, 3), dtype)
    Ax[0, 2] = position_error_gain
    Av = np.zeros((1, 3), dtype)
    Av[0, 2] = 1.0
    b = np.asarray([-position_error_gain * z_pos_ref - z_vel_ref], dtype)
    return EeLinearConstraintConfig(Ax=Ax, Av=Av, b=b)
