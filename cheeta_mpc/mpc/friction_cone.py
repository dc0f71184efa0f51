"""Smoothed friction cone + relaxed log-barrier penalty (soft constraint).

The re-creation of the reference's legged-task friction handling
(`/root/reference/ocs2_legged_robot/src/constraint/FrictionConeConstraint.cpp`
wrapped in a RelaxedBarrierPenalty StateInputSoftConstraint,
`LeggedRobotInterface.cpp:313-325`, config task.info:215-222):

    h(F) = mu * (F_z + gripperForce) - sqrt(F_x^2 + F_y^2 + regularization)

is a *smoothed* second-order cone (regularization 25 rounds the tip), treated
as a penalty cost ``penalty(h)`` with the OCS2 relaxed log barrier

    p(h) = -mu_b * ln(h)                                    h >= delta
    p(h) = mu_b/2 * (((h - 2 delta)/delta)^2 - 1) - mu_b*ln(delta)   h < delta

(quadratic extension keeps the penalty defined for infeasible h — the
"relaxed" part; C2-continuous at h = delta).

Derivatives are analytic, matching the reference's closed forms
(FrictionConeConstraint.cpp:128-155) including the hessianDiagonalShift
(-1e-6 on the diagonal of the constraint Hessian, :183-210) that keeps the
Gauss-Newton Hessian negative-semidefinite-corrected.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp


class FrictionConeConfig(NamedTuple):
    """FrictionConeConstraint::Config (reference FrictionConeConstraint.h:
    65-81)."""

    friction_coefficient: float = 0.7
    regularization: float = 25.0
    gripper_force: float = 0.0
    hessian_diagonal_shift: float = 1e-6


class RelaxedBarrierConfig(NamedTuple):
    """RelaxedBarrierPenalty::Config (ocs2_core; values from task.info:
    215-222)."""

    mu: float = 0.1
    delta: float = 5.0


def cone_value(cfg: FrictionConeConfig, F):
    """h(F) for F: (..., 3) local contact force
    (reference coneConstraint, FrictionConeConstraint.cpp:157-163)."""
    t2 = F[..., 0] ** 2 + F[..., 1] ** 2 + cfg.regularization
    return (cfg.friction_coefficient * (F[..., 2] + cfg.gripper_force)
            - jnp.sqrt(t2))


def cone_derivatives(cfg: FrictionConeConfig, F) -> Tuple[jnp.ndarray,
                                                          jnp.ndarray,
                                                          jnp.ndarray]:
    """(h, dh/dF (...,3), d2h/dF2 (...,3,3)) — analytic closed forms
    (reference computeConeLocalDerivatives, FrictionConeConstraint.cpp:
    128-155). The Hessian is exact (and NSD); the reference's
    hessianDiagonalShift is NOT applied here — see
    :func:`barrier_cost_quadratic`."""
    Fx, Fy = F[..., 0], F[..., 1]
    t2 = Fx ** 2 + Fy ** 2 + cfg.regularization
    tn = jnp.sqrt(t2)
    t32 = tn * t2
    h = cfg.friction_coefficient * (F[..., 2] + cfg.gripper_force) - tn
    dh = jnp.stack([-Fx / tn, -Fy / tn,
                    jnp.full_like(Fx, cfg.friction_coefficient)], axis=-1)
    z = jnp.zeros_like(Fx)
    d2h = jnp.stack([
        jnp.stack([-(Fy ** 2 + cfg.regularization) / t32, Fx * Fy / t32, z],
                  axis=-1),
        jnp.stack([Fx * Fy / t32, -(Fx ** 2 + cfg.regularization) / t32, z],
                  axis=-1),
        jnp.stack([z, z, z], axis=-1),
    ], axis=-2)
    return h, dh, d2h


def relaxed_barrier(cfg: RelaxedBarrierConfig, h):
    """p(h): relaxed log barrier value (ocs2 RelaxedBarrierPenalty)."""
    mu, delta = cfg.mu, cfg.delta
    safe_h = jnp.maximum(h, delta)  # keeps ln defined off-branch
    log_part = -mu * jnp.log(safe_h)
    quad_part = (mu / 2.0) * (((h - 2.0 * delta) / delta) ** 2 - 1.0) \
        - mu * jnp.log(delta)
    return jnp.where(h >= delta, log_part, quad_part)


def relaxed_barrier_derivatives(cfg: RelaxedBarrierConfig, h):
    """(p, p', p'') of the relaxed barrier — C2 at h = delta."""
    mu, delta = cfg.mu, cfg.delta
    safe_h = jnp.maximum(h, delta)
    p_log = -mu * jnp.log(safe_h)
    dp_log = -mu / safe_h
    ddp_log = mu / (safe_h ** 2)
    p_quad = (mu / 2.0) * (((h - 2.0 * delta) / delta) ** 2 - 1.0) \
        - mu * jnp.log(delta)
    dp_quad = mu * (h - 2.0 * delta) / delta ** 2
    ddp_quad = jnp.full_like(h, mu / delta ** 2)
    use_log = h >= delta
    return (jnp.where(use_log, p_log, p_quad),
            jnp.where(use_log, dp_log, dp_quad),
            jnp.where(use_log, ddp_log, ddp_quad))


def barrier_cost_quadratic(cone: FrictionConeConfig,
                           barrier: RelaxedBarrierConfig, F):
    """Quadratic approximation of ``p(h(F))`` at F: (value, grad (...,3),
    hess (...,3,3)).

    Chain rule with the reference's treatment: the Gauss-Newton term
    ``p'' dh dh'`` plus the exact-curvature term ``p' d2h`` with the
    hessianDiagonalShift folded into d2h (reference
    frictionConeSecondDerivativeInput, FrictionConeConstraint.cpp:196-203:
    the shift is subtracted from the *constraint* Hessian diagonal, so after
    multiplication by p' < 0 it adds a positive diagonal to the cost)."""
    h, dh, d2h = cone_derivatives(cone, F)
    p, dp, ddp = relaxed_barrier_derivatives(barrier, h)
    eye = jnp.eye(3, dtype=F.dtype)
    d2h_shifted = d2h - cone.hessian_diagonal_shift * eye
    grad = dp[..., None] * dh
    hess = (ddp[..., None, None] * dh[..., :, None] * dh[..., None, :]
            + dp[..., None, None] * d2h_shifted)
    return p, grad, hess
