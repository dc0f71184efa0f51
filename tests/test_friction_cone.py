"""Smoothed friction cone + relaxed barrier: derivative regressions.

Mirrors the reference's testFrictionConeConstraint.cpp:55-131 (analytic
derivatives vs numerical differentiation over random forces) — here the
"numerical" side is jax autodiff in f64, a stronger oracle than the
reference's quadratic regressor fit. Also certifies the relaxed barrier's
C2 continuity at the switch point and the PSD-ness of the Gauss-Newton cost
Hessian (the property the reference's NSD correction exists to guarantee).
"""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.mpc.friction_cone import (FrictionConeConfig,
                                          RelaxedBarrierConfig,
                                          barrier_cost_quadratic,
                                          cone_derivatives, cone_value,
                                          relaxed_barrier,
                                          relaxed_barrier_derivatives)

CONE = FrictionConeConfig(friction_coefficient=0.7, regularization=25.0,
                          gripper_force=0.0, hessian_diagonal_shift=1e-6)
BAR = RelaxedBarrierConfig(mu=0.1, delta=5.0)


def test_cone_derivatives_vs_autodiff():
    rng = np.random.default_rng(0)
    for _ in range(20):
        F = jnp.asarray(rng.normal(size=3) * 50.0 + np.array([0, 0, 100.0]))
        h, dh, d2h = cone_derivatives(CONE, F)
        assert np.allclose(h, cone_value(CONE, F))
        dh_ad = jax.grad(lambda f: cone_value(CONE, f))(F)
        d2h_ad = jax.hessian(lambda f: cone_value(CONE, f))(F)
        np.testing.assert_allclose(np.asarray(dh), np.asarray(dh_ad),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(d2h), np.asarray(d2h_ad),
                                   atol=1e-12)


def test_cone_hessian_nsd():
    """The exact constraint Hessian is negative semidefinite (the property
    the reference documents at FrictionConeConstraint.cpp:128-155)."""
    rng = np.random.default_rng(1)
    for _ in range(20):
        F = jnp.asarray(rng.normal(size=3) * 100.0)
        _, _, d2h = cone_derivatives(CONE, F)
        ev = np.linalg.eigvalsh(np.asarray(d2h))
        assert ev.max() <= 1e-12


def test_barrier_derivatives_and_c2():
    hs = np.concatenate([np.linspace(-3.0, 4.99, 37),
                         np.linspace(5.01, 50.0, 37)])
    for h in hs:
        h = jnp.asarray(h, jnp.float64)
        p, dp, ddp = relaxed_barrier_derivatives(BAR, h)
        assert np.allclose(p, relaxed_barrier(BAR, h))
        dp_ad = jax.grad(lambda x: relaxed_barrier(BAR, x))(h)
        np.testing.assert_allclose(float(dp), float(dp_ad), atol=1e-12)
    # C2 continuity at h = delta.
    eps = 1e-8
    for f in (relaxed_barrier,
              lambda c, h: relaxed_barrier_derivatives(c, h)[1],
              lambda c, h: relaxed_barrier_derivatives(c, h)[2]):
        lo = float(f(BAR, jnp.asarray(BAR.delta - eps)))
        hi = float(f(BAR, jnp.asarray(BAR.delta + eps)))
        assert abs(lo - hi) < 1e-6


def test_barrier_cost_quadratic_psd_and_grad():
    """Gauss-Newton cost Hessian is PSD; gradient matches autodiff of
    p(h(F))."""
    rng = np.random.default_rng(2)
    for _ in range(20):
        F = jnp.asarray(rng.normal(size=3) * 40.0 + np.array([0, 0, 80.0]))
        val, grad, hess = barrier_cost_quadratic(CONE, BAR, F)
        f_ad = lambda f: relaxed_barrier(BAR, cone_value(CONE, f))
        np.testing.assert_allclose(float(val), float(f_ad(F)), atol=1e-12)
        np.testing.assert_allclose(np.asarray(grad),
                                   np.asarray(jax.grad(f_ad)(F)), atol=1e-10)
        ev = np.linalg.eigvalsh(np.asarray(hess))
        assert ev.min() >= -1e-12


def test_soft_cone_legged_solve():
    """The legged task solves in soft-cone mode (reference configuration)
    with physically sane forces: stance Fz positive, swing forces zero,
    tangential forces well inside the cone away from saturation."""
    import jax.numpy as jnp
    from cheeta_mpc.mpc.legged_mpc import (LeggedMpcConfig,
                                           build_legged_solver,
                                           make_standing_reference)
    from cheeta_mpc.models.quadruped_kinematics import \
        foot_positions_world
    from cheeta_mpc.solvers.scp import ScpSettings

    N = 10
    cfg = LeggedMpcConfig.from_task_info(
        "/root/reference/ocs2_legged_robot/config/mpc/task.info",
        horizon=N, cone_mode='soft', dtype=jnp.float64)
    solve = jax.jit(build_legged_solver(cfg, ScpSettings(iterations=3)))
    default_joints = np.array([0., 0.4, -0.8, 0., -0.4, 0.8,
                               0., 0.4, -0.8, 0., -0.4, 0.8])
    feet_b = np.asarray(foot_positions_world(
        cfg.params.desc, jnp.zeros(3), jnp.zeros(3),
        jnp.asarray(default_joints)))
    x0 = np.zeros(24)
    x0[8] = -feet_b[:, 2].mean()
    x0[12:] = default_joints
    x_ref = make_standing_reference(cfg, x0)
    enable = np.ones((N, 4))
    zp = np.zeros((N, 4))
    zv = np.zeros((N, 4))
    sol = solve(x0, x_ref, enable, zp, zv)
    forces = np.asarray(sol.forces)
    assert np.isfinite(forces).all()
    # Standing: all legs share the weight, Fz > 0 on every node.
    assert (forces[:, :, 2] > 1.0).all()
    mu = cfg.friction_mu
    ft = np.sqrt(forces[:, :, 0] ** 2 + forces[:, :, 1] ** 2)
    assert (ft <= mu * forces[:, :, 2] + 1e-6).all()
    # Trot: swing forces exactly zero.
    enable_trot = np.ones((N, 4))
    enable_trot[:, 1] = 0.0
    enable_trot[:, 2] = 0.0
    sol2 = solve(x0, x_ref, enable_trot, zp, zv)
    f2 = np.asarray(sol2.forces)
    np.testing.assert_allclose(f2[:, 1, :], 0.0, atol=1e-12)
    np.testing.assert_allclose(f2[:, 2, :], 0.0, atol=1e-12)
    assert (f2[:, 0, 2] > 1.0).all()
