"""Gauss-Newton DDP: LQR exactness + nonlinear convergence + penalties."""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import CostApprox, DynamicsLin, OcpQpData
from cheeta_mpc.models.centroidal import CentroidalParams, centroidal_step
from cheeta_mpc.ops.riccati import solve_lqr
from cheeta_mpc.solvers.ddp import (DdpSettings, relaxed_barrier,
                                    solve_ddp)
from tests.problem_gen import random_lq_problem


def test_lqr_problem_solved_in_one_iteration():
    """On a linear-quadratic problem, DDP with alpha = 1 is exact LQR."""
    rng = np.random.default_rng(0)
    data = random_lq_problem(rng, N=8, nx=4, nu=3, with_x0=True)
    A, B, b = data.dyn.A, data.dyn.B, data.dyn.b
    Q, R, S, q, r = (data.cost.Q, data.cost.R, data.cost.S, data.cost.q,
                     data.cost.r)

    def step(k, x, u):
        return A[k] @ x + B[k] @ u + b[k]

    def stage_cost(k, x, u):
        return (0.5 * x @ Q[k] @ x + 0.5 * u @ R[k] @ u + u @ S[k] @ x
                + q[k] @ x + r[k] @ u)

    def terminal_cost(x):
        return 0.5 * x @ Q[-1] @ x + q[-1] @ x

    res = solve_ddp(step, stage_cost, terminal_cost, data.dx0,
                    jnp.zeros((8, 3)), DdpSettings(iterations=2, reg=0.0))
    ref = solve_lqr(data)
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(ref.du),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.dx),
                               atol=1e-8)


def test_centroidal_tracking_converges():
    """DDP on the (bilinear) centroidal dynamics reduces cost monotonically
    and reaches a near-stationary point."""
    params = CentroidalParams.create(mass=8.0, num_legs=4, dt=0.01, mu=0.8)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    N = 8
    enable = jnp.ones((N, 4))
    x0 = jnp.zeros(33).at[2].set(0.3)
    x_des = jnp.zeros(33).at[2].set(0.35).at[0].set(0.05)
    f_ff = 8.0 * 9.81 / 4

    def step(k, x, u):
        return centroidal_step(params, x, u, enable[k])

    def stage_cost(k, x, u):
        u_ref = jnp.zeros(24).at[14::3].set(0.0)
        forces = u[12:]
        fz_err = forces.reshape(4, 3)[:, 2] - f_ff
        return (10.0 * jnp.sum((x[:9] - x_des[:9]) ** 2)
                + 1e-3 * jnp.sum(fz_err ** 2)
                + 1e-3 * jnp.sum(forces.reshape(4, 3)[:, :2] ** 2)
                + 1e-4 * jnp.sum(u[:12] ** 2))

    def terminal_cost(x):
        return 10.0 * jnp.sum((x[:9] - x_des[:9]) ** 2)

    u0 = jnp.zeros((N, 24)).at[:, 14::3].set(f_ff)
    res5 = solve_ddp(step, stage_cost, terminal_cost, x0, u0,
                     DdpSettings(iterations=5))
    res8 = solve_ddp(step, stage_cost, terminal_cost, x0, u0,
                     DdpSettings(iterations=8))
    assert float(res8.cost) <= float(res5.cost) + 1e-9
    # Extra iterations barely move the solution: near-stationary.
    assert np.abs(np.asarray(res8.u) - np.asarray(res5.u)).max() < 1e-3
    # Rigorous convergence check: gradient of the shooting objective J(u)
    # (states eliminated by rollout) vanishes at the DDP solution.
    def shooting_objective(u_traj):
        def body(x, ku):
            k, u = ku
            xn = step(k, x, u)
            return xn, stage_cost(k, x, u)
        xN, cs = jax.lax.scan(body, x0, (jnp.arange(N), u_traj))
        return jnp.sum(cs) + terminal_cost(xN)

    grad = np.asarray(jax.grad(shooting_objective)(res8.u))
    assert np.abs(grad).max() < 1e-5, f"not stationary: {np.abs(grad).max()}"


def test_relaxed_barrier_properties():
    """Matches -mu*ln(h) above delta; smooth quadratic extension below."""
    mu, delta = 0.1, 5.0
    hs = np.linspace(6.0, 50.0, 10)
    np.testing.assert_allclose(
        np.asarray(relaxed_barrier(jnp.asarray(hs), mu, delta)),
        -mu * np.log(hs), atol=1e-12)
    # Continuity and C1 at h = delta.
    eps = 1e-6
    lo = float(relaxed_barrier(jnp.asarray(delta - eps), mu, delta))
    hi = float(relaxed_barrier(jnp.asarray(delta + eps), mu, delta))
    assert abs(lo - hi) < 1e-5
    g = jax.grad(lambda h: relaxed_barrier(h, mu, delta))
    assert abs(float(g(jnp.asarray(delta - eps)))
               - float(g(jnp.asarray(delta + eps)))) < 1e-4
    # Penalty grows as constraints are violated.
    assert float(relaxed_barrier(jnp.asarray(-1.0), mu, delta)) > \
        float(relaxed_barrier(jnp.asarray(1.0), mu, delta))
