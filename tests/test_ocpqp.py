"""Interior-point OCP-QP solver: KKT certification + oracle checks.

For a strictly convex QP, small KKT residuals (stationarity, feasibility,
complementarity, dual signs) certify *global* optimality — a stronger oracle
than golden values. Also checks reduction to the exact Riccati solution when
no constraints are active, and vmap batching.
"""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.ops.ocpqp import IpmSettings, kkt_residuals, solve_ocp_qp
from cheeta_mpc.ops.riccati import solve_lqr
from tests.problem_gen import (add_random_constraints, dense_solve_equality,
                               random_lq_problem)

SETTINGS = IpmSettings(iters=30)


def assert_kkt(data, sol, tol):
    res = jax.tree.map(float, kkt_residuals(data, sol))
    for name, val in res.items():
        # Stationarity is the softest residual of the fixed-iteration masked
        # IPM: near the convergence freeze the barrier Hessian conditioning
        # (~1/mu) caps it around 1e-6 relative in f64 (HPIPM SPEED-mode
        # territory); feasibility and complementarity converge much deeper.
        t = 10 * tol if name == "stationarity" else tol
        assert val < t, f"KKT residual {name}={val} (all: {res})"


def test_inactive_constraints_match_lqr():
    rng = np.random.default_rng(0)
    data = random_lq_problem(rng, N=6, nx=4, nu=3)
    # Very wide bounds: nothing active -> must match the exact Riccati solve.
    data = add_random_constraints(rng, data, ng=3, tight=500.0)
    sol = solve_ocp_qp(data, SETTINGS)
    ref = solve_lqr(data)
    np.testing.assert_allclose(np.asarray(sol.du), np.asarray(ref.du),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(sol.dx), np.asarray(ref.dx),
                               atol=1e-6)
    assert_kkt(data, sol, 1e-6)


def test_active_constraints_kkt_certified():
    rng = np.random.default_rng(1)
    for trial in range(5):
        data = random_lq_problem(rng, N=8, nx=5, nu=3)
        data = add_random_constraints(rng, data, ng=4, tight=0.3)
        sol = solve_ocp_qp(data, SETTINGS)
        assert_kkt(data, sol, 1e-6)
        # Something must actually be active for this to be a meaningful test.
        g = np.einsum('nij,nj->ni', np.asarray(data.con.C),
                      np.asarray(sol.dx))
        du_pad = np.concatenate([np.asarray(sol.du),
                                 np.zeros((1, data.dyn.nu))])
        g += np.einsum('nij,nj->ni', np.asarray(data.con.D), du_pad)
        m = np.asarray(data.con.mask) > 0
        dist = np.minimum(g - np.asarray(data.con.lg),
                          np.asarray(data.con.ug) - g)
        assert np.min(dist[m]) < 1e-4, "no active rows; weak test instance"


def test_known_solution_recovery():
    """Construct a problem whose optimum is a chosen (x*, u*): set gradients
    so the unconstrained optimum is (x*,u*), constraints inactive there.
    (Style of reference testHpipmInterface.cpp:112-152.)"""
    rng = np.random.default_rng(2)
    N, nx, nu = 6, 4, 3
    data = random_lq_problem(rng, N, nx, nu)
    # Choose x*, u* consistent with dynamics.
    du_star = rng.normal(size=(N, nu))
    dx_star = [np.asarray(data.dx0)]
    A, B, b = (np.asarray(data.dyn.A), np.asarray(data.dyn.B),
               np.asarray(data.dyn.b))
    for k in range(N):
        dx_star.append(A[k] @ dx_star[k] + B[k] @ du_star[k] + b[k])
    dx_star = np.stack(dx_star)
    # Gradients that make (x*, u*) stationary with zero costates:
    Q, R, S = (np.asarray(data.cost.Q), np.asarray(data.cost.R),
               np.asarray(data.cost.S))
    q = -np.einsum('nij,nj->ni', Q, dx_star)
    q[:-1] -= np.einsum('kij,ki->kj', S, du_star)
    r = -np.einsum('kij,kj->ki', R, du_star) - np.einsum(
        'kij,kj->ki', S, dx_star[:-1])
    data = data.replace(cost=data.cost.replace(q=jnp.asarray(q),
                                               r=jnp.asarray(r)))
    sol = solve_lqr(data)
    np.testing.assert_allclose(np.asarray(sol.dx), dx_star, atol=1e-9)
    np.testing.assert_allclose(np.asarray(sol.du), du_star, atol=1e-9)
    # With wide constraints the IPM must find the same point.
    data_c = add_random_constraints(rng, data, ng=3, tight=50.0)
    sol_ipm = solve_ocp_qp(data_c, SETTINGS)
    np.testing.assert_allclose(np.asarray(sol_ipm.du), du_star, atol=1e-6)


def test_nonzero_x0_and_defects():
    """x0 != 0 and nonzero dynamics defects b_k are honored exactly."""
    rng = np.random.default_rng(3)
    data = random_lq_problem(rng, N=5, nx=4, nu=2)
    data = add_random_constraints(rng, data, ng=2, tight=0.4)
    sol = solve_ocp_qp(data, SETTINGS)
    np.testing.assert_allclose(np.asarray(sol.dx[0]), np.asarray(data.dx0),
                               atol=1e-8)
    assert_kkt(data, sol, 1e-6)


def test_vmap_and_jit():
    rng = np.random.default_rng(4)
    datas = []
    for _ in range(4):
        d = random_lq_problem(rng, N=5, nx=4, nu=3)
        datas.append(add_random_constraints(rng, d, ng=3, tight=0.4))
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    sols = jax.jit(jax.vmap(lambda d: solve_ocp_qp(d, SETTINGS)))(batched)
    for i, d in enumerate(datas):
        sol_i = jax.tree.map(lambda x, i=i: x[i], sols)
        assert_kkt(d, sol_i, 1e-5)


def test_float32_accuracy():
    """f32 (accelerator deployment dtype) stays within loose-but-useful tolerance."""
    rng = np.random.default_rng(5)
    data64 = random_lq_problem(rng, N=6, nx=4, nu=3)
    data64 = add_random_constraints(rng, data64, ng=3, tight=0.4)
    data32 = jax.tree.map(
        lambda x: x.astype(jnp.float32) if hasattr(x, 'astype') else x, data64)
    sol64 = solve_ocp_qp(data64, SETTINGS)
    sol32 = solve_ocp_qp(data32, IpmSettings(iters=25))
    np.testing.assert_allclose(np.asarray(sol32.du),
                               np.asarray(sol64.du), atol=5e-3)
