"""Condensed (dense) QP backend: equivalence with the Riccati backend + KKT.

The condensed solver eliminates states and runs the same Mehrotra IPM in the
input space; on any problem without stage equalities it must agree with
``solve_ocp_qp`` to solver tolerance, and its solutions must certify via
``kkt_residuals`` (global optimality for the convex QP). This mirrors HPIPM's
two interchangeable modes (partial condensing vs Riccati) behind one
interface.
"""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.ops.condensed import condense, solve_ocp_qp_condensed
from cheeta_mpc.ops.ocpqp import (IpmSettings, kkt_residuals,
                                  solve_ocp_qp)
from cheeta_mpc.ops.riccati import solve_lqr
from tests.problem_gen import add_random_constraints, random_lq_problem

SETTINGS = IpmSettings(iters=30)


def assert_kkt(data, sol, tol):
    res = jax.tree.map(float, kkt_residuals(data, sol))
    for name, val in res.items():
        t = 10 * tol if name == "stationarity" else tol
        assert val < t, f"KKT residual {name}={val} (all: {res})"


def test_condense_unconstrained_matches_lqr():
    """The condensed normal equations reproduce the exact Riccati optimum."""
    rng = np.random.default_rng(10)
    data = random_lq_problem(rng, N=7, nx=5, nu=3)
    qp = condense(data)
    z = np.linalg.solve(np.asarray(qp.H), -np.asarray(qp.g0))
    ref = solve_lqr(data)
    np.testing.assert_allclose(z.reshape(7, 3), np.asarray(ref.du), atol=1e-8)
    # State recovery operator agrees with the rollout.
    dx = np.einsum('kim,m->ki', np.asarray(qp.Phi), z) + np.asarray(qp.phi)
    np.testing.assert_allclose(dx, np.asarray(ref.dx), atol=1e-8)


def test_condensed_matches_riccati_backend():
    rng = np.random.default_rng(11)
    for trial in range(4):
        data = random_lq_problem(rng, N=8, nx=5, nu=3)
        data = add_random_constraints(rng, data, ng=4, tight=0.3)
        sol_c = solve_ocp_qp_condensed(data, SETTINGS)
        sol_r = solve_ocp_qp(data, SETTINGS)
        assert_kkt(data, sol_c, 1e-6)
        np.testing.assert_allclose(np.asarray(sol_c.du),
                                   np.asarray(sol_r.du), atol=1e-5)
        np.testing.assert_allclose(np.asarray(sol_c.dx),
                                   np.asarray(sol_r.dx), atol=1e-5)
        # Duals agree too (strict convexity => unique KKT multipliers on
        # non-degenerate instances).
        np.testing.assert_allclose(np.asarray(sol_c.lam_l),
                                   np.asarray(sol_r.lam_l), atol=1e-4)


def test_condensed_gains_consistency():
    """The returned Riccati K must satisfy the feedback-policy identity: for
    a perturbed initial state, re-solving gives du_0' ~= du_0 + K_0 (dx0' -
    dx0) when no constraint-activity change occurs (wide bounds)."""
    rng = np.random.default_rng(12)
    data = random_lq_problem(rng, N=6, nx=4, nu=3)
    data = add_random_constraints(rng, data, ng=3, tight=100.0)
    sol = solve_ocp_qp_condensed(data, SETTINGS)
    delta = 1e-3 * rng.normal(size=4)
    data2 = data.replace(dx0=data.dx0 + jnp.asarray(delta))
    sol2 = solve_ocp_qp_condensed(data2, SETTINGS)
    pred = np.asarray(sol.du[0]) + np.asarray(sol.gains.K[0]) @ delta
    np.testing.assert_allclose(np.asarray(sol2.du[0]), pred, atol=1e-6)


def test_condensed_vmap_jit():
    rng = np.random.default_rng(13)
    datas = []
    for _ in range(4):
        d = random_lq_problem(rng, N=5, nx=4, nu=3)
        datas.append(add_random_constraints(rng, d, ng=3, tight=0.4))
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    sols = jax.jit(jax.vmap(
        lambda d: solve_ocp_qp_condensed(d, SETTINGS)))(batched)
    for i, d in enumerate(datas):
        sol_i = jax.tree.map(lambda x, i=i: x[i], sols)
        assert_kkt(d, sol_i, 1e-5)


def test_condensed_float32():
    rng = np.random.default_rng(14)
    data64 = random_lq_problem(rng, N=6, nx=4, nu=3)
    data64 = add_random_constraints(rng, data64, ng=3, tight=0.4)
    data32 = jax.tree.map(
        lambda x: x.astype(jnp.float32) if hasattr(x, 'astype') else x,
        data64)
    sol64 = solve_ocp_qp(data64, SETTINGS)
    sol32 = solve_ocp_qp_condensed(data32, IpmSettings(iters=25))
    # f32 accuracy is limited by the convergence freeze (mu_tol 1e-4), not
    # the backend: the Riccati backend errs 0.009 on this instance in f32.
    # End-to-end f32 quality is certified by the centroidal GRF-match test
    # at 1e-3 on the physical outputs.
    np.testing.assert_allclose(np.asarray(sol32.du),
                               np.asarray(sol64.du), atol=2e-2)


def test_condensed_rejects_stage_equalities():
    import pytest
    from cheeta_mpc.core.types import StageEquality
    rng = np.random.default_rng(15)
    data = random_lq_problem(rng, N=4, nx=3, nu=2)
    eq = StageEquality(C=jnp.zeros((4, 1, 3)), D=jnp.zeros((4, 1, 2)),
                       e=jnp.zeros((4, 1)), mask=jnp.ones((4, 1)))
    with pytest.raises(ValueError):
        solve_ocp_qp_condensed(data.replace(eq=eq), SETTINGS)
