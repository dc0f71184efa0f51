"""Riccati LQR kernel vs dense KKT oracle + value-function identities.

Mirrors the reference test strategy: randomized QP oracle checks
(testHpipmInterface.cpp:112-152) and the value-function consistency oracle
(ocs2_sqp testValuefunction.cpp:40-110, 1e-9 tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.ops.riccati import cost_of, solve_lqr
from tests.problem_gen import dense_solve_equality, random_lq_problem


def test_matches_dense_kkt():
    rng = np.random.default_rng(0)
    for trial in range(5):
        data = random_lq_problem(rng, N=8, nx=5, nu=3)
        sol = solve_lqr(data)
        dx_ref, du_ref = dense_solve_equality(data)
        np.testing.assert_allclose(np.asarray(sol.dx), dx_ref, atol=1e-9)
        np.testing.assert_allclose(np.asarray(sol.du), du_ref, atol=1e-9)


def test_value_function_identity():
    """V(a) - V(b) == quadratic form with P_0, p_0 for any starts a, b."""
    rng = np.random.default_rng(1)
    data = random_lq_problem(rng, N=6, nx=4, nu=2)
    P0, p0 = None, None
    vals, starts = [], []
    for _ in range(4):
        dx0 = jnp.asarray(rng.normal(size=4))
        d = data.replace(dx0=dx0)
        sol = solve_lqr(d)
        if P0 is None:
            P0, p0 = np.asarray(sol.gains.P[0]), np.asarray(sol.gains.p[0])
        vals.append(float(cost_of(d.cost, sol.dx, sol.du)))
        starts.append(np.asarray(dx0))

    def quad(a):
        return 0.5 * a @ P0 @ a + p0 @ a

    for i in range(1, 4):
        lhs = vals[i] - vals[0]
        rhs = quad(starts[i]) - quad(starts[0])
        np.testing.assert_allclose(lhs, rhs, atol=1e-9)


def test_feedback_policy_consistency():
    """K, k from one solve give the optimal du_0 for any other initial state."""
    rng = np.random.default_rng(2)
    data = random_lq_problem(rng, N=6, nx=4, nu=2)
    sol = solve_lqr(data)
    K0 = np.asarray(sol.gains.K[0])
    k0 = np.asarray(sol.gains.k[0])
    for _ in range(3):
        dx0 = rng.normal(size=4)
        sol2 = solve_lqr(data.replace(dx0=jnp.asarray(dx0)))
        np.testing.assert_allclose(np.asarray(sol2.du[0]), K0 @ dx0 + k0,
                                   atol=1e-9)


def test_vmap_batch():
    rng = np.random.default_rng(3)
    datas = [random_lq_problem(rng, N=5, nx=4, nu=3) for _ in range(4)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    sols = jax.vmap(solve_lqr)(batched)
    for i, d in enumerate(datas):
        ref = solve_lqr(d)
        np.testing.assert_allclose(np.asarray(sols.du[i]),
                                   np.asarray(ref.du), atol=1e-9)
