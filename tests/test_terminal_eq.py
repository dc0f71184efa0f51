"""Terminal-node equality constraints (round-1 VERDICT weak #10: the eq
oracle skipped active terminal rows). fold_terminal_equality pulls terminal
state equalities back through the final dynamics — exact on dynamics-feasible
trajectories (the reference hands terminal constraints to HPIPM directly,
MultipleShootingTranscription.cpp:114-130)."""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.ops.ocpqp import IpmSettings, kkt_residuals, solve_ocp_qp
from cheeta_mpc.ops.riccati import fold_terminal_equality, solve_eq_lqr
from tests.problem_gen import random_lq_problem


def test_terminal_equality_exact():
    """dx_N pinned to a reachable target on selected coordinates: the
    constraint holds to machine precision and the solution is optimal among
    dense KKT solves."""
    rng = np.random.default_rng(7)
    N, nx, nu = 8, 5, 3
    data = random_lq_problem(rng, N=N, nx=nx, nu=nu)
    # Terminal rows: first two state coordinates hit a target value.
    C_N = jnp.asarray(np.eye(nx)[:2])
    target = jnp.asarray([0.3, -0.2])
    e_N = -target
    mask_N = jnp.ones((2,))
    d2 = fold_terminal_equality(data, C_N, e_N, mask_N)
    sol = solve_eq_lqr(d2)
    dxN = np.asarray(sol.dx[-1])
    np.testing.assert_allclose(dxN[:2], np.asarray(target), atol=1e-9)

    # Optimality: dense equality-constrained KKT oracle over z = (dx, du).
    Q = np.asarray(data.cost.Q)
    R = np.asarray(data.cost.R)
    S = np.asarray(data.cost.S)
    q = np.asarray(data.cost.q)
    r = np.asarray(data.cost.r)
    A = np.asarray(data.dyn.A)
    B = np.asarray(data.dyn.B)
    b = np.asarray(data.dyn.b)
    nz = (N + 1) * nx + N * nu

    def ix(k):
        return slice(k * nx, (k + 1) * nx)

    def iu(k):
        return slice((N + 1) * nx + k * nu, (N + 1) * nx + (k + 1) * nu)

    H = np.zeros((nz, nz))
    g = np.zeros(nz)
    for k in range(N + 1):
        H[ix(k), ix(k)] = Q[k]
        g[ix(k)] = q[k]
    for k in range(N):
        H[iu(k), iu(k)] = R[k]
        H[iu(k), ix(k)] = S[k]
        H[ix(k), iu(k)] = S[k].T
        g[iu(k)] = r[k]
    # Equalities: x0, dynamics, terminal rows.
    rows = []
    rhs = []
    E0 = np.zeros((nx, nz))
    E0[:, ix(0)] = np.eye(nx)
    rows.append(E0)
    rhs.append(np.asarray(data.dx0))
    for k in range(N):
        Ek = np.zeros((nx, nz))
        Ek[:, ix(k)] = A[k]
        Ek[:, iu(k)] = B[k]
        Ek[:, ix(k + 1)] = -np.eye(nx)
        rows.append(Ek)
        rhs.append(-b[k])
    Et = np.zeros((2, nz))
    Et[:, ix(N)] = np.asarray(C_N)
    rows.append(Et)
    rhs.append(np.asarray(target))
    E = np.vstack(rows)
    h = np.concatenate(rhs)
    KKT = np.block([[H, E.T], [E, np.zeros((E.shape[0], E.shape[0]))]])
    sol_dense = np.linalg.solve(KKT, np.concatenate([-g, h]))
    z = sol_dense[:nz]
    dx_ref = z[:(N + 1) * nx].reshape(N + 1, nx)
    du_ref = z[(N + 1) * nx:].reshape(N, nu)
    np.testing.assert_allclose(np.asarray(sol.dx), dx_ref, atol=1e-8)
    np.testing.assert_allclose(np.asarray(sol.du), du_ref, atol=1e-8)


def test_terminal_equality_with_inequalities():
    """Terminal rows compose with the inequality IPM (solve_ocp_qp path)."""
    from tests.problem_gen import add_random_constraints
    rng = np.random.default_rng(11)
    data = random_lq_problem(rng, N=6, nx=4, nu=2)
    # Reachable terminal target: whatever the unconstrained solution hits,
    # nudged slightly.
    from cheeta_mpc.ops.riccati import solve_lqr
    base = solve_lqr(data)
    target = np.asarray(base.dx[-1][:1]) + 0.05
    d2 = fold_terminal_equality(data, jnp.asarray(np.eye(4)[:1]),
                                jnp.asarray(-target), jnp.ones((1,)))
    d2 = add_random_constraints(rng, d2, ng=2, tight=3.0,
                                ref=(base.dx, base.du))
    sol = solve_ocp_qp(d2, IpmSettings(iters=30))
    np.testing.assert_allclose(np.asarray(sol.dx[-1][:1]), target, atol=1e-6)
    res = kkt_residuals(d2, sol)
    assert float(res["dynamics"]) < 1e-8
    assert float(res["ineq_primal"]) < 1e-7
