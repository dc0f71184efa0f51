"""Equality-constrained Riccati stage elimination vs dense KKT oracle.

The analogue of the reference's projection tests (testProjection.cpp) and
constrained-solver tests (testCircularKinematics.cpp): state-input equalities
``Ceq dx + Deq du = h`` with data-dependent activity handled by masks.
"""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import DynamicsLin
from cheeta_mpc.ops.riccati import (lqr_forward, riccati_factorize_eq,
                                    riccati_vector_eq)
from tests.problem_gen import random_lq_problem


def dense_solve_with_equalities(data, Ceq, Deq, h, mask):
    """Dense KKT with dynamics + masked stage equalities."""
    A = np.asarray(data.dyn.A); B = np.asarray(data.dyn.B)
    b = np.asarray(data.dyn.b)
    Q = np.asarray(data.cost.Q); R = np.asarray(data.cost.R)
    S = np.asarray(data.cost.S)
    q = np.asarray(data.cost.q); r = np.asarray(data.cost.r)
    dx0 = np.asarray(data.dx0)
    N, nx, nu = A.shape[0], A.shape[1], B.shape[2]

    nz = N * nx + N * nu

    def ix(k):
        return slice((k - 1) * nx, k * nx)

    def iu(k):
        return slice(N * nx + k * nu, N * nx + (k + 1) * nu)

    H = np.zeros((nz, nz)); g = np.zeros(nz)
    H[iu(0), iu(0)] += R[0]
    g[iu(0)] += r[0] + S[0] @ dx0
    for k in range(1, N):
        H[ix(k), ix(k)] += Q[k]
        H[iu(k), iu(k)] += R[k]
        H[iu(k), ix(k)] += S[k]
        H[ix(k), iu(k)] += S[k].T
        g[ix(k)] += q[k]
        g[iu(k)] += r[k]
    H[ix(N), ix(N)] += Q[N]
    g[ix(N)] += q[N]

    rows = []
    rhs_rows = []
    # dynamics equalities
    for k in range(N):
        E = np.zeros((nx, nz)); hh = np.zeros(nx)
        E[:, ix(k + 1)] = -np.eye(nx)
        E[:, iu(k)] = B[k]
        if k == 0:
            hh = -(A[0] @ dx0 + b[0])
        else:
            E[:, ix(k)] = A[k]
            hh = -b[k]
        rows.append(E); rhs_rows.append(hh)
    # active stage equalities: Ceq dx_k + Deq du_k = h
    for k in range(N):
        for j in range(Ceq.shape[1]):
            if mask[k, j] == 0:
                continue
            E = np.zeros((1, nz)); hh = np.zeros(1)
            if k > 0:
                E[0, ix(k)] = Ceq[k, j]
                hh[0] = h[k, j]
            else:
                hh[0] = h[0, j] - Ceq[0, j] @ dx0
            E[0, iu(k)] = Deq[k, j]
            rows.append(E); rhs_rows.append(hh)
    E = np.vstack(rows); he = np.concatenate(rhs_rows)
    ne = E.shape[0]
    KKT = np.block([[H, E.T], [E, np.zeros((ne, ne))]])
    sol = np.linalg.solve(KKT, np.concatenate([-g, he]))
    z = sol[:nz]
    dx = np.concatenate([dx0[None], z[:N * nx].reshape(N, nx)])
    du = z[N * nx:].reshape(N, nu)
    return dx, du


def make_problem(seed, N=6, nx=5, nu=4, nc=3):
    rng = np.random.default_rng(seed)
    data = random_lq_problem(rng, N, nx, nu)
    Ceq = rng.normal(size=(N, nc, nx))
    Deq = rng.normal(size=(N, nc, nu))
    h = rng.normal(size=(N, nc)) * 0.1
    mask = (rng.uniform(size=(N, nc)) < 0.6).astype(np.float64)
    Ceq = Ceq * mask[:, :, None]
    Deq = Deq * mask[:, :, None]
    h = h * mask
    return data, Ceq, Deq, h, mask


def solve_structured(data, Ceq, Deq, h, mask):
    f = riccati_factorize_eq(data.dyn, data.cost.Q, data.cost.R, data.cost.S,
                             jnp.asarray(Ceq), jnp.asarray(Deq),
                             jnp.asarray(mask))
    k, p = riccati_vector_eq(data.dyn, data.cost.q, data.cost.r,
                             jnp.asarray(h), jnp.asarray(Ceq), f)
    dx, du = lqr_forward(data.dyn, f.K, k, data.dx0)
    return dx, du, f, k, p


def test_matches_dense_kkt():
    for seed in range(3):
        data, Ceq, Deq, h, mask = make_problem(seed)
        dx, du, *_ = solve_structured(data, Ceq, Deq, h, mask)
        dx_ref, du_ref = dense_solve_with_equalities(data, Ceq, Deq, h, mask)
        np.testing.assert_allclose(np.asarray(dx), dx_ref, atol=1e-8)
        np.testing.assert_allclose(np.asarray(du), du_ref, atol=1e-8)


def test_equalities_satisfied():
    data, Ceq, Deq, h, mask = make_problem(7)
    dx, du, *_ = solve_structured(data, Ceq, Deq, h, mask)
    res = (np.einsum('kij,kj->ki', Ceq, np.asarray(dx[:-1]))
           + np.einsum('kij,kj->ki', Deq, np.asarray(du)) - h)
    assert np.abs(res * mask).max() < 1e-9


def test_all_masked_reduces_to_plain_lqr():
    from cheeta_mpc.ops.riccati import solve_lqr
    rng = np.random.default_rng(11)
    data = random_lq_problem(rng, 6, 5, 4)
    nc = 3
    Z = np.zeros((6, nc, 5)), np.zeros((6, nc, 4)), np.zeros((6, nc))
    dx, du, *_ = solve_structured(data, Z[0], Z[1], Z[2],
                                  np.zeros((6, nc)))
    ref = solve_lqr(data)
    np.testing.assert_allclose(np.asarray(du), np.asarray(ref.du), atol=1e-9)


def test_feedback_policy_consistency():
    """K from the equality factorization gives the optimal du_0 for any dx0
    (the equality-aware analogue of the reference LQR-gain derivation,
    doc/LQR_full.pdf referenced at MultipleShootingSolver.cpp:338)."""
    data, Ceq, Deq, h, mask = make_problem(3)
    dx, du, f, k, p = solve_structured(data, Ceq, Deq, h, mask)
    rng = np.random.default_rng(0)
    for _ in range(2):
        dx0 = rng.normal(size=5)
        d2 = data.replace(dx0=jnp.asarray(dx0))
        dx2, du2 = dense_solve_with_equalities(d2, Ceq, Deq, h, mask)
        pred = np.asarray(f.K[0]) @ dx0 + np.asarray(k[0])
        np.testing.assert_allclose(pred, du2[0], atol=1e-8)
