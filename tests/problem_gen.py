"""Random OCP-QP generators + dense oracle solvers.

The analogue of ocs2's test fixture ``testProblemsGeneration.h`` (referenced
from testHpipmInterface.cpp): random strictly-convex LQ problems whose exact
solution can be computed densely with numpy, used to certify the structured
JAX solvers.
"""

import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import (CostApprox, DynamicsLin, OcpQpData,
                                   StageConstraint)


def random_psd(rng, n, scale=1.0, min_eig=0.1):
    M = rng.normal(size=(n, n))
    return scale * (M @ M.T / n + min_eig * np.eye(n))


def random_lq_problem(rng, N, nx, nu, dtype=np.float64, with_x0=True):
    A = rng.normal(size=(N, nx, nx)) * 0.5
    B = rng.normal(size=(N, nx, nu))
    b = rng.normal(size=(N, nx)) * 0.1
    Q = np.stack([random_psd(rng, nx) for _ in range(N + 1)])
    R = np.stack([random_psd(rng, nu, min_eig=0.5) for _ in range(N)])
    S = rng.normal(size=(N, nu, nx)) * 0.05
    q = rng.normal(size=(N + 1, nx))
    r = rng.normal(size=(N, nu))
    dx0 = rng.normal(size=nx) if with_x0 else np.zeros(nx)
    data = OcpQpData(
        dyn=DynamicsLin(A=jnp.asarray(A, dtype), B=jnp.asarray(B, dtype),
                        b=jnp.asarray(b, dtype)),
        cost=CostApprox(Q=jnp.asarray(Q, dtype), q=jnp.asarray(q, dtype),
                        R=jnp.asarray(R, dtype), r=jnp.asarray(r, dtype),
                        S=jnp.asarray(S, dtype)),
        con=None,
        dx0=jnp.asarray(dx0, dtype))
    return data


def add_random_constraints(rng, data: OcpQpData, ng, tight=0.5,
                           dtype=np.float64, ref=None):
    """Random two-sided constraints, *feasible by construction*.

    Bounds are placed around the constraint values of a reference trajectory
    that satisfies all equalities (dynamics; pass ``ref=(dx, du)`` for
    problems with stage equalities), so that trajectory is strictly interior
    — the problem is guaranteed feasible while the optimum typically pushes
    against the bounds when ``tight`` is small.
    """
    N = data.dyn.horizon
    nx, nu = data.dyn.nx, data.dyn.nu
    A = np.asarray(data.dyn.A)
    B = np.asarray(data.dyn.B)
    b = np.asarray(data.dyn.b)
    C = rng.normal(size=(N + 1, ng, nx))
    D = rng.normal(size=(N + 1, ng, nu))
    D[-1] = 0.0
    mask = (rng.uniform(size=(N + 1, ng)) < 0.9).astype(np.float64)

    if ref is None:
        du_ref = rng.normal(size=(N, nu)) * 0.3
        dx_ref = [np.asarray(data.dx0)]
        for k in range(N):
            dx_ref.append(A[k] @ dx_ref[k] + B[k] @ du_ref[k] + b[k])
        dx_ref = np.stack(dx_ref)
    else:
        dx_ref, du_ref = (np.asarray(ref[0]), np.asarray(ref[1]))
    g_ref = (np.einsum('nij,nj->ni', C, dx_ref)
             + np.einsum('nij,nj->ni', D,
                         np.concatenate([du_ref, np.zeros((1, nu))])))
    lo_w = rng.uniform(0.1, 1.0, size=(N + 1, ng))
    hi_w = rng.uniform(0.1, 1.0, size=(N + 1, ng))
    lg = g_ref - tight * lo_w
    ug = g_ref + tight * hi_w
    con = StageConstraint(C=jnp.asarray(C, dtype), D=jnp.asarray(D, dtype),
                          lg=jnp.asarray(lg, dtype), ug=jnp.asarray(ug, dtype),
                          mask=jnp.asarray(mask, dtype))
    return data.replace(con=con)


def dense_solve_equality(data: OcpQpData):
    """Dense KKT oracle for the equality-constrained (no-inequality) OCP-QP.

    Variables z = (dx_1..dx_N, du_0..du_{N-1}); dx_0 = dx0 given.
    Returns (dx, du) as numpy arrays.
    """
    A = np.asarray(data.dyn.A)
    B = np.asarray(data.dyn.B)
    b = np.asarray(data.dyn.b)
    Q = np.asarray(data.cost.Q)
    R = np.asarray(data.cost.R)
    S = np.asarray(data.cost.S)
    q = np.asarray(data.cost.q)
    r = np.asarray(data.cost.r)
    dx0 = np.asarray(data.dx0)
    N, nx, nu = A.shape[0], A.shape[1], B.shape[2]

    nz = N * nx + N * nu  # dx_1..dx_N then du_0..du_{N-1}

    def ix(k):  # dx_k for k>=1
        return slice((k - 1) * nx, k * nx)

    def iu(k):
        return slice(N * nx + k * nu, N * nx + (k + 1) * nu)

    H = np.zeros((nz, nz))
    g = np.zeros(nz)
    # Stage 0: dx_0 fixed; cost couples du_0 with the constant dx0.
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

    ne = N * nx
    E = np.zeros((ne, nz))
    h = np.zeros(ne)
    for k in range(N):
        rows = slice(k * nx, (k + 1) * nx)
        E[rows, ix(k + 1)] = -np.eye(nx)
        E[rows, iu(k)] = B[k]
        if k == 0:
            h[rows] = -(A[0] @ dx0 + b[0])
        else:
            E[rows, ix(k)] = A[k]
            h[rows] = -b[k]

    KKT = np.block([[H, E.T], [E, np.zeros((ne, ne))]])
    rhs = np.concatenate([-g, h])
    sol = np.linalg.solve(KKT, rhs)
    z = sol[:nz]
    dx = np.concatenate([dx0[None], z[:N * nx].reshape(N, nx)])
    du = z[N * nx:].reshape(N, nu)
    return dx, du
