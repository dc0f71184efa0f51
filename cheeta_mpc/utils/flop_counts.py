"""Analytic FLOP counts of the solver paths.

Counted from the stage shapes: the useful mathematical work of one solve
(2*m*n*k per (m,n)x(n,k) matmul; inverses ~2n^3), the same count the
reference's HPIPM would be credited with. Divided by a device time from a
profiler trace they give an achieved FLOP/s; no device peak is assumed
here.
"""

from __future__ import annotations


def riccati_ipm_flops(N: int, nx: int, nu: int, ng: int,
                      ipm_iters: int) -> float:
    """One inequality-IPM OCP-QP solve via Riccati (ops/ocpqp.solve_ocp_qp):
    per iteration one factorization + two vector/forward passes + one
    stationarity pass."""
    mm = lambda m, n, k: 2.0 * m * n * k
    # Factorization per stage: barrier blocks + Riccati update + SPD inverse.
    fact = (mm(nx, ng, nx) + mm(nu, ng, nu) + mm(nu, ng, nx)  # C'WC,D'WD,D'WC
            + mm(nx, nx, nx + nu)  # P [A B]
            + mm(nx + nu, nx, nx + nu)  # [A B]' P[A B]
            + 2.0 * nu ** 3  # SPD inverse of G
            + mm(nu, nu, nu) * 2  # refinement / K = -Gi H
            + mm(nx, nu, nx))  # H'K
    # Vector pass per stage (matvecs): qbar/rbar grads + recursion.
    vec = 2.0 * (mm(1, nx, nx) * 2 + mm(1, nu, nu) + mm(1, nu, nx) * 2
                 + mm(1, ng, nx) + mm(1, ng, nu)
                 + mm(1, nx, nx) * 2 + mm(1, nx, nu) * 2)
    # Forward rollout + constraint evaluation per stage.
    fwd = (mm(1, nx, nu) + mm(1, nx, nx) + mm(1, nu, nx)
           + mm(1, ng, nx) + mm(1, ng, nu))
    # Stationarity adjoint per stage.
    stat = mm(1, nx, nx) + mm(1, nu, nu) + mm(1, nu, nx) * 2 + mm(1, ng, nx)
    per_iter = N * (fact + 2 * (vec + fwd) + stat)
    return ipm_iters * per_iter


def centroidal_solve_flops(N: int, nx: int, nu: int, ng: int,
                           sqp_iters: int, ipm_iters: int,
                           n_alphas: int = 4) -> float:
    """One full centroidal-MPC solve: SQP iterations of {linearize (jacfwd
    dynamics + cost Hessians), QP solve, line-search ladder}. Linearization
    and line-search costs are rough (elementwise-dominated) and small next
    to the QP; the QP dominates."""
    qp = riccati_ipm_flops(N, nx, nu, ng, ipm_iters)
    # Linearization: jacfwd of the (nx -> nx) step over nx+nu tangents per
    # stage + (nx+nu)^2 cost Hessian rows.
    lin = N * (2.0 * nx * (nx + nu) * nx + 2.0 * (nx + nu) ** 2 * 4)
    ls = n_alphas * N * 2.0 * (nx * nx + ng * (nx + nu))
    return sqp_iters * (qp + lin + ls)
