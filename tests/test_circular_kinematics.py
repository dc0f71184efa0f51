"""Dual-mode equality handling: projected vs eq-Riccati must agree.

The reference solves state-input equalities two independent ways and asserts
they give the same answer — projection/changeOfInputVariables
(MultipleShootingTranscription.cpp:67-82, ConstraintProjection.cpp:34-65)
vs handing them to the QP solver — on the circular-kinematics OCP, its
strongest solver oracle (testCircularKinematics.cpp:38,92). This file is
that oracle for this framework: `eq_mode='projected'` (null-space
elimination + input remap, ops/projection.solve_ocp_qp_projected) against
`eq_mode='riccati'` (masked eq-Riccati stage elimination, ops/riccati.py),
at the QP level and through the full SQP on a nonlinear constrained
kinematics problem.

The toy OCP (original formulation, same *capability* as the reference's):
point x in R^2 with single-integrator kinematics x_{k+1} = x_k + dt u_k,
nonlinear path equality x.u = 0 (motion tangent to the circle => radius is
conserved), quadratic cost tracking a target point on the circle. The
constraint is bilinear in (x, u), so each SQP iteration linearizes it to
C dx + D du + e = 0 with C = u', D = x', e = x.u — full row rank whenever
x != 0.
"""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import (CostApprox, DynamicsLin, OcpQpData,
                                   StageEquality)
from cheeta_mpc.ops.ocpqp import IpmSettings, solve_ocp_qp
from cheeta_mpc.ops.projection import solve_ocp_qp_projected
from cheeta_mpc.ops.riccati import lqr_forward, solve_eq_lqr
from cheeta_mpc.solvers.scp import ScpSettings, solve_nonlinear_ocp
from tests.problem_gen import add_random_constraints, random_lq_problem


def _full_rank_eq_problem(seed, N=6, nx=5, nu=4, nc=2):
    """Random LQ problem with statically-active full-row-rank equalities."""
    rng = np.random.default_rng(seed)
    data = random_lq_problem(rng, N, nx, nu)
    Ceq = rng.normal(size=(N, nc, nx))
    Deq = rng.normal(size=(N, nc, nu)) + 2.0 * np.eye(nc, nu)[None]
    e = rng.normal(size=(N, nc)) * 0.1
    eq = StageEquality(C=jnp.asarray(Ceq), D=jnp.asarray(Deq),
                       e=jnp.asarray(e), mask=jnp.ones((N, nc)))
    return data.replace(eq=eq)


def test_projected_matches_eq_riccati_qp():
    """Equality-only QP: both eliminations give the same primal + gains."""
    for seed in range(3):
        data = _full_rank_eq_problem(seed)
        ref = solve_eq_lqr(data)
        sol = solve_ocp_qp_projected(data, inner=solve_ocp_qp)
        np.testing.assert_allclose(np.asarray(sol.dx), np.asarray(ref.dx),
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(sol.du), np.asarray(ref.du),
                                   atol=1e-9)
        assert float(sol.eq_res) < 1e-9
        # The remapped feedback policy must reproduce the optimal inputs
        # when rolled forward (null-space gain projection correctness).
        dx_r, du_r = lqr_forward(data.dyn, sol.gains.K, sol.gains.k,
                                 data.dx0)
        np.testing.assert_allclose(np.asarray(du_r), np.asarray(sol.du),
                                   atol=1e-8)


def test_projected_matches_ipm_with_inequalities():
    """Equalities + active inequalities: projecting the equalities out and
    IPM-solving the reduced problem == IPM-solving the full problem.

    The inequality rows are placed around the equality-constrained optimum
    (tight=0.8 of the headroom) so the combined problem is well-posed —
    randomly-placed rows can collide with the equality manifold and leave
    both IPMs unconverged, which would compare garbage against garbage."""
    data = _full_rank_eq_problem(7, N=5, nx=4, nu=3, nc=1)
    eq_sol = solve_eq_lqr(data)
    ref = (np.asarray(eq_sol.dx), np.asarray(eq_sol.du))
    rng = np.random.default_rng(11)
    data = add_random_constraints(rng, data.replace(eq=None), ng=2,
                                  tight=0.8, ref=ref).replace(eq=data.eq)
    st = IpmSettings(iters=30)
    full = solve_ocp_qp(data, st)
    proj = solve_ocp_qp_projected(data, st)
    np.testing.assert_allclose(np.asarray(proj.dx), np.asarray(full.dx),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(proj.du), np.asarray(full.du),
                               atol=1e-6)
    assert float(proj.eq_res) < 1e-7


# ---- the nonlinear circular-kinematics OCP through the SQP ----------------

N, DT = 20, 0.1
W_X, W_U = 10.0, 0.1
X_TARGET = np.array([0.0, 1.0])  # quarter turn from the start (1, 0)


def _linearize(x, u):
    nx = nu = 2
    eyeN = jnp.broadcast_to(jnp.eye(nx), (N, nx, nx))
    A = eyeN
    B = DT * eyeN
    # Shooting defect of the iterate: f(x_k, u_k) - x_{k+1}.
    b = x[:-1] + DT * u - x[1:]
    Q = W_X * jnp.broadcast_to(jnp.eye(nx), (N + 1, nx, nx))
    q = W_X * (x - X_TARGET)
    R = W_U * eyeN
    r = W_U * u
    S = jnp.zeros((N, nu, nx))
    # x.u = 0 linearized at the iterate.
    eq = StageEquality(C=u[:, None, :], D=x[:-1][:, None, :],
                       e=jnp.sum(x[:-1] * u, axis=-1, keepdims=True),
                       mask=jnp.ones((N, 1)))
    return OcpQpData(dyn=DynamicsLin(A=A, B=B, b=b),
                     cost=CostApprox(Q=Q, q=q, R=R, r=r, S=S),
                     con=None, dx0=jnp.zeros(nx), eq=eq)


def _performance(x, u):
    from cheeta_mpc.core.types import PerformanceIndex
    cost = (0.5 * W_X * jnp.sum((x - X_TARGET) ** 2)
            + 0.5 * W_U * jnp.sum(u * u))
    d = x[:-1] + DT * u - x[1:]
    g = jnp.sum(x[:-1] * u, axis=-1)
    l1 = jnp.sum(jnp.abs(d)) + jnp.sum(jnp.abs(g))
    # rho = 10 (not the legged 1e3): the bilinear constraint's violation
    # after a step is second-order in alpha, and an oversized penalty makes
    # the filter reject every first step from the feasible-but-suboptimal
    # init (merit decrease ~ alpha, penalty growth ~ rho alpha^2).
    return PerformanceIndex(merit=cost + 10.0 * l1, cost=cost,
                            dyn_violation_sse=jnp.sum(d * d),
                            eq_constraint_sse=jnp.sum(g * g),
                            ineq_constraint_sse=jnp.zeros(()))


def _solve_circle(eq_mode):
    x0 = np.array([1.0, 0.0])
    x_init = jnp.broadcast_to(jnp.asarray(x0), (N + 1, 2)) + 0.0
    u_init = jnp.zeros((N, 2))
    st = ScpSettings(iterations=25, eq_mode=eq_mode,
                     alphas=(1.0, 0.5, 0.25, 0.125, 1 / 16, 1 / 32, 1 / 64),
                     ipm=IpmSettings(iters=10))

    def lin(x, u):
        d = _linearize(x, u)
        # SQP works in deviations around the iterate; dx0 = x0 - x[0].
        return d.replace(dx0=jnp.asarray(x0) - x[0])

    return solve_nonlinear_ocp(lin, _performance, x_init, u_init, st)


def test_circular_kinematics_both_modes():
    res_r = _solve_circle('riccati')
    res_p = _solve_circle('projected')
    for res in (res_r, res_p):
        x = np.asarray(res.x)
        u = np.asarray(res.u)
        # Reference assertions (testCircularKinematics.cpp:72-89): dynamics
        # and path-constraint SSE both ~0 at the solution.
        d = x[:-1] + DT * u - x[1:]
        assert np.sum(d * d) < 1e-9
        g = np.sum(x[:-1] * u, axis=-1)
        assert np.sum(g * g) < 1e-9
        # Discrete Euler with x.u = 0 grows the radius second-order in dt
        # (|x_{k+1}|^2 = |x|^2 + dt^2 |u|^2), so exact conservation is a
        # continuous-time property; bound the growth instead and require it
        # to be monotone (the constraint forbids radial shrinkage).
        r = np.linalg.norm(x, axis=-1)
        assert r.min() > 1.0 - 1e-6 and r.max() < 1.3
        # The target pulls the endpoint a quarter turn to the +y axis.
        assert abs(x[-1, 0]) < 0.05 and x[-1, 1] > 0.9
    # The dual-mode oracle: both equality eliminations converge to the
    # same solution (<= 1e-6, the reference's agreement criterion).
    np.testing.assert_allclose(np.asarray(res_p.x), np.asarray(res_r.x),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_p.u), np.asarray(res_r.u),
                               atol=1e-6)
