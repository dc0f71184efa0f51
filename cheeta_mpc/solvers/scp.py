"""Sequential convex programming (SQP) over the structured IPM.

The analogue of the reference's multiple-shooting SQP solver
(``ocs2_sqp/ocs2_sqp/src/MultipleShootingSolver.cpp:146-214``): per-iteration
{linearize all shooting nodes -> solve the OCP-QP -> filter line search},
except:

- Linearization is a ``vmap`` over nodes (replacing the reference's thread
  pool + atomic work index, MultipleShootingSolver.cpp:385-449).
- The QP backend is :mod:`cheeta_mpc.ops.ocpqp` (replacing HPIPM).
- The backtracking *filter* line search (MultipleShootingSolver.cpp:509-619,
  after Waechter-Biegler) becomes a **parallel ladder**: the fixed geometric
  step-size ladder is evaluated at once and the largest step passing the
  reference's three-regime acceptance rule is selected — same semantics
  (including the ZERO step when every candidate is rejected), no
  data-dependent loop, fully jit/vmap-friendly. The three regimes
  (keyed on the *candidate's* constraint violation, exactly as the
  reference):
    viol_new > g_max                       -> CONSTRAINT: require violation
                                              decrease by factor (1-gamma_c)
    viol_new < g_min and viol_base < g_min
      and armijo descent metric < 0        -> COST: Armijo condition on merit
    otherwise                              -> DUAL: merit decrease by
                                              gamma_c*viol_base OR violation
                                              decrease
- A fixed iteration count replaces convergence exits (the deployment config
  in the reference already runs exactly 1 iteration per MPC step —
  task.info:34 — i.e. the real-time iteration scheme); convergence is still
  *classified* per the reference's checkConvergence
  (MultipleShootingSolver.cpp:621-641) and reported in the result.

The problem is supplied functionally: the caller provides a ``linearize``
callback producing the stage-stacked LQ data at an iterate, and a
``performance`` callback returning a :class:`PerformanceIndex` (merit +
cost + violation components) used by the line search and streamed to
observability (the reference logs it per iteration,
MultipleShootingSolver.cpp:190-191).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import (OcpQpData, PerformanceIndex,
                                   RiccatiGains)
from cheeta_mpc.ops.ocpqp import IpmSettings, solve_ocp_qp

# Step types (reference MultipleShootingSolverStatus.h:38-62).
STEP_ZERO = 0
STEP_CONSTRAINT = 1
STEP_DUAL = 2
STEP_COST = 3

# Convergence codes (reference multiple_shooting::Convergence).
# Deliberate reinterpretation of checkConvergence's precedence
# (MultipleShootingSolver.cpp:621-641): the reference stops at the FIRST
# iteration that converges and returns ITERATIONS once the budget runs out,
# whereas this solver always runs a fixed iteration count (vmap/jit-static)
# and classifies the FINAL step — so STEPSIZE/METRICS/PRIMAL take precedence
# and ITERATIONS is the fallback ("budget exhausted without any other
# convergence signal"). A ZERO final step therefore reports CONV_STEPSIZE
# here where the reference would report ITERATIONS; do not compare codes
# against reference semantics one-for-one.
CONV_FALSE = 0
CONV_ITERATIONS = 1
CONV_STEPSIZE = 2
CONV_METRICS = 3
CONV_PRIMAL = 4


class ScpSettings(NamedTuple):
    """Solver knobs, mirroring multiple_shooting::Settings
    (reference MultipleShootingSettings.h:40-80)."""

    iterations: int = 4  # sqpIteration (task.info:34 uses 1 = RTI)
    ipm: IpmSettings = IpmSettings()
    # Parallel line-search ladder (alpha_decay 0.5 down to alpha_min; the
    # reference backtracks sequentially, we evaluate the ladder at once).
    alphas: tuple = (1.0, 0.5, 0.25, 0.125)
    # QP backend: 'riccati' (O(N) scan, any horizon, stage equalities) or
    # 'condensed' (states eliminated, dense GEMMs; HPIPM's condensing mode
    # analogue — kept for cross-checks and as the dense oracle).
    qp_backend: str = 'riccati'
    # Stage-equality handling: 'riccati' = masked eq-Riccati elimination
    # (the framework's generalization — handles mode-dependent masks);
    # 'projected' = null-space projection + change-of-input-variables (the
    # reference's projectStateInputEqualityConstraints=true mode,
    # MultipleShootingTranscription.cpp:67-82; requires statically-active
    # full-row-rank equality rows). Both must agree — the dual-mode oracle
    # of tests/test_circular_kinematics.py (testCircularKinematics.cpp:38,92).
    eq_mode: str = 'riccati'
    # Filter-acceptance thresholds (reference defaults).
    g_max: float = 1e6
    g_min: float = 1e-6
    gamma_c: float = 1e-6
    armijo_factor: float = 1e-4
    # Convergence classification tolerances.
    cost_tol: float = 1e-4  # costTol
    delta_tol: float = 1e-6  # deltaTol
    # f32 matmul algorithm: 'highest' = full f32 (the accuracy floor the
    # oracles certify — default). On an NVIDIA GPU, 'default' and 'high'
    # let cuBLAS use TF32 tensor cores (10-bit mantissa) for f32 products.
    matmul_precision: str = 'highest'


class StepInfo(NamedTuple):
    """Per-iteration step record (reference multiple_shooting::StepInfo).
    Arrays are stacked over SQP iterations."""

    step_size: jnp.ndarray  # (iters,)
    step_type: jnp.ndarray  # (iters,) int32 STEP_* codes
    dx_norm: jnp.ndarray  # (iters,)
    du_norm: jnp.ndarray  # (iters,)
    performance: PerformanceIndex  # components per iteration (iters,)


class ScpResult(NamedTuple):
    x: jnp.ndarray  # (N+1, nx) final state trajectory iterate
    u: jnp.ndarray  # (N, nu)
    merit: jnp.ndarray  # merit value at the final iterate
    qp_mu: jnp.ndarray  # last QP complementarity (solver health)
    gains_K: jnp.ndarray  # (N, nu, nx) Riccati feedback of the last QP
    gains_k: jnp.ndarray  # (N, nu)
    gains_P: jnp.ndarray  # (N+1, nx, nx) value-function Hessians
    gains_p: jnp.ndarray  # (N+1, nx) value-function gradients
    lam_l: jnp.ndarray  # (N+1, ng) lower inequality duals of the last QP
    lam_u: jnp.ndarray  # (N+1, ng) upper inequality duals
    performance: PerformanceIndex  # at the final iterate
    step_info: StepInfo  # per-iteration line-search records
    convergence: jnp.ndarray  # int32 CONV_* classification


def _traj_norm(v: jnp.ndarray) -> jnp.ndarray:
    """sqrt of the total SSE over a stacked trajectory (reference
    trajectoryNorm, MultipleShootingSolver.cpp:499-505)."""
    return jnp.sqrt(jnp.sum(v * v))


def _total_violation(p: PerformanceIndex) -> jnp.ndarray:
    """Reference totalConstraintViolation: sqrt(dyn SSE + eq SSE)."""
    return jnp.sqrt(p.dyn_violation_sse + p.eq_constraint_sse)


def solve_nonlinear_ocp(
    linearize: Callable[[jnp.ndarray, jnp.ndarray], OcpQpData],
    performance: Callable[[jnp.ndarray, jnp.ndarray], PerformanceIndex],
    x_init: jnp.ndarray,
    u_init: jnp.ndarray,
    settings: ScpSettings = ScpSettings(),
) -> ScpResult:
    """Iterate {linearize -> IPM QP -> filter line search} a fixed number of
    times from the warm-start trajectory ``(x_init, u_init)``.

    ``linearize(x, u)`` must return the full :class:`OcpQpData` in *deviation*
    coordinates around (x, u) — including dynamics defects in ``dyn.b`` and
    the shifted constraint bounds. ``performance(x, u)`` returns the
    :class:`PerformanceIndex` at an iterate with ``merit`` already combined
    (cost + penalty on violations) — the line-search metric.
    """
    # f32 matmul precision, applied at trace time to everything the solver
    # traces — linearization, QP backends, line search. 'highest' is the
    # framework's precision floor (HPIPM/BLASFEO run f64 throughout),
    # certified by tests/test_golden_grf.py and by chip_smoke.py against the
    # f64 CPU solve (1.5e-4 N on an H100). At 'default' the GPU may run f32
    # products in TF32; on the N=10 centroidal solve that moved the forces by
    # only 1.5e-5 N on an H100, because the IPM's residuals are
    # multiply-reduce (full f32) and TF32 only perturbs the Newton matrices.
    # Longer horizons (the legged N=67 task) are not measured on a GPU yet,
    # so 'highest' stays the default.
    with jax.default_matmul_precision(settings.matmul_precision):
        return _solve_nonlinear_ocp(linearize, performance, x_init, u_init,
                                    settings)


def _solve_nonlinear_ocp(
    linearize: Callable[[jnp.ndarray, jnp.ndarray], OcpQpData],
    performance: Callable[[jnp.ndarray, jnp.ndarray], PerformanceIndex],
    x_init: jnp.ndarray,
    u_init: jnp.ndarray,
    settings: ScpSettings = ScpSettings(),
) -> ScpResult:
    alphas = np.asarray(settings.alphas, x_init.dtype)
    if settings.qp_backend == 'condensed':
        from cheeta_mpc.ops.condensed import solve_ocp_qp_condensed
        qp_solve = solve_ocp_qp_condensed
    elif settings.qp_backend == 'riccati':
        qp_solve = solve_ocp_qp
    else:
        raise ValueError(f"unknown qp_backend {settings.qp_backend!r}")
    if settings.eq_mode == 'projected':
        import functools

        from cheeta_mpc.ops.projection import solve_ocp_qp_projected
        qp_solve = functools.partial(solve_ocp_qp_projected, inner=qp_solve)
    elif settings.eq_mode != 'riccati':
        raise ValueError(f"unknown eq_mode {settings.eq_mode!r}")

    def iteration(x, u):
        data = linearize(x, u)
        sol = qp_solve(data, settings.ipm)

        base = performance(x, u)
        base_viol = _total_violation(base)
        # Armijo descent metric: cost-gradient . direction from the LQ data
        # (reference armijoDescentMetric, computed from the QP subproblem).
        armijo_metric = (jnp.sum(data.cost.q * sol.dx)
                         + jnp.sum(data.cost.r * sol.du))

        def eval_alpha(a):
            p = performance(x + a * sol.dx, u + a * sol.du)
            viol = _total_violation(p)
            acc_constraint = viol < (1.0 - settings.gamma_c) * base_viol
            acc_cost = p.merit < (base.merit
                                  + settings.armijo_factor * a * armijo_metric)
            acc_dual = ((p.merit < base.merit - settings.gamma_c * base_viol)
                        | acc_constraint)
            high = viol > settings.g_max
            low = ((viol < settings.g_min) & (base_viol < settings.g_min)
                   & (armijo_metric < 0.0))
            accepted = jnp.where(high, acc_constraint,
                                 jnp.where(low, acc_cost, acc_dual))
            st = jnp.where(high, STEP_CONSTRAINT,
                           jnp.where(low, STEP_COST, STEP_DUAL))
            return accepted, p, st

        accs, perfs, stypes = jax.vmap(eval_alpha)(alphas)
        any_acc = jnp.any(accs)
        best = jnp.where(any_acc, jnp.argmax(accs), 0)
        # ZERO step if all candidates rejected (jnp.asarray: traced index
        # into a numpy constant is not allowed).
        a = jnp.where(any_acc, jnp.asarray(alphas)[best], 0.0)
        x_new = x + a * sol.dx
        u_new = u + a * sol.du
        perf_best = jax.tree.map(lambda arr: arr[best], perfs)
        perf_after = jax.tree.map(
            lambda pb, b: jnp.where(any_acc, pb, b), perf_best, base)
        step = StepInfo(
            step_size=a,
            step_type=jnp.where(any_acc, stypes[best],
                                STEP_ZERO).astype(jnp.int32),
            dx_norm=a * _traj_norm(sol.dx),
            du_norm=a * _traj_norm(sol.du),
            performance=perf_after)
        return (x_new, u_new), (step, base.merit, sol)

    # The SQP loop is unrolled in Python (`iterations` is static and small —
    # the deployment config is 1-2, task.info:34 uses 1): unlike a lax.scan,
    # unrolling lets XLA dead-code-eliminate the per-iteration byproducts
    # nothing consumes — in particular the Riccati-gain extraction of every
    # non-final QP solve, a measurable share of batch-1 device latency.
    x, u = x_init, u_init
    per_iter = []
    for _ in range(settings.iterations):
        (x, u), rec = iteration(x, u)
        per_iter.append(rec)
    steps = jax.tree.map(lambda *xs: jnp.stack(xs), *[r[0] for r in per_iter])
    base_merits = [r[1] for r in per_iter]
    sol = per_iter[-1][2]  # final QP solution (gains/duals surface)
    mus = [r[2].mu for r in per_iter]

    last = jax.tree.map(lambda arr: arr[-1], steps)
    # Convergence classification (reference checkConvergence,
    # MultipleShootingSolver.cpp:621-641), evaluated on the final step.
    alpha_min = settings.alphas[-1]
    conv = jnp.where(
        last.step_size < alpha_min, CONV_STEPSIZE,
        jnp.where(
            (jnp.abs(last.performance.merit - base_merits[-1])
             < settings.cost_tol)
            & (_total_violation(last.performance) < settings.g_min),
            CONV_METRICS,
            jnp.where((last.dx_norm < settings.delta_tol)
                      & (last.du_norm < settings.delta_tol),
                      CONV_PRIMAL, CONV_ITERATIONS))).astype(jnp.int32)

    return ScpResult(x=x, u=u, merit=last.performance.merit, qp_mu=mus[-1],
                     gains_K=sol.gains.K, gains_k=sol.gains.k,
                     gains_P=sol.gains.P, gains_p=sol.gains.p,
                     lam_l=sol.lam_l, lam_u=sol.lam_u,
                     performance=last.performance, step_info=steps,
                     convergence=conv)


def make_performance(total_cost: Callable[..., jnp.ndarray],
                     dyn_defects: Callable[..., jnp.ndarray],
                     eq_values: Optional[Callable[..., jnp.ndarray]] = None,
                     ineq_violations: Optional[Callable[...,
                                                        jnp.ndarray]] = None,
                     rho: float = 1e3) -> Callable[..., PerformanceIndex]:
    """Assemble a ``performance(x, u) -> PerformanceIndex`` callback from
    component callbacks.

    ``dyn_defects(x, u) -> (N, nx)`` shooting defects; ``eq_values`` masked
    stage-equality values; ``ineq_violations`` nonnegative violation amounts.
    merit = cost + rho * L1(violations) — the exact-penalty metric (exact for
    rho above the largest multiplier).
    """

    def performance(x, u) -> PerformanceIndex:
        cost = total_cost(x, u)
        d = dyn_defects(x, u)
        dyn_sse = jnp.sum(d * d)
        l1 = jnp.sum(jnp.abs(d))
        eq_sse = jnp.zeros((), x.dtype)
        ineq_sse = jnp.zeros((), x.dtype)
        if eq_values is not None:
            e = eq_values(x, u)
            eq_sse = jnp.sum(e * e)
            l1 = l1 + jnp.sum(jnp.abs(e))
        if ineq_violations is not None:
            v = ineq_violations(x, u)
            ineq_sse = jnp.sum(v * v)
            l1 = l1 + jnp.sum(v)
        return PerformanceIndex(merit=cost + rho * l1, cost=cost,
                                dyn_violation_sse=dyn_sse,
                                eq_constraint_sse=eq_sse,
                                ineq_constraint_sse=ineq_sse)

    return performance
