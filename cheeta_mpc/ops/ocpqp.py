"""Structured primal-dual interior-point solver for OCP-QPs.

The replacement for HPIPM (reference:
``ocs2_sqp/hpipm_catkin/src/HpipmInterface.cpp`` driving ``d_ocp_qp_ipm_solve``
with the settings in ``HpipmInterfaceSettings.h:44-57`` — predictor-corrector
IPM, Riccati-based KKT factorization, two-sided general inequalities ``lg <=
C dx + D du <= ug``). Design differences, all made so the solver is one
statically shaped, batchable XLA program:

- **Fixed iteration count** instead of data-dependent convergence exits, so the
  solver is one statically-shaped XLA program that can be ``vmap``-ed over
  thousands of scenarios with divergent convergence behavior (converged
  elements keep polishing; mu keeps shrinking, which is harmless).
- **Activity masks** instead of per-stage row counts: every node carries ``ng``
  rows, inert rows are masked out of the barrier, the step, and the
  fraction-to-boundary rule.
- **Factor once, solve twice**: the Mehrotra corrector reuses the predictor's
  Riccati factorization (the barrier Hessian depends only on (s, lambda),
  which do not change between the two) and pays only a vector backward pass.
- ``dx0`` is data, not a decision variable — no stage-0 elimination /
  reconstruction dance (reference does this manually at
  HpipmInterface.cpp:92-129 and :330-455).

Algorithm per iteration (Mehrotra predictor-corrector):
    W      = mask * (lam_l/s_l + lam_u/s_u)            barrier weights
    Qbar   = Q + C' diag(W) C   (and Rbar, Sbar with D)
    factor = riccati_factorize(A, B, Qbar, Rbar, Sbar)
    predictor: sigma = 0        -> affine direction, alpha_aff, mu_aff
    sigma  = (mu_aff/mu)^3
    corrector: r_c += ds_aff*dlam_aff - sigma*mu  -> final direction
    fraction-to-boundary (tau=0.995), separate primal/dual steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import (OcpQpData, OcpQpSolution, RiccatiGains,
                                   StageConstraint, StageEquality)
from cheeta_mpc.ops.riccati import (EqRiccatiFactors, bmv, bmv_t,
                                    lqr_forward, riccati_factorize_eq,
                                    riccati_vector_eq, solve_lqr)


class IpmSettings(NamedTuple):
    """Mirrors the knobs of hpipm_interface::Settings (reference
    HpipmInterfaceSettings.h:44-57) that matter for the fixed-iteration
    formulation."""

    iters: int = 18  # reference iter_max = 30; fixed count here
    tau: float = 0.995  # fraction-to-boundary (reference alpha_min guards)
    mu0: float = 1e1  # initial complementarity target (reference mu0 = 1e1)
    s0_min: float = 1.0  # slack clipping at init
    reg: float = 1e-9  # Riccati G regularization (reference reg_prim 1e-12)
    w_max: float = 1e10  # barrier weight clip (f32 safety; inert in f64)
    # Convergence freeze: once mu < mu_tol the element takes zero steps (the
    # fixed-iteration analogue of HPIPM's tol_comp exit; prevents numerical
    # blow-up from post-convergence barrier weights ~1/mu).
    mu_tol: float = 0.0  # 0.0 => auto by dtype (1e-8 f64, 1e-4 f32)


class _IpmState(NamedTuple):
    dx: jnp.ndarray
    du: jnp.ndarray
    s_l: jnp.ndarray
    s_u: jnp.ndarray
    lam_l: jnp.ndarray
    lam_u: jnp.ndarray


def _constraint_values(con: StageConstraint, dx, du):
    """g_n = C_n dx_n + D_n du_n with du padded at the terminal node."""
    du_pad = jnp.concatenate([du, jnp.zeros_like(du[:1])], axis=0)
    return (bmv(con.C, dx)
            + bmv(con.D, du_pad))


def _grad_at(cost, dx, du):
    """Gradient of the quadratic objective at the current iterate."""
    gq = cost.q + bmv(cost.Q, dx)
    gq = gq.at[:-1].add(bmv_t(cost.S, du))
    gr = (cost.r + bmv(cost.R, du)
          + bmv(cost.S, dx[:-1]))
    return gq, gr


def _solve_newton(data: OcpQpData, state: _IpmState,
                  factors: EqRiccatiFactors, r_dyn, r_x0, r_eq,
                  r_l, r_u, r_cl, r_cu):
    """One Newton direction for given complementarity residuals (vector pass)."""
    con = data.con
    m = con.mask
    w_l = state.lam_l / state.s_l
    w_u = state.lam_u / state.s_u
    beta = m * (w_l * r_l + w_u * r_u + r_cl / state.s_l - r_cu / state.s_u)
    lam_net = m * (state.lam_u - state.lam_l + beta)

    gq, gr = _grad_at(data.cost, state.dx, state.du)
    qbar = gq + bmv_t(con.C, lam_net)
    rbar = gr + bmv_t(con.D[:-1], lam_net[:-1])

    dyn_res = data.dyn.replace(b=r_dyn)
    kvec, p = riccati_vector_eq(dyn_res, qbar, rbar, -r_eq, data.eq.C,
                                factors)
    ddx, ddu = lqr_forward(dyn_res, factors.K, kvec, dx0=r_x0)

    dg = _constraint_values(con, ddx, ddu)
    ds_l = m * (dg + r_l)
    ds_u = m * (-dg - r_u)
    dlam_l = -m * (r_cl + state.lam_l * ds_l) / state.s_l
    dlam_u = -m * (r_cu + state.lam_u * ds_u) / state.s_u
    return ddx, ddu, ds_l, ds_u, dlam_l, dlam_u, kvec, p


def _stationarity_norm(data: OcpQpData, state: _IpmState,
                       LiD=None) -> jnp.ndarray:
    """Inf-norm of the input-space KKT stationarity at the iterate.

    Costates come from the adjoint recursion; per-stage equality duals are
    the least-squares fit ``nu_k = -LiD_k (gr_k + B' mu_{k+1})`` with
    ``LiD = (Deq Deq' + E)^{-1} Deq`` precomputed once (constraint matrices
    do not change across IPM iterations). The costate update carries
    ``Ceq' nu_k`` so equality-dual effects propagate exactly; with nc = 0
    this reduces to the plain adjoint check."""
    con = data.con
    eq = data.eq
    m = con.mask
    lam_net = m * (state.lam_u - state.lam_l)
    gq, gr = _grad_at(data.cost, state.dx, state.du)
    qbar = gq + bmv_t(con.C, lam_net)
    gru = gr + bmv_t(con.D[:-1], lam_net[:-1])
    if LiD is None:
        LiD = jnp.zeros((data.dyn.horizon, 0, data.dyn.nu), gr.dtype)

    def body(mu_next, stage):
        A, B, qk, grk, Ceqk, Deqk, LiDk = stage
        t_u = grk + bmv_t(B, mu_next)
        nu = -bmv(LiDk, t_u)
        stat_k = t_u + bmv_t(Deqk, nu)
        mu_k = qk + bmv_t(A, mu_next) + bmv_t(Ceqk, nu)
        return mu_k, stat_k

    from cheeta_mpc.ops.riccati import stage_unroll
    _, stat = jax.lax.scan(
        body, qbar[-1],
        (data.dyn.A, data.dyn.B, qbar[:-1], gru, eq.C, eq.D, LiD),
        reverse=True, unroll=stage_unroll(gru.shape[0]))
    return jnp.max(jnp.abs(stat))


def _max_step(v, dv, mask, tau):
    """Largest alpha <= 1 with v + alpha*dv >= (1-tau)*v on active rows."""
    ratio = jnp.where((dv < 0) & (mask > 0), -tau * v / jnp.minimum(dv, -1e-30),
                      jnp.inf)
    return jnp.minimum(1.0, jnp.min(ratio))


def solve_ocp_qp(data: OcpQpData,
                 settings: IpmSettings = IpmSettings(),
                 warm: Optional[_IpmState] = None) -> OcpQpSolution:
    """Solve the constrained OCP-QP. Returns primal/dual solution + gains.

    All shapes static; safe under jit/vmap. With ``data.con is None`` this
    reduces to a single Riccati solve (exact).
    """
    if data.con is None and data.eq is None:
        return solve_lqr(data, reg=settings.reg)
    dt = data.dx0.dtype
    Nh = data.dyn.horizon
    if data.con is None:
        # Equality-only problem: one exact eq-Riccati solve.
        from cheeta_mpc.ops.riccati import solve_eq_lqr
        return solve_eq_lqr(data, reg=settings.reg)
    if data.eq is None:
        zeq = StageEquality(C=np.zeros((Nh, 0, data.dyn.nx), dt),
                            D=np.zeros((Nh, 0, data.dyn.nu), dt),
                            e=np.zeros((Nh, 0), dt),
                            mask=np.zeros((Nh, 0), dt))
        data = data.replace(eq=zeq)
    eq = data.eq
    # Least-squares equality-dual operator for the stationarity metric
    # (constraint matrices are constant across IPM iterations).
    DDt = (jnp.einsum('kri,ksi->krs', eq.D, eq.D)
           + jax.vmap(jnp.diag)(1.0 - eq.mask))
    from cheeta_mpc.ops.linalg_small import spd_inverse as _spdi
    LiD = _spdi(DDt) @ eq.D  # (N, nc, nu)

    con = data.con
    m = con.mask.astype(dt)
    con = con.replace(mask=m)
    data = data.replace(con=con)
    n_active = jnp.maximum(jnp.sum(m), 1.0)
    if settings.mu_tol > 0:
        mu_tol = settings.mu_tol
    else:
        # Barrier conditioning caps achievable complementarity at roughly
        # sqrt(machine eps) x problem scale; beyond it directions degrade and
        # steps destabilize, so freeze there.
        mu_tol = 1e-9 if dt == jnp.float64 else 1e-4
    w_max = settings.w_max if dt == jnp.float64 else min(settings.w_max, 1e6)
    settings = settings._replace(w_max=w_max)

    # --- initialization -----------------------------------------------------
    if warm is None:
        dx = np.zeros((data.dyn.horizon + 1, data.dyn.nx), dt)
        du = np.zeros((data.dyn.horizon, data.dyn.nu), dt)
        g = _constraint_values(con, dx, du)
        s_l = jnp.where(m > 0, jnp.maximum(g - con.lg, settings.s0_min), 1.0)
        s_u = jnp.where(m > 0, jnp.maximum(con.ug - g, settings.s0_min), 1.0)
        lam_l = jnp.where(m > 0, settings.mu0 / s_l, 0.0)
        lam_u = jnp.where(m > 0, settings.mu0 / s_u, 0.0)
        state0 = _IpmState(dx, du, s_l, s_u, lam_l, lam_u)
    else:
        state0 = warm

    def iteration(carry, _):
        state, _, _, stat_old = carry
        g = _constraint_values(con, state.dx, state.du)
        r_l = g - state.s_l - con.lg
        r_u = g + state.s_u - con.ug
        r_dyn = (bmv(data.dyn.A, state.dx[:-1])
                 + bmv(data.dyn.B, state.du)
                 + data.dyn.b - state.dx[1:])
        r_x0 = data.dx0 - state.dx[0]
        r_eq = eq.mask * (bmv(eq.C, state.dx[:-1]) + bmv(eq.D, state.du)
                          + eq.e)
        mu = (jnp.sum(m * (state.s_l * state.lam_l + state.s_u * state.lam_u))
              / (2.0 * n_active))

        # Barrier-augmented Hessian blocks; factor once per iteration.
        w = m * jnp.minimum(state.lam_l / state.s_l + state.lam_u / state.s_u,
                            settings.w_max)
        wC = w[..., None] * con.C
        wD = w[..., None] * con.D
        Qb = data.cost.Q + jnp.einsum('nri,nrj->nij', con.C, wC)
        Rb = data.cost.R + jnp.einsum('kri,krj->kij', con.D[:-1], wD[:-1])
        Sb = data.cost.S + jnp.einsum('kri,krj->kij', con.D[:-1], wC[:-1])
        factors = riccati_factorize_eq(data.dyn, Qb, Rb, Sb, eq.C, eq.D,
                                       eq.mask, reg=settings.reg)

        # Predictor (affine direction, sigma = 0).
        r_cl = m * (state.s_l * state.lam_l)
        r_cu = m * (state.s_u * state.lam_u)
        aff = _solve_newton(data, state, factors, r_dyn, r_x0, r_eq,
                            r_l, r_u, r_cl, r_cu)
        ddx_a, ddu_a, ds_l_a, ds_u_a, dl_l_a, dl_u_a, _, _ = aff
        a_aff = jnp.minimum(
            jnp.minimum(_max_step(state.s_l, ds_l_a, m, settings.tau),
                        _max_step(state.s_u, ds_u_a, m, settings.tau)),
            jnp.minimum(_max_step(state.lam_l, dl_l_a, m, settings.tau),
                        _max_step(state.lam_u, dl_u_a, m, settings.tau)))
        mu_aff = (jnp.sum(m * ((state.s_l + a_aff * ds_l_a)
                               * (state.lam_l + a_aff * dl_l_a)
                               + (state.s_u + a_aff * ds_u_a)
                               * (state.lam_u + a_aff * dl_u_a)))
                  / (2.0 * n_active))
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-30)) ** 3, 0.0, 1.0)

        # Corrector (reuses the factorization; only the vector pass reruns).
        r_cl_c = m * (state.s_l * state.lam_l + ds_l_a * dl_l_a - sigma * mu)
        r_cu_c = m * (state.s_u * state.lam_u + ds_u_a * dl_u_a - sigma * mu)
        cor = _solve_newton(data, state, factors, r_dyn, r_x0, r_eq,
                            r_l, r_u, r_cl_c, r_cu_c)
        ddx, ddu, ds_l, ds_u, dl_l, dl_u, kvec, p = cor
        a = jnp.minimum(
            jnp.minimum(_max_step(state.s_l, ds_l, m, settings.tau),
                        _max_step(state.s_u, ds_u, m, settings.tau)),
            jnp.minimum(_max_step(state.lam_l, dl_l, m, settings.tau),
                        _max_step(state.lam_u, dl_u, m, settings.tau)))
        # Freeze converged elements: prevents post-convergence blow-up and
        # makes divergent convergence across a vmap batch harmless. An
        # element keeps iterating while stationarity is unresolved even at
        # tiny mu — the step guard below keeps that regime safe.
        a = a * ((mu > mu_tol) | (stat_old > 1e3 * mu_tol)).astype(dt)

        new = _IpmState(
            dx=state.dx + a * ddx,
            du=state.du + a * ddu,
            s_l=jnp.where(m > 0, state.s_l + a * ds_l, 1.0),
            s_u=jnp.where(m > 0, state.s_u + a * ds_u, 1.0),
            lam_l=jnp.where(m > 0, state.lam_l + a * dl_l, 0.0),
            lam_u=jnp.where(m > 0, state.lam_u + a * dl_u, 0.0),
        )
        # Stationarity guard: near convergence the barrier Hessian reaches
        # condition ~1/mu and a full step can corrupt the duals (or NaN in
        # f32). Reject steps that grow the KKT stationarity by >10x (NaN
        # comparisons are false, so NaN steps are rejected too). The norm at
        # the incoming state is carried from the previous iteration, so one
        # evaluation per iteration suffices.
        stat_new = _stationarity_norm(data, new, LiD)
        ok = stat_new <= 10.0 * (stat_old + mu)
        new = jax.tree.map(lambda n, o: jnp.where(ok, n, o), new, state)
        stat_carry = jnp.where(ok, stat_new, stat_old)
        gains = RiccatiGains(K=factors.K, k=kvec, P=factors.P, p=p)
        return (new, gains, mu, stat_carry), None

    dummy_gains = RiccatiGains(
        K=np.zeros((data.dyn.horizon, data.dyn.nu, data.dyn.nx), dt),
        k=np.zeros((data.dyn.horizon, data.dyn.nu), dt),
        P=np.zeros((data.dyn.horizon + 1, data.dyn.nx, data.dyn.nx), dt),
        p=np.zeros((data.dyn.horizon + 1, data.dyn.nx), dt))
    stat0 = _stationarity_norm(data, state0, LiD)
    (state, gains, mu, _), _ = jax.lax.scan(
        iteration, (state0, dummy_gains, jnp.asarray(jnp.inf, dt), stat0),
        None, length=settings.iters)

    # Final diagnostics.
    g = _constraint_values(con, state.dx, state.du)
    viol = jnp.maximum(con.lg - g, g - con.ug)
    ineq_res = jnp.max(jnp.where(m > 0, viol, 0.0)) if con.ng > 0 else 0.0
    r_dyn = (bmv(data.dyn.A, state.dx[:-1])
             + bmv(data.dyn.B, state.du)
             + data.dyn.b - state.dx[1:])
    gq, gr = _grad_at(data.cost, state.dx, state.du)
    lam_net = m * (state.lam_u - state.lam_l)
    stat_u = gr + bmv_t(con.D[:-1], lam_net[:-1])
    # State stationarity involves equality duals we do not store; report the
    # input-space stationarity (sufficient for convergence monitoring).
    stat_res = jnp.max(jnp.abs(stat_u + _costate_correction(data, state,
                                                            lam_net)))

    return OcpQpSolution(
        dx=state.dx, du=state.du, gains=gains,
        lam_l=state.lam_l, lam_u=state.lam_u, s_l=state.s_l, s_u=state.s_u,
        iterations=jnp.asarray(settings.iters, jnp.int32), mu=mu,
        stat_res=stat_res, ineq_res=ineq_res,
        eq_res=jnp.max(jnp.abs(r_dyn)))


def kkt_residuals(data: OcpQpData, sol: OcpQpSolution):
    """Certify a solution: KKT residuals of the convex OCP-QP.

    Returns a dict of inf-norms {stationarity, dynamics, initial, ineq_primal,
    slack_consistency, complementarity, dual_sign}. For a convex QP, all ~0
    proves global optimality — this is the framework's strongest oracle
    (the analogue of the reference's randomized known-solution QP tests,
    testHpipmInterface.cpp:112-152, but certifying *any* instance).
    """
    dx, du = sol.dx, sol.du
    gq, gr = _grad_at(data.cost, dx, du)
    if data.con is not None:
        m = data.con.mask
        lam_net = m * (sol.lam_u - sol.lam_l)
        g = _constraint_values(data.con, dx, du)
        qbar = gq + bmv_t(data.con.C, lam_net)
        stat_u = (gr + bmv_t(data.con.D[:-1], lam_net[:-1]))
    else:
        m = None
        qbar = gq
        stat_u = gr

    # Costates from the state-stationarity recursion; input stationarity is
    # then the free check.
    def body(lam_next, stage):
        A, qk = stage
        return qk + bmv_t(A, lam_next), lam_next

    from cheeta_mpc.ops.riccati import stage_unroll as _su
    _, lam_seq = jax.lax.scan(body, qbar[-1], (data.dyn.A, qbar[:-1]),
                              reverse=True, unroll=_su(data.dyn.horizon))
    stat = jnp.max(jnp.abs(stat_u + bmv_t(data.dyn.B, lam_seq)))
    r_dyn = (bmv(data.dyn.A, dx[:-1])
             + bmv(data.dyn.B, du)
             + data.dyn.b - dx[1:])
    out = {
        'stationarity': stat,
        'dynamics': jnp.max(jnp.abs(r_dyn)),
        'initial': jnp.max(jnp.abs(dx[0] - data.dx0)),
    }
    if data.con is not None:
        viol = jnp.maximum(data.con.lg - g, g - data.con.ug)
        out['ineq_primal'] = jnp.max(jnp.where(m > 0, viol, 0.0))
        out['slack_consistency'] = jnp.max(
            jnp.where(m > 0,
                      jnp.maximum(jnp.abs(g - sol.s_l - data.con.lg),
                                  jnp.abs(g + sol.s_u - data.con.ug)), 0.0))
        out['complementarity'] = jnp.max(
            jnp.where(m > 0, jnp.maximum(sol.s_l * sol.lam_l,
                                         sol.s_u * sol.lam_u), 0.0))
        out['dual_sign'] = jnp.maximum(
            jnp.max(jnp.where(m > 0, -sol.lam_l, 0.0)),
            jnp.max(jnp.where(m > 0, -sol.lam_u, 0.0)))
    return out


def _costate_correction(data: OcpQpData, state: _IpmState, lam_net):
    """B' * costate contribution to input stationarity, via adjoint scan."""
    gq, _ = _grad_at(data.cost, state.dx, state.du)
    qbar = gq + bmv_t(data.con.C, lam_net)

    def body(lam_next, stage):
        A, qk = stage
        lam = qk + A.T @ lam_next
        return lam, lam_next

    from cheeta_mpc.ops.riccati import stage_unroll as _su
    _, lam_seq = jax.lax.scan(body, qbar[-1], (data.dyn.A, qbar[:-1]),
                              reverse=True, unroll=_su(data.dyn.horizon))
    return bmv_t(data.dyn.B, lam_seq)
