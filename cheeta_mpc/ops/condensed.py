"""Condensed (dense) interior-point solver for OCP-QPs.

HPIPM — the reference's QP backend (driven from
``ocs2_sqp/hpipm_catkin/src/HpipmInterface.cpp:281-301``) — ships both a
Riccati-recursion OCP solver and a *condensing* mode that eliminates the
states and solves a dense QP in the inputs. This module is that
condensing backend: the dense per-scenario operators (``N*nu`` ~ a few
hundred at short horizons) are batched GEMMs, whereas the Riccati scan is a
chain of tiny matmuls; the Riccati scan (ops/riccati.py) is O(N) against
O(N^3) here, so it wins at long horizons.

The IPM itself is the same Mehrotra predictor-corrector as
:func:`cheeta_mpc.ops.ocpqp.solve_ocp_qp` (fixed iteration count,
activity masks, factor-once/solve-twice, convergence freeze, stationarity
step guard) so the two backends are interchangeable; only the linear-algebra
kernel differs. Riccati gains (K, k, P, p — the policy surface the reference
extracts from HPIPM at HpipmInterface.cpp:330-455) are recovered by one
backward pass on the final barrier-augmented cost, outside the iteration
loop.

Elimination (all per scenario; batching is vmap/jit over a leading axis):
    dX = Phi dU + phi          Phi: ((N+1)*nx, N*nu) block lower triangular
    H  = Rbar + Phi' Qbar Phi + sym(Sblk Phi)        dense (N*nu, N*nu)
    Ghat = Cblk Phi + Dblk                           dense (rows, N*nu)
with ``phi`` carrying both the initial state and the affine defects ``b``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import (OcpQpData, OcpQpSolution, RiccatiGains,
                                   symmetrize)
from cheeta_mpc.ops.ocpqp import IpmSettings, _max_step
from cheeta_mpc.ops.riccati import (bmv, riccati_factorize, riccati_vector)


class CondensedQp(NamedTuple):
    """The dense QP ``min 1/2 z'Hz + g0'z  s.t. lg <= Ghat z + ghat <= ug``
    plus the state-recovery operators."""

    H: jnp.ndarray  # (M, M), M = N*nu
    g0: jnp.ndarray  # (M,)
    Ghat: jnp.ndarray  # (Rows, M), Rows = (N+1)*ng
    ghat: jnp.ndarray  # (Rows,)
    lg: jnp.ndarray  # (Rows,)
    ug: jnp.ndarray  # (Rows,)
    mask: jnp.ndarray  # (Rows,)
    Phi: jnp.ndarray  # (N+1, nx, M)
    phi: jnp.ndarray  # (N+1, nx)


def condense(data: OcpQpData) -> CondensedQp:
    """Eliminate the states from an OCP-QP (no stage equalities).

    The state trajectory is affine in the stacked inputs:
    ``dx = Phi z + phi`` with ``phi_0 = dx0``, ``phi_{k+1} = A phi_k + b_k``.
    """
    if data.eq is not None and data.eq.nc > 0:
        raise ValueError("condensed backend does not support stage "
                         "equalities; use the Riccati backend")
    dyn, cost, con = data.dyn, data.cost, data.con
    N, nx, nu = dyn.horizon, dyn.nx, dyn.nu
    M = N * nu
    dt = data.dx0.dtype

    def prop(carry, stage):
        row, ph, k = carry
        A, B, b = stage
        row = A @ row
        row = jax.lax.dynamic_update_slice(row, B, (0, k * nu))
        ph = A @ ph + b
        return (row, ph, k + 1), (row, ph)

    row0 = np.zeros((nx, M), dt)
    (_, _, _), (rows, phis) = jax.lax.scan(
        prop, (row0, data.dx0, 0), (dyn.A, dyn.B, dyn.b))
    Phi = jnp.concatenate([row0[None], rows], axis=0)  # (N+1, nx, M)
    phi = jnp.concatenate([data.dx0[None], phis], axis=0)

    # H = Rbar + Phi' Qbar Phi + sym(Sblk Phi); contraction over (N+1)*nx.
    QPhi = jnp.einsum('kij,kjm->kim', cost.Q, Phi)
    H = jnp.einsum('kim,kin->mn', Phi, QPhi)
    H = H.reshape(N, nu, N, nu)
    idx = np.arange(N)
    H = H.at[idx, :, idx, :].add(cost.R)
    H = H.reshape(M, M)
    SPhi = jnp.einsum('kij,kjm->kim', cost.S, Phi[:-1]).reshape(M, M)
    H = H + SPhi + SPhi.T
    H = symmetrize(H)

    # g0 = rbar + Sblk phi + Phi'(Qbar phi + qbar).
    y = jnp.einsum('kij,kj->ki', cost.Q, phi) + cost.q
    g0 = (cost.r + jnp.einsum('kij,kj->ki', cost.S, phi[:-1])).reshape(M)
    g0 = g0 + jnp.einsum('kim,ki->m', Phi, y)

    if con is None:
        z = np.zeros((0,), dt)
        return CondensedQp(H=H, g0=g0, Ghat=np.zeros((0, M), dt), ghat=z,
                           lg=z, ug=z, mask=z, Phi=Phi, phi=phi)

    ng = con.ng
    U = jnp.einsum('kij,kjm->kim', con.C, Phi)  # (N+1, ng, M)
    U = U.reshape(N + 1, ng, N, nu)
    U = U.at[idx, :, idx, :].add(con.D[:-1])
    Ghat = U.reshape((N + 1) * ng, M)
    ghat = jnp.einsum('kij,kj->ki', con.C, phi).reshape(-1)
    return CondensedQp(H=H, g0=g0, Ghat=Ghat, ghat=ghat,
                       lg=con.lg.reshape(-1), ug=con.ug.reshape(-1),
                       mask=con.mask.astype(dt).reshape(-1), Phi=Phi, phi=phi)


class _DenseState(NamedTuple):
    z: jnp.ndarray
    s_l: jnp.ndarray
    s_u: jnp.ndarray
    lam_l: jnp.ndarray
    lam_u: jnp.ndarray


def _factorize(Hb: jnp.ndarray, method: str):
    """Factor the barrier-augmented Hessian once per iteration.

    'cholesky' (default) = XLA's native blocked Cholesky after Jacobi
    equilibration — the barrier term puts huge spikes on the diagonal and
    normalizing them reduces the condition number the factorization sees
    (standard IPM practice). XLA lowers the 240x240 Cholesky + triangular
    solves to a short blocked program that compiles in seconds; the
    alternative 'spd_inverse' (trace-time-unrolled blocked Cholesky,
    ops/linalg_small.py) explodes the XLA graph at this size and is kept only
    for small f64 CPU oracles.
    """
    d = jax.lax.rsqrt(jnp.maximum(
        jnp.diagonal(Hb, axis1=-2, axis2=-1), 1e-30))
    Hs = d[..., :, None] * Hb * d[..., None, :]
    if method == 'spd_inverse':
        from cheeta_mpc.ops.linalg_small import spd_inverse
        Finv = d[..., :, None] * spd_inverse(Hs, refine=0,
                                             method='chol') * d[..., None, :]
        return (Finv, d)
    if method == 'cholesky':
        return (jnp.linalg.cholesky(Hs), d)
    raise ValueError(f"unknown dense factorization {method!r}")


def _factor_solve(F, Hb: jnp.ndarray, rhs: jnp.ndarray, method: str):
    Fmat, d = F
    if method == 'spd_inverse':
        # Explicit inverse + one iterative-refinement step: the refinement
        # squares the inverse's relative error (two extra GEMV), which keeps
        # Newton directions accurate even at barrier conditioning ~1/mu.
        x = Fmat @ rhs
        x = x + Fmat @ (rhs - Hb @ x)
        return x
    from jax.lax.linalg import triangular_solve
    y = triangular_solve(Fmat, (d * rhs)[..., None], left_side=True,
                         lower=True)
    x = triangular_solve(Fmat, y, left_side=True, lower=True,
                         transpose_a=True)
    return d * x[..., 0]


def solve_ocp_qp_condensed(data: OcpQpData,
                           settings: IpmSettings = IpmSettings(),
                           factor: str = 'cholesky',
                           ) -> OcpQpSolution:
    """Solve a constrained OCP-QP by condensing + dense Mehrotra IPM.

    Drop-in replacement for :func:`cheeta_mpc.ops.ocpqp.solve_ocp_qp`
    on problems without stage equalities. All shapes static; jit/vmap-safe.
    ``factor`` selects the dense factorization ('cholesky' = XLA native,
    the accelerator path; 'spd_inverse' = all-GEMM explicit inverse, small f64
    oracles only — its trace-time unrolling does not scale to N*nu ~ 240).

    Role (mirrors HPIPM's condensing mode next to its Riccati mode): the
    dense cross-check/oracle backend. The production path is the Riccati
    scan IPM (ops/ocpqp.solve_ocp_qp), which scales O(N) in horizon where
    this backend scales O((N nu)^3).
    """
    qp = condense(data)
    dt = data.dx0.dtype
    N, nx, nu = data.dyn.horizon, data.dyn.nx, data.dyn.nu
    M = N * nu
    ng = 0 if data.con is None else data.con.ng
    m = qp.mask
    n_active = jnp.maximum(jnp.sum(m), 1.0)
    mu_tol = settings.mu_tol if settings.mu_tol > 0 else (
        1e-9 if dt == jnp.float64 else 1e-4)
    w_max = settings.w_max if dt == jnp.float64 else min(settings.w_max, 1e6)
    eyeM = np.eye(M, dtype=dt)

    if ng == 0:
        # Unconstrained: one dense solve (or defer to Riccati for gains).
        from cheeta_mpc.ops.riccati import solve_lqr
        return solve_lqr(data, reg=settings.reg)

    # --- initialization (same rule as the Riccati-backend IPM) -------------
    g = qp.Ghat @ jnp.zeros((M,), dt) + qp.ghat
    s_l = jnp.where(m > 0, jnp.maximum(g - qp.lg, settings.s0_min), 1.0)
    s_u = jnp.where(m > 0, jnp.maximum(qp.ug - g, settings.s0_min), 1.0)
    lam_l = jnp.where(m > 0, settings.mu0 / s_l, 0.0)
    lam_u = jnp.where(m > 0, settings.mu0 / s_u, 0.0)
    state0 = _DenseState(jnp.zeros((M,), dt), s_l, s_u, lam_l, lam_u)

    def stat_norm(state: _DenseState) -> jnp.ndarray:
        lam_net = m * (state.lam_u - state.lam_l)
        return jnp.max(jnp.abs(qp.H @ state.z + qp.g0 + qp.Ghat.T @ lam_net))

    def newton(state, F, Hb, r_l, r_u, r_cl, r_cu):
        w_l = state.lam_l / state.s_l
        w_u = state.lam_u / state.s_u
        beta = m * (w_l * r_l + w_u * r_u
                    + r_cl / state.s_l - r_cu / state.s_u)
        lam_net = m * (state.lam_u - state.lam_l + beta)
        grad = qp.H @ state.z + qp.g0
        dz = _factor_solve(F, Hb, -(grad + qp.Ghat.T @ lam_net), factor)
        dg = qp.Ghat @ dz
        ds_l = m * (dg + r_l)
        ds_u = m * (-dg - r_u)
        dlam_l = -m * (r_cl + state.lam_l * ds_l) / state.s_l
        dlam_u = -m * (r_cu + state.lam_u * ds_u) / state.s_u
        return dz, ds_l, ds_u, dlam_l, dlam_u

    def iteration(carry, _):
        state, stat_old = carry
        g = qp.Ghat @ state.z + qp.ghat
        r_l = g - state.s_l - qp.lg
        r_u = g + state.s_u - qp.ug
        mu = (jnp.sum(m * (state.s_l * state.lam_l
                           + state.s_u * state.lam_u)) / (2.0 * n_active))

        w = m * jnp.minimum(state.lam_l / state.s_l
                            + state.lam_u / state.s_u, w_max)
        Hb = qp.H + qp.Ghat.T @ (w[:, None] * qp.Ghat) + settings.reg * eyeM
        Hb = symmetrize(Hb)
        F = _factorize(Hb, factor)

        r_cl = m * (state.s_l * state.lam_l)
        r_cu = m * (state.s_u * state.lam_u)
        dz_a, ds_l_a, ds_u_a, dl_l_a, dl_u_a = newton(
            state, F, Hb, r_l, r_u, r_cl, r_cu)
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

        r_cl_c = r_cl + m * (ds_l_a * dl_l_a - sigma * mu)
        r_cu_c = r_cu + m * (ds_u_a * dl_u_a - sigma * mu)
        dz, ds_l, ds_u, dl_l, dl_u = newton(
            state, F, Hb, r_l, r_u, r_cl_c, r_cu_c)
        a = jnp.minimum(
            jnp.minimum(_max_step(state.s_l, ds_l, m, settings.tau),
                        _max_step(state.s_u, ds_u, m, settings.tau)),
            jnp.minimum(_max_step(state.lam_l, dl_l, m, settings.tau),
                        _max_step(state.lam_u, dl_u, m, settings.tau)))
        a = a * ((mu > mu_tol) | (stat_old > 1e3 * mu_tol)).astype(dt)

        new = _DenseState(
            z=state.z + a * dz,
            s_l=jnp.where(m > 0, state.s_l + a * ds_l, 1.0),
            s_u=jnp.where(m > 0, state.s_u + a * ds_u, 1.0),
            lam_l=jnp.where(m > 0, state.lam_l + a * dl_l, 0.0),
            lam_u=jnp.where(m > 0, state.lam_u + a * dl_u, 0.0))
        # Step guard (same semantics as the Riccati backend): reject steps
        # that grow the KKT stationarity by >10x; NaN compares false => NaN
        # steps rejected.
        stat_new = stat_norm(new)
        ok = stat_new <= 10.0 * (stat_old + mu)
        new = jax.tree.map(lambda n, o: jnp.where(ok, n, o), new, state)
        return (new, jnp.where(ok, stat_new, stat_old)), mu

    (state, _), mus = jax.lax.scan(iteration, (state0, stat_norm(state0)),
                                   None, length=settings.iters)
    return _expand_solution(data, qp, state, mus[-1], settings, w_max)


def _expand_solution(data: OcpQpData, qp: CondensedQp, state: _DenseState,
                     mu, settings: IpmSettings, w_max) -> OcpQpSolution:
    """Expand a dense-IPM iterate back to the OCP trajectory + Riccati gains
    (kept as a separate function for the dense-oracle tests)."""
    N, nx, nu = data.dyn.horizon, data.dyn.nx, data.dyn.nu
    ng = data.con.ng
    m = qp.mask

    du = state.z.reshape(N, nu)
    dx = jnp.einsum('kim,m->ki', qp.Phi, state.z) + qp.phi
    lam_l = state.lam_l.reshape(N + 1, ng)
    lam_u = state.lam_u.reshape(N + 1, ng)
    s_l = state.s_l.reshape(N + 1, ng)
    s_u = state.s_u.reshape(N + 1, ng)

    # Riccati gains on the final barrier-augmented cost — one backward pass,
    # matching what the reference extracts from HPIPM's last factorization
    # (HpipmInterface.cpp:330-455).
    con = data.con
    w = (m * jnp.minimum(state.lam_l / state.s_l
                         + state.lam_u / state.s_u, w_max)).reshape(N + 1, ng)
    wC = w[..., None] * con.C
    wD = w[..., None] * con.D
    Qb = data.cost.Q + jnp.einsum('nri,nrj->nij', con.C, wC)
    Rb = data.cost.R + jnp.einsum('kri,krj->kij', con.D[:-1], wD[:-1])
    Sb = data.cost.S + jnp.einsum('kri,krj->kij', con.D[:-1], wC[:-1])
    factors = riccati_factorize(data.dyn, Qb, Rb, Sb, reg=settings.reg)
    from cheeta_mpc.ops.ocpqp import _grad_at
    lam_net = (m * (state.lam_u - state.lam_l)).reshape(N + 1, ng)
    gq, gr = _grad_at(data.cost, dx, du)  # gradient at the iterate
    gq = gq + jnp.einsum('nri,nr->ni', con.C, lam_net)
    gr = gr + jnp.einsum('nri,nr->ni', con.D[:-1], lam_net[:-1])
    # Newton direction around the (dynamics-feasible) iterate: the dynamics
    # residual is zero by construction, so the vector pass runs with b = 0
    # (mirroring _solve_newton's dyn.replace(b=r_dyn) in the Riccati backend).
    kvec, p = riccati_vector(data.dyn.replace(b=jnp.zeros_like(data.dyn.b)),
                             gq, gr, factors)
    gains = RiccatiGains(K=factors.K, k=kvec, P=factors.P, p=p)

    # Diagnostics.
    gfin = qp.Ghat @ state.z + qp.ghat
    viol = jnp.maximum(qp.lg - gfin, gfin - qp.ug)
    lam_net_flat = m * (state.lam_u - state.lam_l)
    stat_res = jnp.max(jnp.abs(qp.H @ state.z + qp.g0
                               + qp.Ghat.T @ lam_net_flat))
    return OcpQpSolution(
        dx=dx, du=du, gains=gains,
        lam_l=lam_l, lam_u=lam_u, s_l=s_l, s_u=s_u,
        iterations=jnp.asarray(settings.iters, jnp.int32), mu=mu,
        stat_res=stat_res,
        ineq_res=jnp.max(jnp.where(m > 0, viol, 0.0)),
        eq_res=jnp.max(jnp.abs(bmv(data.dyn.A, dx[:-1])
                               + bmv(data.dyn.B, du)
                               + data.dyn.b - dx[1:])))
