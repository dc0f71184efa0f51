"""Riccati recursion kernels for OCP-structured QPs.

The replacement for HPIPM's Riccati-based OCP-QP factorization
(reference: ``d_ocp_qp_ipm_solve`` with ``ric_alg 0`` called from
``ocs2_sqp/hpipm_catkin/src/HpipmInterface.cpp:281-301``; BLASFEO supplies the
hand-tuned small-matrix kernels). Here each recursion is a ``jax.lax.scan``
over stages designed to be ``vmap``-ed over large scenario batches.

Shape of the stage update (the per-stage blocks are tiny, nx <= 33, so the
*number* of sequential operations matters more than their FLOPs):
- The whole stage update is packed into two products via M = [A B]:
      T = [A B]' P_{k+1} [A B]  ->  A'PA, A'PB, B'PB in one bmm pair.
- Mat-vec products (the vector/forward passes) are expressed as
  multiply-reduce, which XLA fuses with the surrounding elementwise work,
  rather than as separate dot operations.
- The per-stage SPD inverse uses the recursive Schur-complement kernel in
  ops/linalg_small.py and is stored explicitly, so both vector passes of the
  predictor-corrector IPM are matmul-only against the same factors.

The factorization (matrix) pass and the vector pass are split so an
interior-point method can factor once per iteration and run two vector solves
(Mehrotra predictor + corrector) against the same factors.

Convention (k = 0..N-1, terminal N):
    min  sum_k 1/2 [dx;du]' [Q S'; S R] [dx;du] + [q;r]'[dx;du]  + terminal
    s.t. dx_{k+1} = A dx_k + B du_k + b_k,   dx_0 given.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import (CostApprox, DynamicsLin, OcpQpData,
                                   OcpQpSolution, RiccatiGains, symmetrize)
from cheeta_mpc.ops.linalg_small import spd_inverse


def stage_unroll(n_stages: int) -> int:
    """Unroll factor for stage-serial scans.

    The per-stage ops are tiny (nx<=33 blocks), so the scans are bound by
    the number of sequential operations, not by FLOPs: fully unrolling short
    horizons lets XLA fuse across stages and drops the per-trip loop
    overhead. On one NVIDIA H100 (700 W limit) the N=10 centroidal solve
    (2 SQP x 10 IPM) takes 26.8-27.3 ms p50 fully unrolled against
    36.9-37.0 ms with unroll 1 at batch 1, and 77.2 against 99.0 ms at
    batch 1024. Longer horizons get a fixed partial unroll to bound compile
    time.

    ``CHEETA_STAGE_UNROLL`` overrides the factor (numerics are identical;
    only fusion/pipelining changes): the CPU test suite sets it to 1 in
    tests/conftest.py because Python *tracing* of the fully-unrolled solver
    graphs — which no compile cache can amortize — dominated suite wall
    time."""
    import os
    override = os.environ.get("CHEETA_STAGE_UNROLL")
    if override:
        return max(1, min(int(override), n_stages))
    return n_stages if n_stages <= 16 else 4


def bmv(M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched mat-vec: (..., m, n) x (..., n) -> (..., m).

    Written as multiply+reduce so XLA lowers it to fused elementwise work
    instead of a separate dot."""
    return jnp.sum(M * v[..., None, :], axis=-1)


def bmv_t(M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched (..., m, n)' x (..., m) -> (..., n) without materializing M'."""
    return jnp.sum(M * v[..., :, None], axis=-2)


class RiccatiFactors(NamedTuple):
    """Per-stage factorization products needed for vector solves.

    ``Ginv`` is the explicit inverse of G_k = R_k + B'P_{k+1}B so both the
    matrix and the vector passes are pure batched matmuls."""

    K: jnp.ndarray  # (N, nu, nx) feedback gains
    Ginv: jnp.ndarray  # (N, nu, nu) inverses of G_k
    P: jnp.ndarray  # (N+1, nx, nx) value-function Hessians


def riccati_factorize(dyn: DynamicsLin, Q: jnp.ndarray, R: jnp.ndarray,
                      S: jnp.ndarray, reg: float = 0.0) -> RiccatiFactors:
    """Backward matrix pass. Q: (N+1,nx,nx), R: (N,nu,nu), S: (N,nu,nx)."""
    nx = Q.shape[-1]
    nu = R.shape[-1]
    eye_u = np.eye(nu, dtype=R.dtype)  # numpy literal, not a buffer arg
    # Pack dynamics as M = [A B] (nx, nx+nu) once for the whole horizon.
    M = jnp.concatenate([dyn.A, dyn.B], axis=-1)

    def body(P_next, stage):
        Mk, Qk, Rk, Sk = stage
        PM = P_next @ Mk  # (nx, nx+nu): P A | P B in one product
        T = Mk.T @ PM  # (nx+nu, nx+nu): [A'PA A'PB; B'PA B'PB]
        G = Rk + T[nx:, nx:] + reg * eye_u
        H = Sk + T[nx:, :nx]  # S + B'PA
        Ginv = spd_inverse(symmetrize(G))
        K = -Ginv @ H
        P = Qk + T[:nx, :nx] + H.T @ K
        P = symmetrize(P)
        return P, (K, Ginv, P)

    _, (K, Ginv, P_stages) = jax.lax.scan(
        body, symmetrize(Q[-1]), (M, Q[:-1], R, S), reverse=True,
        unroll=stage_unroll(R.shape[0]))
    P = jnp.concatenate([P_stages, symmetrize(Q[-1])[None]], axis=0)
    return RiccatiFactors(K=K, Ginv=Ginv, P=P)


def riccati_vector(dyn: DynamicsLin, q: jnp.ndarray, r: jnp.ndarray,
                   factors: RiccatiFactors):
    """Backward vector pass against stored factors.

    q: (N+1, nx), r: (N, nu). Returns (k: (N,nu), p: (N+1,nx)).
    """

    def body(p_next, stage):
        A, B, b, qk, rk, K, Ginv, P_next = stage
        m = p_next + bmv(P_next, b)  # (nx,)
        rhs = rk + bmv_t(B, m)  # (nu,)
        k = -bmv(Ginv, rhs)
        p = qk + bmv_t(A, m) + bmv_t(K, rhs)
        return p, (k, p)

    _, (k, p_stages) = jax.lax.scan(
        body, q[-1],
        (dyn.A, dyn.B, dyn.b, q[:-1], r, factors.K, factors.Ginv,
         factors.P[1:]),
        reverse=True, unroll=stage_unroll(r.shape[0]))
    p = jnp.concatenate([p_stages, q[-1][None]], axis=0)
    return k, p


def lqr_forward(dyn: DynamicsLin, K: jnp.ndarray, k: jnp.ndarray,
                dx0: jnp.ndarray):
    """Forward rollout of the affine policy. Returns (dx: (N+1,nx), du: (N,nu))."""

    def body(dx, stage):
        A, B, b, Kk, kk = stage
        du = bmv(Kk, dx) + kk
        dx_next = bmv(A, dx) + bmv(B, du) + b
        return dx_next, (dx, du)

    dxN, (dx, du) = jax.lax.scan(body, dx0, (dyn.A, dyn.B, dyn.b, K, k),
                                 unroll=stage_unroll(K.shape[0]))
    dx = jnp.concatenate([dx, dxN[None]], axis=0)
    return dx, du


class EqRiccatiFactors(NamedTuple):
    """Factors for the equality-constrained stage elimination.

    Per-stage state-input equalities ``Ceq dx + Deq du = h`` with an activity
    mask (inactive rows get an eps dual regularization, so the row count is
    static while the effective rank follows the contact mode). This is the
    statically shaped replacement for the reference's LU/QR projection +
    change-of-input-variables (ConstraintProjection.cpp:34-65,
    MultipleShootingTranscription.cpp:67-82), which has data-dependent rank.

    Stage saddle system over (du, nu_eq):
        [G  D'] [du ]   [-(H dx + g)]
        [D  -E ] [nu ] = [h - C dx  ]      E = eps * diag(1 - mask)
    eliminated via two SPD inverses:
        Y  = G^{-1} D',   Lam = D Y + E,   Li = Lam^{-1}
        W  = G^{-1} - Y Li Y'             (reduced inverse)
        du = -(W H + Y Li C) dx - (W g - Y Li h)
    Value recursion:
        P <- (Q + A'PA) + H'K + C' Li (C - Y' H)
        p <- q_x + A'm + H'k + C' nu0,  nu0 = -Li (h + Y' g)
    """

    K: jnp.ndarray  # (N, nu, nx)
    W: jnp.ndarray  # (N, nu, nu) reduced inverses
    YLi: jnp.ndarray  # (N, nu, nc)  Y Lam^{-1}
    Li: jnp.ndarray  # (N, nc, nc) Lam^{-1}
    H: jnp.ndarray  # (N, nu, nx)  S + B'P A (needed in the vector pass)
    P: jnp.ndarray  # (N+1, nx, nx)


def riccati_factorize_eq(dyn: DynamicsLin, Q, R, S, Ceq, Deq, eq_mask,
                         reg: float = 0.0,
                         eps: float = 1.0) -> EqRiccatiFactors:
    """Backward matrix pass with masked stage equalities.

    Ceq: (N, nc, nx), Deq: (N, nc, nu), eq_mask: (N, nc). Inactive rows must
    be zeroed in Ceq/Deq (callers mask them) and get dual regularization
    ``eps`` so Lam stays SPD.
    """
    nx = Q.shape[-1]
    nu = R.shape[-1]
    eye_u = np.eye(nu, dtype=R.dtype)  # numpy literal, not a buffer arg
    M = jnp.concatenate([dyn.A, dyn.B], axis=-1)

    def body(P_next, stage):
        Mk, Qk, Rk, Sk, Ck, Dk, mk = stage
        PM = P_next @ Mk
        T = Mk.T @ PM
        G = Rk + T[nx:, nx:] + reg * eye_u
        H = Sk + T[nx:, :nx]
        Ginv = spd_inverse(symmetrize(G))
        Y = Ginv @ Dk.T  # (nu, nc)
        E = eps * (1.0 - mk)
        Lam = Dk @ Y + jnp.diag(E)
        Li = spd_inverse(symmetrize(Lam))
        YLi = Y @ Li
        W = Ginv - YLi @ Y.T
        K = -(W @ H + YLi @ Ck)
        P = Qk + T[:nx, :nx] + H.T @ K + Ck.T @ (Li @ (Ck - Y.T @ H))
        P = symmetrize(P)
        return P, (K, W, YLi, Li, H, P)

    _, (K, W, YLi, Li, H, P_stages) = jax.lax.scan(
        body, symmetrize(Q[-1]), (M, Q[:-1], R, S, Ceq, Deq, eq_mask),
        reverse=True, unroll=stage_unroll(R.shape[0]))
    P = jnp.concatenate([P_stages, symmetrize(Q[-1])[None]], axis=0)
    return EqRiccatiFactors(K=K, W=W, YLi=YLi, Li=Li, H=H, P=P)


def riccati_vector_eq(dyn: DynamicsLin, q, r, h, Ceq,
                      factors: EqRiccatiFactors):
    """Backward vector pass with equality right-hand sides h: (N, nc).

    Uses the identity Li Y' g = (YLi)' g (Li symmetric) so the stored
    factors suffice: nu0 = -(Li h + (YLi)' g)."""

    def body(p_next, stage):
        A, B, b, qk, rk, hk, Ck, K, W, YLi, Li, H, P_next = stage
        m = p_next + bmv(P_next, b)
        g = rk + bmv_t(B, m)
        k = -(bmv(W, g) - bmv(YLi, hk))
        nu0 = -(bmv(Li, hk) + bmv_t(YLi, g))
        p = qk + bmv_t(A, m) + bmv_t(H, k) + bmv_t(Ck, nu0)
        return p, (k, p)

    _, (k, p_stages) = jax.lax.scan(
        body, q[-1],
        (dyn.A, dyn.B, dyn.b, q[:-1], r, h, Ceq, factors.K, factors.W,
         factors.YLi, factors.Li, factors.H, factors.P[1:]),
        reverse=True, unroll=stage_unroll(r.shape[0]))
    p = jnp.concatenate([p_stages, q[-1][None]], axis=0)
    return k, p


def fold_terminal_equality(data: OcpQpData, C_N, e_N, mask_N) -> OcpQpData:
    """Exact terminal-equality support: state-only terminal rows
    ``C_N dx_N + e_N = 0`` are pulled back through the final dynamics
    (``dx_N = A dx_{N-1} + B du_{N-1} + b``) into stage-(N-1) state-input
    equality rows ``(C_N A) dx + (C_N B) du + (C_N b + e_N) = 0`` — the
    role of the reference's terminal transcription, which hands terminal
    constraints to HPIPM directly (MultipleShootingTranscription.cpp:
    114-130). Exact for any feasible QP (the pulled-back rows hold iff the
    terminal rows hold along dynamics-feasible trajectories, and the IPM
    enforces the dynamics exactly).

    C_N: (nt, nx), e_N: (nt,), mask_N: (nt,). Returns data with the rows
    appended to the (possibly empty) stage-equality block; all other stages
    carry zero-masked padding, keeping shapes static.
    """
    dt = data.dx0.dtype
    Nh, nx, nu = data.dyn.horizon, data.dyn.nx, data.dyn.nu
    nt = C_N.shape[0]
    A, B, b = data.dyn.A[-1], data.dyn.B[-1], data.dyn.b[-1]
    Cp = (mask_N[:, None] * C_N) @ A  # (nt, nx)
    Dp = (mask_N[:, None] * C_N) @ B  # (nt, nu)
    ep = mask_N * (bmv(C_N, b) + e_N)  # (nt,)
    padC = jnp.zeros((Nh - 1, nt, nx), dt)
    padD = jnp.zeros((Nh - 1, nt, nu), dt)
    padv = jnp.zeros((Nh - 1, nt), dt)
    extC = jnp.concatenate([padC, Cp[None]], axis=0)
    extD = jnp.concatenate([padD, Dp[None]], axis=0)
    exte = jnp.concatenate([padv, ep[None]], axis=0)
    extm = jnp.concatenate([padv, mask_N[None]], axis=0)
    if data.eq is None:
        from cheeta_mpc.core.types import StageEquality
        eq = StageEquality(C=extC, D=extD, e=exte, mask=extm)
    else:
        eq = data.eq.replace(
            C=jnp.concatenate([data.eq.C, extC], axis=1),
            D=jnp.concatenate([data.eq.D, extD], axis=1),
            e=jnp.concatenate([data.eq.e, exte], axis=1),
            mask=jnp.concatenate([data.eq.mask, extm], axis=1))
    return data.replace(eq=eq)


def solve_eq_lqr(data: OcpQpData, reg: float = 0.0) -> OcpQpSolution:
    """Solve an OCP-QP with stage equalities but no inequalities, exactly."""
    cost = data.cost
    eq = data.eq
    f = riccati_factorize_eq(data.dyn, cost.Q, cost.R, cost.S, eq.C, eq.D,
                             eq.mask, reg=reg)
    k, p = riccati_vector_eq(data.dyn, cost.q, cost.r, -(eq.mask * eq.e),
                             eq.C, f)
    dx, du = lqr_forward(data.dyn, f.K, k, dx0=data.dx0)
    gains = RiccatiGains(K=f.K, k=k, P=f.P, p=p)
    N1 = cost.Q.shape[0]
    ng = 0 if data.con is None else data.con.ng
    zshape = (N1, ng)
    zero = np.zeros((), dx.dtype)
    return OcpQpSolution(
        dx=dx, du=du, gains=gains,
        lam_l=np.zeros(zshape, dx.dtype), lam_u=np.zeros(zshape, dx.dtype),
        s_l=np.ones(zshape, dx.dtype), s_u=np.ones(zshape, dx.dtype),
        iterations=np.zeros((), np.int32), mu=zero, stat_res=zero,
        ineq_res=zero, eq_res=zero)


def solve_lqr(data: OcpQpData, reg: float = 0.0) -> OcpQpSolution:
    """Solve an equality-constrained (unconstrained-inequality) OCP-QP exactly.

    The oracle path for tests and the inner engine of the IPM.
    """
    cost = data.cost
    factors = riccati_factorize(data.dyn, cost.Q, cost.R, cost.S, reg=reg)
    k, p = riccati_vector(data.dyn, cost.q, cost.r, factors)
    dx, du = lqr_forward(data.dyn, factors.K, k, dx0=data.dx0)
    gains = RiccatiGains(K=factors.K, k=k, P=factors.P, p=p)
    N1 = cost.Q.shape[0]
    ng = 0 if data.con is None else data.con.ng
    zshape = (N1, ng)
    zero = np.zeros((), dx.dtype)
    return OcpQpSolution(
        dx=dx, du=du, gains=gains,
        lam_l=np.zeros(zshape, dx.dtype), lam_u=np.zeros(zshape, dx.dtype),
        s_l=np.ones(zshape, dx.dtype), s_u=np.ones(zshape, dx.dtype),
        iterations=np.zeros((), np.int32), mu=zero, stat_res=zero,
        ineq_res=zero, eq_res=zero)


def cost_of(cost: CostApprox, dx: jnp.ndarray, du: jnp.ndarray) -> jnp.ndarray:
    """Evaluate the quadratic objective at (dx, du)."""
    dxs, dxN = dx[:-1], dx[-1]
    stage = (0.5 * jnp.einsum('ki,kij,kj->', dxs, cost.Q[:-1], dxs)
             + 0.5 * jnp.einsum('ki,kij,kj->', du, cost.R, du)
             + jnp.einsum('ki,kij,kj->', du, cost.S, dxs)
             + jnp.einsum('ki,ki->', cost.q[:-1], dxs)
             + jnp.einsum('ki,ki->', cost.r, du))
    term = 0.5 * dxN @ cost.Q[-1] @ dxN + cost.q[-1] @ dxN
    return stage + term
