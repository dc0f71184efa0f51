"""State-input equality-constraint projection (null-space elimination).

Re-creates the capability of the reference's ``ConstraintProjection``
(``ocs2_sqp/ocs2_sqp/src/ConstraintProjection.cpp:34-65``) and the
change-of-input-variables transcription step
(``MultipleShootingTranscription.cpp:67-82``): given stage equalities
``C dx + D du + e = 0`` with full-row-rank ``D``, substitute
``du = Pu @ du_tilde + Px @ dx + Pe`` so the reduced problem in ``du_tilde``
is unconstrained.

QR variant (reference :34-53):   D' = [Q1 Q2] [R1; 0]
    Pu = Q2,  Px = -Q1 R1^{-T} C,  Pe = -Q1 R1^{-T} e
LU variant (reference :55-65):   pseudo-inverse based
    Pu = ker(D),  Px = -D^+ C,  Pe = -D^+ e

The QR variant is preferred (jnp.linalg.qr is batched and stable); both
are provided for parity. Rank is a *static* argument — for the legged
problem the active equality set is known from the contact flags, so
projections are specialized per contact mode (see SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


class Projection(NamedTuple):
    Pu: jnp.ndarray  # (nu, nu - nc) null-space basis
    Px: jnp.ndarray  # (nu, nx) particular-solution state map
    Pe: jnp.ndarray  # (nu,) particular-solution offset


def qr_projection(C: jnp.ndarray, D: jnp.ndarray, e: jnp.ndarray) -> Projection:
    """QR-based projection. D: (nc, nu) with nc <= nu, full row rank."""
    nc = D.shape[0]
    Qfull, Rfull = jnp.linalg.qr(D.T, mode='complete')  # (nu,nu), (nu,nc)
    Q1 = Qfull[:, :nc]
    Q2 = Qfull[:, nc:]
    R1 = Rfull[:nc, :]
    # Q1 R1^{-T} applied to C and e:  solve R1' Y = C  =>  Y = R1^{-T} C.
    Yc = solve_triangular(R1.T, C, lower=True)
    Ye = solve_triangular(R1.T, e, lower=True)
    return Projection(Pu=Q2, Px=-Q1 @ Yc, Pe=-Q1 @ Ye)


def lu_projection(C: jnp.ndarray, D: jnp.ndarray, e: jnp.ndarray) -> Projection:
    """Pseudo-inverse-based projection (reference LU variant, :55-65).

    For full-row-rank D the pseudo-inverse is D' (D D')^{-1}, computed via
    Cholesky (no SVD: much cheaper to compile and run, and exact to
    machine precision)."""
    nc, nu = D.shape
    G = D @ D.T
    L = jnp.linalg.cholesky(G)
    from jax.scipy.linalg import cho_solve
    Dpinv = cho_solve((L, True), D).T  # (nu, nc)
    Qfull, _ = jnp.linalg.qr(D.T, mode='complete')
    Pu = Qfull[:, nc:]
    return Projection(Pu=Pu, Px=-Dpinv @ C, Pe=-Dpinv @ e)


def solve_ocp_qp_projected(data, settings=None, method: str = 'qr',
                           inner: Optional[Callable] = None):
    """Solve an OCP-QP with stage equalities by PROJECTION instead of the
    masked eq-Riccati elimination: the reference's
    ``projectStateInputEqualityConstraints=true`` solver mode
    (MultipleShootingTranscription.cpp:67-82 + ConstraintProjection.cpp:34-65
    + the input remap ``du = Pu du~ + Px dx + Pe`` and null-space gain
    projection at MultipleShootingSolver.cpp:268-311,350-356).

    Per stage the equalities ``C dx + D du + e = 0`` are eliminated by
    substituting ``du = Pu du~ + Px dx + Pe`` (``qr_projection`` /
    ``lu_projection``), which transforms dynamics, cost and any inequality
    rows into the reduced input ``du~`` of static width ``nu - nc``; the
    reduced problem (no equalities) is handed to ``inner`` (default
    :func:`cheeta_mpc.ops.ocpqp.solve_ocp_qp`) and the solution —
    trajectory AND Riccati gains — is mapped back to full input space.

    Scope: requires every equality row statically active with full-row-rank
    ``D`` (rank is a shape, so it cannot follow a runtime mask). Mode-
    dependent equality sets (the legged contact constraints) use the
    eq-Riccati path, which is the framework's generalization; this path
    exists as the reference's alternative mode and as the strongest
    cross-implementation oracle (both must agree,
    testCircularKinematics.cpp:38,92 — see tests/test_circular_kinematics.py).
    """
    from cheeta_mpc.core.types import RiccatiGains
    from cheeta_mpc.ops.ocpqp import IpmSettings, solve_ocp_qp
    from cheeta_mpc.ops.riccati import bmv
    if settings is None:
        settings = IpmSettings()
    if inner is None:
        inner = solve_ocp_qp
    eq = data.eq
    assert eq is not None and eq.nc > 0, \
        "projected mode needs stage equalities"
    project = qr_projection if method == 'qr' else lu_projection
    Pu, Px, Pe = jax.vmap(project)(eq.C, eq.D, eq.e)  # (N, nu, nu-nc) etc.

    dyn, cost = data.dyn, data.cost
    # Dynamics through the substitution.
    BPx = dyn.B @ Px
    dyn_t = dyn.replace(A=dyn.A + BPx, B=dyn.B @ Pu,
                        b=dyn.b + bmv(dyn.B, Pe))
    # Cost through the substitution (stage blocks; terminal unchanged).
    H_uu_t, H_ux_t, h_u_t, dH_xx, dh_x = jax.vmap(change_of_input_variables)(
        cost.R, cost.S, cost.r, Projection(Pu, Px, Pe))
    Q_t = cost.Q.at[:-1].add(dH_xx)
    q_t = cost.q.at[:-1].add(dh_x)
    cost_t = cost.replace(Q=Q_t, q=q_t, R=H_uu_t, S=H_ux_t, r=h_u_t)
    # Inequality rows through the substitution (terminal row has no du).
    con_t = None
    if data.con is not None:
        con = data.con
        DPe = bmv(con.D[:-1], Pe)
        shift = jnp.concatenate([DPe, jnp.zeros_like(DPe[:1])], axis=0)
        C_t = con.C.at[:-1].add(con.D[:-1] @ Px)
        D_t = jnp.concatenate([con.D[:-1] @ Pu,
                               jnp.zeros_like((con.D[:-1] @ Pu)[:1])], axis=0)
        con_t = con.replace(C=C_t, D=D_t, lg=con.lg - shift,
                            ug=con.ug - shift)
    red = data.replace(dyn=dyn_t, cost=cost_t, con=con_t, eq=None)

    sol = inner(red, settings)
    # Remap to full input space: trajectories, then gains through the
    # null-space (reference MultipleShootingSolver.cpp:350-356).
    du = bmv(Pu, sol.du) + bmv(Px, sol.dx[:-1]) + Pe
    K = Pu @ sol.gains.K + Px
    k = bmv(Pu, sol.gains.k) + Pe
    eq_res = jnp.max(jnp.abs(eq.mask * (bmv(eq.C, sol.dx[:-1])
                                        + bmv(eq.D, du) + eq.e)))
    return sol.replace(du=du,
                       gains=RiccatiGains(K=K, k=k, P=sol.gains.P,
                                          p=sol.gains.p),
                       eq_res=jnp.maximum(sol.eq_res, eq_res))


def change_of_input_variables(H_uu, H_ux, h_u, proj: Projection):
    """Map input-space quadratic data through du = Pu du~ + Px dx + Pe.

    Returns the reduced (H_uu~, H_ux~, h_u~) in du~ coordinates plus the
    cross/constant corrections to the state blocks:
        dH_xx = Px' H_uu Px + Px' H_ux + H_ux' Px
        dh_x  = Px'(H_uu Pe + h_u) + H_ux' Pe
    (reference: ocs2_core changeOfInputVariables used at
    MultipleShootingTranscription.cpp:72-80).
    """
    Pu, Px, Pe = proj
    HuuPu = H_uu @ Pu
    HuuPx = H_uu @ Px
    HuuPe = H_uu @ Pe
    H_uu_t = Pu.T @ HuuPu
    H_ux_t = Pu.T @ (HuuPx + H_ux)
    h_u_t = Pu.T @ (HuuPe + h_u)
    dH_xx = Px.T @ HuuPx + Px.T @ H_ux + H_ux.T @ Px
    dh_x = Px.T @ (HuuPe + h_u) + H_ux.T @ Pe
    return H_uu_t, H_ux_t, h_u_t, dH_xx, dh_x
