"""Gauss-Newton DDP / SLQ solver.

The analogue of the reference's alternative solver path
(``GaussNewtonDDP_MPC`` with ``ddp.algorithm SLQ``, used by
``LeggedRobotDdpMpcNode.cpp:32`` via the external ``ocs2_ddp``): iterate
{linearize along the nominal trajectory -> Riccati backward pass -> nonlinear
closed-loop forward rollout with feedback}. Constraints enter through
penalties — the reference's DDP mode uses relaxed-barrier penalties for the
friction cone (task.info:215-222, mu 0.1 / delta 5.0), provided here as
:func:`relaxed_barrier`.

Static shape: fixed iteration count; the backtracking line search is a parallel
ladder of closed-loop rollouts (vmap over step sizes), mirroring how the SQP
layer vectorizes its filter line search.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import DynamicsLin
from cheeta_mpc.ops.riccati import (riccati_factorize, riccati_vector,
                                    bmv)


class DdpSettings(NamedTuple):
    iterations: int = 5  # reference ddp maxNumIterations (1 in task.info)
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03)
    reg: float = 1e-6  # Levenberg-style G regularization
    # Convergence classification threshold (reference ddp.minRelCost: stop
    # when the cost improvement of an iteration falls below it; here the
    # fixed-iteration solver *classifies* the final iteration instead).
    min_rel_cost: float = 1e-1
    # Quadratic-penalty weight for the equality families in penalty-mode
    # problems (reference ddp.constraintPenaltyInitialValue; the reference
    # grows it by constraintPenaltyIncreaseRate across AL iterations — the
    # fixed-iteration solver uses the flat initial value).
    constraint_penalty: float = 20.0
    algorithm: str = "SLQ"  # reference ddp.algorithm (SLQ == Gauss-Newton)

    @classmethod
    def from_task_info(cls, path: str, **overrides) -> "DdpSettings":
        """Ingest the ``ddp`` block of a reference task.info
        (/root/reference/ocs2_legged_robot/config/mpc/task.info:50-99):
        maxNumIterations, minRelCost, the lineSearch min/max step lengths
        (expanded into the parallel alpha ladder with the solver's 0.5
        decay), hessianCorrectionMultiple as the G regularization, and
        constraintPenaltyInitialValue."""
        from cheeta_mpc.utils.info_config import load_info
        info = load_info(path)
        ddp = info.get("ddp", {})
        ls = ddp.get("lineSearch", {})
        a_max = float(ls.get("maxStepLength", 1.0))
        a_min = float(ls.get("minStepLength", 1e-2))
        alphas = []
        a = a_max
        while a >= a_min and len(alphas) < 8:
            alphas.append(a)
            a *= 0.5
        kw = dict(
            iterations=int(ddp.get("maxNumIterations", 5)),
            alphas=tuple(alphas) or (1.0,),
            reg=float(ls.get("hessianCorrectionMultiple", 1e-6)),
            min_rel_cost=float(ddp.get("minRelCost", 1e-1)),
            constraint_penalty=float(
                ddp.get("constraintPenaltyInitialValue", 20.0)),
            algorithm=str(ddp.get("algorithm", "SLQ")),
        )
        kw.update(overrides)
        return cls(**kw)


class DdpResult(NamedTuple):
    x: jnp.ndarray  # (N+1, nx)
    u: jnp.ndarray  # (N, nu)
    K: jnp.ndarray  # (N, nu, nx) feedback gains of the last backward pass
    cost: jnp.ndarray
    # Value-function quadratic model of the last backward pass — the DDP
    # analogue of the SQP path's Riccati cost-to-go surface (reference
    # extracts the same {P, p} from HPIPM, HpipmInterface.cpp:400-455;
    # ocs2_ddp exposes it as getValueFunction).
    P: jnp.ndarray  # (N+1, nx, nx)
    p: jnp.ndarray  # (N+1, nx)
    converged: jnp.ndarray  # bool: final improvement < min_rel_cost


def relaxed_barrier(h, mu: float, delta: float):
    """The reference's RelaxedBarrierPenalty: -mu ln(h) for h > delta,
    quadratic extension below (ocs2_core penalty used for the DDP friction
    cone; parameters task.info:220-222)."""
    quad = mu * (0.5 * ((h - 2.0 * delta) / delta) ** 2 - 0.5
                 - jnp.log(delta))
    return jnp.where(h > delta, -mu * jnp.log(jnp.maximum(h, 1e-30)), quad)


def solve_ddp(step: Callable, stage_cost: Callable, terminal_cost: Callable,
              x0: jnp.ndarray, u_init: jnp.ndarray,
              settings: DdpSettings = DdpSettings()) -> DdpResult:
    """Gauss-Newton DDP over a generic discrete system.

    Args:
        step(k, x, u) -> x_next                (nonlinear dynamics)
        stage_cost(k, x, u) -> scalar          (includes penalties)
        terminal_cost(x) -> scalar
        x0: (nx,), u_init: (N, nu) warm start.
    """
    # f32 matmul precision: see solvers/scp.solve_nonlinear_ocp — reduced-
    # precision f32 dots (TF32 on a GPU) corrupt long Riccati recursions;
    # request full f32 at trace time.
    with jax.default_matmul_precision('highest'):
        return _solve_ddp(step, stage_cost, terminal_cost, x0, u_init,
                          settings)


def _solve_ddp(step, stage_cost, terminal_cost, x0, u_init,
               settings: DdpSettings) -> DdpResult:
    N, nu = u_init.shape
    nx = x0.shape[0]
    ks = jnp.arange(N)
    alphas = np.asarray(settings.alphas, x0.dtype)

    def rollout_open(u_traj):
        def body(x, ku):
            k, u = ku
            xn = step(k, x, u)
            return xn, xn
        _, xs = jax.lax.scan(body, x0, (ks, u_traj))
        return jnp.concatenate([x0[None], xs], axis=0)

    def total_cost(x_traj, u_traj):
        cs = jax.vmap(stage_cost)(ks, x_traj[:-1], u_traj)
        return jnp.sum(cs) + terminal_cost(x_traj[-1])

    def rollout_closed(alpha, x_ref, u_ref, K, kff):
        """Closed-loop rollout: u = u_ref + alpha*kff + K (x - x_ref)."""
        def body(x, stage):
            k, xr, ur, Kk, kk = stage
            u = ur + alpha * kk + bmv(Kk, x - xr)
            xn = step(k, x, u)
            return xn, (x, u)
        _, (xs, us) = jax.lax.scan(body, x0, (ks, x_ref[:-1], u_ref, K, kff))
        xN = step(N - 1, xs[-1], us[-1])
        x_traj = jnp.concatenate([xs, xN[None]], axis=0)
        return x_traj, us

    def iteration(carry, _):
        x_traj, u_traj, _ = carry
        # Linearize dynamics and quadratize cost along the nominal.
        def lin(k, x, u):
            A = jax.jacfwd(lambda xx: step(k, xx, u))(x)
            B = jax.jacfwd(lambda uu: step(k, x, uu))(u)
            return A, B
        A, B = jax.vmap(lin)(ks, x_traj[:-1], u_traj)
        dyn = DynamicsLin(A=A, B=B, b=jnp.zeros((N, nx), x0.dtype))

        def quad(k, x, u):
            fn = lambda xu: stage_cost(k, xu[:nx], xu[nx:])
            xu = jnp.concatenate([x, u])
            g = jax.grad(fn)(xu)
            H = jax.hessian(fn)(xu)
            return (H[:nx, :nx], g[:nx], H[nx:, nx:], g[nx:], H[nx:, :nx])
        Qs, qs, Rs, rs, Ss = jax.vmap(quad)(ks, x_traj[:-1], u_traj)
        QN = jax.hessian(terminal_cost)(x_traj[-1])
        qN = jax.grad(terminal_cost)(x_traj[-1])
        Q = jnp.concatenate([Qs, QN[None]])
        q = jnp.concatenate([qs, qN[None]])
        # Gauss-Newton: project out potential indefiniteness via G reg.
        factors = riccati_factorize(dyn, Q, Rs, Ss, reg=settings.reg)
        kff, pvec = riccati_vector(dyn, q, rs, factors)

        # Parallel line-search ladder of closed-loop rollouts.
        def try_alpha(a):
            xt, ut = rollout_closed(a, x_traj, u_traj, factors.K, kff)
            return total_cost(xt, ut), xt, ut
        costs, xts, uts = jax.vmap(try_alpha)(alphas)
        base = total_cost(x_traj, u_traj)
        best = jnp.argmin(costs)
        improved = costs[best] < base
        x_new = jnp.where(improved, xts[best], x_traj)
        u_new = jnp.where(improved, uts[best], u_traj)
        cost_new = jnp.where(improved, costs[best], base)
        return ((x_new, u_new, (factors.K, factors.P, pvec)),
                (cost_new, base - cost_new))

    x_init = rollout_open(u_init)
    gains0 = (np.zeros((N, nu, nx), x0.dtype),
              np.zeros((N + 1, nx, nx), x0.dtype),
              np.zeros((N + 1, nx), x0.dtype))
    (x, u, (K, P, pvec)), (costs, drops) = jax.lax.scan(
        iteration, (x_init, u_init, gains0), None,
        length=settings.iterations)
    # Convergence classification (reference ddp.minRelCost exit criterion,
    # applied to the final iteration of the fixed budget).
    converged = drops[-1] < settings.min_rel_cost
    return DdpResult(x=x, u=u, K=K, cost=costs[-1], P=P, p=pvec,
                     converged=converged)
