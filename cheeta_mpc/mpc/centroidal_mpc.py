"""Centroidal MPC — the north-star workload.

Re-creates, from scratch, the capability of the reference's CasADi/IPOPT
centroidal MPC (``/root/reference/CentroidalMPC.{h,cpp}`` +
``NonlinearMPC.h``): same NLP (dynamics, friction pyramids, footstep boxes,
all 45 cost weights including the exponential CoM-z trust decay), same packed
input layout as ``CentroidalMPC::UpdateMPC`` (CentroidalMPC.cpp:278-335), same
outputs (per-leg foot-position and contact-force trajectories,
CentroidalMPC.cpp:269-273).

Instead of a symbolic NLP handed to a sparse interior-point solver (IPOPT +
MUMPS/MA97), the problem is solved by SQP over the Riccati-structured
interior-point QP solver — a single statically-shaped XLA program that can be
``vmap``-ed over thousands of scenarios and sharded over a device mesh.

Formulation notes (math-preserving re-designs):
- Forces enter as ``F = enable * u_F`` so swing-leg forces are identically
  zero (replacing the reference's degenerate ``0 <= A F <= 0`` rows) and the
  friction rows are simply masked off on swing nodes.
- The force-rate cost (``casadi::MX::diff``) is made stage-separable by
  augmenting the state with the previous effective force (see
  models/centroidal.py).
- The reference's CoM-z cost term is ``sumsqr(w_k * (z_k - d_k))`` with
  ``w_k = (w2/2) e^{-k} + w2/2`` (CentroidalMPC.cpp:203-210) — i.e. the
  *squared* weight multiplies the squared error; replicated exactly.
- Tiny regularizers (1e-6) on foot velocities and masked force variables pin
  coordinates the reference leaves free to IPOPT's internal regularization;
  they are orders of magnitude below the 1e-3 GRF-match tolerance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from cheeta_mpc.core import struct

from cheeta_mpc.core.types import (CostApprox, DynamicsLin, OcpQpData,
                                   StageConstraint)
from cheeta_mpc.models.centroidal import (GRAVITY, CentroidalParams,
                                          centroidal_step, linearize_step,
                                          pack_state, rollout,
                                          unpack_input, unpack_state)
from cheeta_mpc.solvers.scp import (ScpSettings, make_performance,
                                    solve_nonlinear_ocp)


class CentroidalMpcConfig(NamedTuple):
    """Static + array configuration, mirroring the reference ctor arguments
    (CentroidalMPC.cpp:13-32, CentoidMPCTest.cpp:11-34)."""

    mass: float = 8.0
    num_legs: int = 4
    horizon: int = 6
    dt: float = 0.01
    # 45 weights, layout per CentoidMPCTest.cpp:19-33: com pos (3), com vel
    # (3), angular momentum (3), then per-leg {foot pos, force, force rate}.
    weights: Tuple[float, ...] = ()
    mu: Tuple[float, ...] = (0.8, 0.8, 0.8, 0.8)
    foot_step_lb: Tuple[float, float, float] = (-0.2, -0.2, -0.1)  # :30
    foot_step_ub: Tuple[float, float, float] = (0.2, 0.2, 0.1)  # :31
    force_max: float = 5000.0  # friction-row upper bound, CentroidalMPC.cpp:183
    reg_eps: float = 1e-6  # foot-vel / masked-force regularizer (ours)
    dtype: jnp.dtype = jnp.float32


@struct.dataclass
class CentroidalSolution:
    """Outputs matching the reference's controller outputs
    (CentroidalMPC.cpp:269-273) plus diagnostics."""

    foot_pos: jnp.ndarray  # (num_legs, 3, N+1)
    contact_force: jnp.ndarray  # (num_legs, 3, N)
    com_pos: jnp.ndarray  # (3, N+1)
    com_vel: jnp.ndarray  # (3, N+1)
    ang_mom: jnp.ndarray  # (3, N+1)
    x_traj: jnp.ndarray  # (N+1, nx) augmented-state iterate
    u_traj: jnp.ndarray  # (N, nu)
    merit: jnp.ndarray
    qp_mu: jnp.ndarray
    gains_K: jnp.ndarray  # (N, nu, nx) Riccati feedback of the last QP
    gains_P: jnp.ndarray  # (N+1, nx, nx) value-function Hessians
    gains_p: jnp.ndarray  # (N+1, nx) value-function gradients
    performance: object  # PerformanceIndex at the final iterate
    convergence: jnp.ndarray  # int32 CONV_* code


class _Refs(NamedTuple):
    """Unpacked per-solve reference data (all arrays node-major)."""

    x0: jnp.ndarray  # (nx,) augmented initial state
    des_com_pos: jnp.ndarray  # (N+1, 3)
    des_com_vel: jnp.ndarray  # (N+1, 3)
    des_ang_mom: jnp.ndarray  # (N+1, 3)
    des_foot_pos: jnp.ndarray  # (num_legs, N+1, 3)
    des_force: jnp.ndarray  # (num_legs, N, 3)
    enable: jnp.ndarray  # (N, num_legs) contact table


def _unpack_reference_inputs(cfg: CentroidalMpcConfig, state, des_state,
                             des_inputs) -> _Refs:
    """Decode the reference's packed vectors (CentroidalMPC.cpp:278-335).

    state:      [com_pos(3), com_vel(3), L(3), foot_pos(3*nl)]
    des_state:  [des_com_pos(3*(N+1)), des_com_vel(...), des_L(...)]
    des_inputs: per leg i at offset i*(4N+3):
                [contact_enable(N), des_foot_pos(3*(N+1))]
    Desired normal forces are derived from the contact table as
    m*g / (#stance legs) per step (CentroidalMPC.cpp:326-335).
    """
    nl, N = cfg.num_legs, cfg.horizon
    dt_ = cfg.dtype
    state = jnp.asarray(state, dt_)
    des_state = jnp.asarray(des_state, dt_)
    des_inputs = jnp.asarray(des_inputs, dt_)

    com_pos, com_vel, ang_mom = state[0:3], state[3:6], state[6:9]
    foot_pos0 = state[9:9 + 3 * nl].reshape(nl, 3)

    per_node = 3 * (N + 1)
    des_com_pos = des_state[0:per_node].reshape(N + 1, 3)
    des_com_vel = des_state[per_node:2 * per_node].reshape(N + 1, 3)
    des_ang_mom = des_state[2 * per_node:3 * per_node].reshape(N + 1, 3)

    # Static per-leg layout: reshape once instead of per-leg dynamic slices.
    leg_stride = 4 * N + 3
    per_leg = des_inputs[:nl * leg_stride].reshape(nl, leg_stride)
    enable = per_leg[:, :N]  # (nl, N)
    des_foot_pos = per_leg[:, N:N + 3 * (N + 1)].reshape(nl, N + 1, 3)

    stance_count = jnp.sum(enable, axis=0)  # (N,)
    fz_des = cfg.mass * GRAVITY / jnp.maximum(stance_count, 1.0)
    fz = enable * fz_des[None, :]  # (nl, N)
    des_force = jnp.stack(
        [jnp.zeros_like(fz), jnp.zeros_like(fz), fz], axis=-1)

    # Initial F_prev: the reference's diff() starts at F_0 (no rate cost on
    # the first step), so F_prev_0 is irrelevant; use the desired force so the
    # augmented state is well-scaled.
    x0 = pack_state(com_pos, com_vel, ang_mom, foot_pos0, des_force[:, 0, :])
    return _Refs(x0=x0, des_com_pos=des_com_pos, des_com_vel=des_com_vel,
                 des_ang_mom=des_ang_mom, des_foot_pos=des_foot_pos,
                 des_force=des_force, enable=enable.T)


def _stage_cost(cfg: CentroidalMpcConfig, params: CentroidalParams, k, x, u,
                refs: _Refs, terminal: bool):
    """Cost of node k. For k < N includes input terms; node N is tracking only.

    Exactly the reference objective (CentroidalMPC.cpp:203-232) mapped onto
    the augmented state; see module docstring for the z-weight quirk.
    """
    import numpy as onp
    w = onp.asarray(cfg.weights, cfg.dtype)
    nl = cfg.num_legs
    com_pos, com_vel, ang_mom, foot_pos, f_prev = unpack_state(params, x)

    dcp = com_pos - refs.des_com_pos[k]
    dcv = com_vel - refs.des_com_vel[k]
    dam = ang_mom - refs.des_ang_mom[k]
    wz = (w[2] / 2) * jnp.exp(-k.astype(cfg.dtype)) + w[2] / 2
    c = (w[0] * dcp[0] ** 2 + w[1] * dcp[1] ** 2 + (wz * dcp[2]) ** 2
         + w[3] * dcv[0] ** 2 + w[4] * dcv[1] ** 2 + w[5] * dcv[2] ** 2
         + w[6] * dam[0] ** 2 + w[7] * dam[1] ** 2 + w[8] * dam[2] ** 2)

    w_fp = w[9:9 + 3 * nl].reshape(nl, 3)
    dfp = foot_pos - refs.des_foot_pos[:, k, :]
    c += jnp.sum(w_fp * dfp ** 2)

    if not terminal:
        e = refs.enable[k][:, None]  # (nl, 1)
        foot_vel, u_f = unpack_input(params, u)
        f_eff = e * u_f
        w_f = w[9 + 3 * nl:9 + 6 * nl].reshape(nl, 3)
        c += jnp.sum(w_f * (f_eff - refs.des_force[:, k, :]) ** 2)
        # Force-rate term: at stage k >= 1, (F_k - F_{k-1}) with F_{k-1}
        # stored in the augmented state.
        w_r = w[9 + 6 * nl:9 + 9 * nl].reshape(nl, 3)
        rate = f_eff - f_prev
        c += jnp.where(k > 0, jnp.sum(w_r * rate ** 2), 0.0)
        # Regularizers (ours; pin coordinates the reference leaves to IPOPT).
        c += cfg.reg_eps * (jnp.sum(foot_vel ** 2)
                            + jnp.sum((1.0 - e) * u_f ** 2))
    return c


def _friction_pyramid(mu, dtype):
    """5x3 pyramid rows {(-1,0,mu),(1,0,mu),(0,-1,mu),(0,1,mu),(0,0,1)}
    (CentroidalMPC.cpp:186-190)."""
    return jnp.array([[-1.0, 0.0, mu], [1.0, 0.0, mu], [0.0, -1.0, mu],
                      [0.0, 1.0, mu], [0.0, 0.0, 1.0]], dtype)


def _constraint_constants(cfg: CentroidalMpcConfig, params: CentroidalParams):
    """Static constraint matrices (numpy, so they lower as HLO literals).

    Row layout per node (ng = 5*nl + 3*nl):
      [0, 5nl)       friction pyramid rows, leg-major (masked by enable;
                     nodes 0..N-1 only)
      [5nl, 5nl+3nl) footstep box rows (nodes 1..N; reference applies the
                     box to foot positions at nodes 1..N, CentroidalMPC.cpp:
                     196-198)
    """
    import numpy as onp
    nl, N = cfg.num_legs, cfg.horizon
    dt_ = cfg.dtype
    nx, nu = params.nx, params.nu
    ng = 8 * nl
    C = onp.zeros((N + 1, ng, nx), dt_)
    D = onp.zeros((N + 1, ng, nu), dt_)
    ug_fr = onp.zeros((N + 1, 5 * nl), dt_)
    for i in range(nl):
        m = float(cfg.mu[i])
        pyr = onp.array([[-1.0, 0.0, m], [1.0, 0.0, m], [0.0, -1.0, m],
                         [0.0, 1.0, m], [0.0, 0.0, 1.0]], dt_)
        D[:N, 5 * i:5 * (i + 1), 3 * nl + 3 * i:3 * nl + 3 * (i + 1)] = pyr
        C[:, 5 * nl + 3 * i:5 * nl + 3 * (i + 1),
          9 + 3 * i:9 + 3 * (i + 1)] = onp.eye(3, dtype=dt_)
    force_ub = onp.array([cfg.force_max] * 4 + [cfg.mass * GRAVITY * nl],
                         dt_)
    ug_fr[:N] = onp.tile(force_ub, nl)[None, :]
    box_mask = onp.zeros((N + 1, 3 * nl), dt_)
    box_mask[1:] = 1.0  # nodes 1..N only
    return C, D, ug_fr, box_mask


def _build_constraints(cfg: CentroidalMpcConfig, params: CentroidalParams,
                       refs: _Refs, x_traj, u_traj) -> StageConstraint:
    """Stage constraints in deviation coordinates around the iterate
    (constants from :func:`_constraint_constants`; bounds/masks assembled by
    concatenation of traced and literal blocks)."""
    import numpy as onp
    nl, N = cfg.num_legs, cfg.horizon
    dt_ = cfg.dtype
    C, D, ug_fr, box_mask = _constraint_constants(cfg, params)

    # Bounds: friction rows [0, ug_fr]; box rows des +- step bounds.
    step_lb = onp.asarray(cfg.foot_step_lb, dt_)
    step_ub = onp.asarray(cfg.foot_step_ub, dt_)
    des_box = refs.des_foot_pos.transpose(1, 0, 2).reshape(N + 1, 3 * nl)
    lg = jnp.concatenate(
        [onp.zeros((N + 1, 5 * nl), dt_),
         des_box + onp.tile(step_lb, nl)[None, :]], axis=1)
    ug = jnp.concatenate(
        [ug_fr, des_box + onp.tile(step_ub, nl)[None, :]], axis=1)
    mask = jnp.concatenate(
        [jnp.concatenate([jnp.repeat(refs.enable, 5, axis=1),
                          onp.zeros((1, 5 * nl), dt_)], axis=0),
         box_mask], axis=1)

    # Shift to deviation coordinates: lg - g(iterate) <= J dz <= ug - g.
    du_pad = jnp.concatenate([u_traj, jnp.zeros_like(u_traj[:1])], axis=0)
    g_iter = (jnp.einsum('nij,nj->ni', C, x_traj)
              + jnp.einsum('nij,nj->ni', D, du_pad))
    return StageConstraint(C=C, D=D, lg=lg - g_iter, ug=ug - g_iter,
                           mask=mask)


def build_centroidal_solver(cfg: CentroidalMpcConfig,
                            scp: ScpSettings = ScpSettings()):
    """Returns a jittable ``solve(state, des_state, des_inputs) ->
    CentroidalSolution`` closure over the static config.

    The returned function is pure; batch it with ``jax.vmap`` and shard with
    ``jax.jit(..., in_shardings=...)`` over a mesh for multi-chip scaling.
    """
    import numpy as np
    # Keep build-time constants as numpy, not device arrays: numpy
    # constants are baked into the HLO as literals.
    params = CentroidalParams.create(cfg.mass, cfg.num_legs, cfg.dt,
                                     np.asarray(cfg.mu))
    params = jax.tree.map(lambda a: np.asarray(a, cfg.dtype), params)
    N, nl = cfg.horizon, cfg.num_legs
    nx, nu = params.nx, params.nu
    ks = np.arange(N + 1, dtype=np.int32)

    def total_cost(x_traj, u_traj, refs):
        stage = jax.vmap(
            lambda k, x, u: _stage_cost(cfg, params, k, x, u, refs, False)
        )(ks[:-1], x_traj[:-1], u_traj)
        term = _stage_cost(cfg, params, ks[-1], x_traj[-1],
                           np.zeros((nu,), cfg.dtype), refs, True)
        return jnp.sum(stage) + term

    def make_perf(refs):
        """PerformanceIndex callback (cost + exact-L1-penalty merit +
        violation components) for the filter line search."""

        def dyn_defects(x_traj, u_traj):
            xn = jax.vmap(lambda x, u, e: centroidal_step(params, x, u, e))(
                x_traj[:-1], u_traj, refs.enable)
            return xn - x_traj[1:]

        def ineq_violations(x_traj, u_traj):
            # In deviation coords around (x_traj, u_traj), dz = 0: violation
            # is how far 0 lies outside [lg, ug].
            con = _build_constraints(cfg, params, refs, x_traj, u_traj)
            return con.mask * (jnp.maximum(con.lg, 0.0)
                               + jnp.maximum(-con.ug, 0.0))

        return make_performance(
            total_cost=lambda x, u: total_cost(x, u, refs),
            dyn_defects=dyn_defects, ineq_violations=ineq_violations)

    def linearize(x_traj, u_traj, refs):
        A, B, f = jax.vmap(
            lambda x, u, e: linearize_step(params, x, u, e)
        )(x_traj[:-1], u_traj, refs.enable)
        dyn = DynamicsLin(A=A, B=B, b=f - x_traj[1:])

        def stage_quad(k, x, u):
            fn = lambda xu: _stage_cost(cfg, params, k, xu[:nx], xu[nx:],
                                        refs, False)
            xu = jnp.concatenate([x, u])
            g = jax.grad(fn)(xu)
            H = jax.hessian(fn)(xu)
            return (H[:nx, :nx], g[:nx], H[nx:, nx:], g[nx:], H[nx:, :nx])

        Qs, qs, Rs, rs, Ss = jax.vmap(stage_quad)(ks[:-1], x_traj[:-1], u_traj)
        fnN = lambda x: _stage_cost(cfg, params, ks[-1], x,
                                    np.zeros((nu,), cfg.dtype), refs, True)
        QN = jax.hessian(fnN)(x_traj[-1])
        qN = jax.grad(fnN)(x_traj[-1])
        cost = CostApprox(Q=jnp.concatenate([Qs, QN[None]]),
                          q=jnp.concatenate([qs, qN[None]]),
                          R=Rs, r=rs, S=Ss)
        con = _build_constraints(cfg, params, refs, x_traj, u_traj)
        return OcpQpData(dyn=dyn, cost=cost, con=con,
                         dx0=np.zeros((nx,), cfg.dtype))

    def solve(state, des_state, des_inputs,
              warm: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None):
        refs = _unpack_reference_inputs(cfg, state, des_state, des_inputs)
        if warm is None:
            foot_vel0 = np.zeros((N, 3 * nl), cfg.dtype)
            u_f0 = refs.des_force.transpose(1, 0, 2).reshape(N, 3 * nl)
            u_init = jnp.concatenate([foot_vel0, u_f0], axis=-1)
            x_init = rollout(params, refs.x0, u_init, refs.enable)
        else:
            x_init, u_init = warm
            x_init = x_init.at[0].set(refs.x0)

        res = solve_nonlinear_ocp(
            linearize=lambda x, u: linearize(x, u, refs),
            performance=make_perf(refs),
            x_init=x_init, u_init=u_init, settings=scp)

        _, _, _, foot_pos, _ = unpack_state(params, res.x)  # (N+1, nl, 3)
        _, u_f = unpack_input(params, res.u)  # (N, nl, 3)
        f_eff = refs.enable[:, :, None] * u_f
        return CentroidalSolution(
            foot_pos=foot_pos.transpose(1, 2, 0),
            contact_force=f_eff.transpose(1, 2, 0),
            com_pos=res.x[:, 0:3].T, com_vel=res.x[:, 3:6].T,
            ang_mom=res.x[:, 6:9].T,
            x_traj=res.x, u_traj=res.u, merit=res.merit, qp_mu=res.qp_mu,
            gains_K=res.gains_K, gains_P=res.gains_P, gains_p=res.gains_p,
            performance=res.performance, convergence=res.convergence)

    return solve


def build_centroidal_mpc_loop(cfg: CentroidalMpcConfig,
                              scp: ScpSettings = ScpSettings(),
                              n_ticks: int = 20):
    """An n-tick receding-horizon MPC loop that runs ENTIRELY on device:
    ``lax.scan`` over {solve (warm-started RTI) -> apply u0 -> plant step},
    plant == model (the reference dummy-loop semantics,
    MRT_ROS_Dummy_Loop.cpp:171-185).

    Purpose: amortize the host<->device dispatch cost across many replans:
    one dispatch covers ``n_ticks`` replans. Returns
    ``fn(state, des_state, des_inputs) -> (states, forces)`` with
    ``states`` (n_ticks, nx_aug) and ``forces`` (n_ticks, num_legs, 3).

    The desired trajectories are held (a hold/stand command); the contact
    table is taken from ``des_inputs`` unchanged each tick, so use a
    constant-contact scenario (e.g. stance) unless the table is
    tick-invariant.
    """
    import numpy as np
    params = CentroidalParams.create(cfg.mass, cfg.num_legs, cfg.dt,
                                     np.asarray(cfg.mu))
    params = jax.tree.map(lambda a: np.asarray(a, cfg.dtype), params)
    solve = build_centroidal_solver(cfg, scp)
    nl = cfg.num_legs

    def loop(state, des_state, des_inputs):
        refs = _unpack_reference_inputs(cfg, state, des_state, des_inputs)
        sol0 = solve(state, des_state, des_inputs)

        def tick(carry, _):
            x_aug, x_w, u_w = carry
            # Re-pack the physical state (augmented state's first
            # 9 + 3*nl entries ARE the packed layout; f_prev is carried
            # implicitly by the warm start).
            st = x_aug[:9 + 3 * nl]
            res = solve(st, des_state, des_inputs, warm=(x_w, u_w))
            u0 = res.u_traj[0]
            x_next = centroidal_step(params, res.x_traj[0], u0,
                                     refs.enable[0])
            x_w2 = jnp.concatenate([res.x_traj[1:], res.x_traj[-1:]])
            u_w2 = jnp.concatenate([res.u_traj[1:], res.u_traj[-1:]])
            _, u_f = unpack_input(params, u0)
            f0 = refs.enable[0][:, None] * u_f
            return (x_next, x_w2, u_w2), (x_next, f0)

        init = (sol0.x_traj[0], sol0.x_traj, sol0.u_traj)
        _, (xs, fs) = jax.lax.scan(tick, init, None, length=n_ticks)
        return xs, fs

    return loop


class CentroidalMPC:
    """Object-style facade mirroring the reference class API
    (``CentroidalMPC.h:15-33``: ctor -> SetupMPC -> UpdateMPC)."""

    def __init__(self, mass, num_legs, predict_horizon, time_step, weights,
                 mu, dtype=jnp.float32, scp: ScpSettings = ScpSettings()):
        self.config = CentroidalMpcConfig(
            mass=float(mass), num_legs=int(num_legs),
            horizon=int(predict_horizon), dt=float(time_step),
            weights=tuple(float(w) for w in weights),
            mu=tuple(float(m) for m in mu), dtype=dtype)
        self._scp = scp
        self._solve = None

    def setup_mpc(self):
        """Builds and jits the solver (the reference compiles the Opti into a
        single casadi::Function here, CentroidalMPC.cpp:275)."""
        self._solve = jax.jit(build_centroidal_solver(self.config, self._scp))
        return self

    def update_mpc(self, state, des_state, des_inputs) -> CentroidalSolution:
        """One MPC solve on reference-layout packed inputs.

        Unlike the reference (which prints and returns an empty vector,
        CentroidalMPC.cpp:369), this returns the full solution.
        """
        if self._solve is None:
            raise RuntimeError("call setup_mpc() first")
        return self._solve(jnp.asarray(state), jnp.asarray(des_state),
                           jnp.asarray(des_inputs))
