"""Core pytree problem/solution types.

These are the analogues of the structs the reference stack passes
between layers (reference: ocs2 ``VectorFunctionLinearApproximation`` /
``ScalarFunctionQuadraticApproximation`` consumed by
``ocs2_sqp/hpipm_catkin/src/HpipmInterface.cpp`` and
``ocs2_sqp/ocs2_sqp/src/MultipleShootingTranscription.cpp``, and the per-stage
dimension descriptor ``OcpSize`` in
``ocs2_sqp/hpipm_catkin/include/hpipm_catkin/OcpSize.h:51-75``).

Unlike the reference, all stages are stacked into leading-axis arrays with
*static* shapes so the whole horizon lives on-chip and the solver is a single
XLA program; batching over scenarios is ``vmap`` over an extra leading axis.
Variable per-stage constraint counts (the reference's ``numIneqConstraints``)
become a fixed ``ng`` with an activity ``mask``.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from cheeta_mpc.core import struct


@struct.dataclass
class DynamicsLin:
    """Linearized discrete dynamics, stacked over the horizon.

    ``dx_{k+1} = A[k] @ dx_k + B[k] @ du_k + b[k]`` for k = 0..N-1, where ``b``
    is the affine term — in an SQP context it is the shooting *defect*
    ``f(x_k, u_k) - x_{k+1}`` of the current iterate (reference:
    MultipleShootingTranscription.cpp:52-55).
    """

    A: jnp.ndarray  # (N, nx, nx)
    B: jnp.ndarray  # (N, nx, nu)
    b: jnp.ndarray  # (N, nx)

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]


@struct.dataclass
class CostApprox:
    """Quadratic cost approximation, stacked over the horizon.

    Stage cost  (k < N): ``1/2 dz' [Q S'; S R] dz + [q; r]' dz`` with
    ``dz = (dx_k, du_k)`` and ``S`` of shape (nu, nx) (d2/dudx).
    Terminal (k = N): ``Q[N], q[N]`` only; the trailing entries of R/S/r are
    ignored (arrays are sized N for input blocks, N+1 for state blocks).
    """

    Q: jnp.ndarray  # (N+1, nx, nx)
    q: jnp.ndarray  # (N+1, nx)
    R: jnp.ndarray  # (N, nu, nu)
    r: jnp.ndarray  # (N, nu)
    S: jnp.ndarray  # (N, nu, nx)


@struct.dataclass
class StageConstraint:
    """Two-sided general inequality constraints per node, with activity mask.

    ``lg[k] <= C[k] @ dx_k + D[k] @ du_k <= ug[k]`` on the rows where
    ``mask[k]`` is 1. Equalities may be encoded as ``lg == ug`` only by the
    projection path, not the IPM (matching HPIPM's two-sided ``lg/ug``
    convention at HpipmInterface.cpp:223-264, but with masks replacing
    per-stage row counts). Node N (terminal) has ``D`` ignored.
    """

    C: jnp.ndarray  # (N+1, ng, nx)
    D: jnp.ndarray  # (N+1, ng, nu)  (terminal slice unused)
    lg: jnp.ndarray  # (N+1, ng)
    ug: jnp.ndarray  # (N+1, ng)
    mask: jnp.ndarray  # (N+1, ng)  1.0 = active row, 0.0 = inert row

    @property
    def ng(self) -> int:
        return self.C.shape[-2]


@struct.dataclass
class StageEquality:
    """Masked per-stage state-input equalities ``C dx + D du + e = 0``
    (k = 0..N-1 only; the reference has no terminal equalities either).

    The capability equivalent of the reference's projected equality
    constraints (MultipleShootingTranscription.cpp:67-82): rows follow the
    contact mode via ``mask`` (1 = active); inactive rows must be zeroed in
    C/D/e and receive dual regularization inside the Riccati elimination so
    all shapes stay static.
    """

    C: jnp.ndarray  # (N, nc, nx)
    D: jnp.ndarray  # (N, nc, nu)
    e: jnp.ndarray  # (N, nc)
    mask: jnp.ndarray  # (N, nc)

    @property
    def nc(self) -> int:
        return self.C.shape[-2]


@struct.dataclass
class OcpQpData:
    """A full OCP-structured QP: dynamics + cost + constraints + initial state.

    ``dx0`` is the *given* initial state deviation; stage-0 state is not a free
    variable (the reference eliminates x0 inside HpipmInterface.cpp:92-129; here
    the Riccati forward pass simply starts from ``dx0``).
    """

    dyn: DynamicsLin
    cost: CostApprox
    con: Optional[StageConstraint]
    dx0: jnp.ndarray  # (nx,)
    eq: Optional[StageEquality] = None


@struct.dataclass
class RiccatiGains:
    """Riccati factorization products, the policy/value-function surface.

    Mirrors what the reference extracts from HPIPM's memory:
    feedback ``K`` (getRiccatiFeedback, HpipmInterface.cpp:330-366),
    feedforward ``k`` (:368-398) and cost-to-go ``{P, p}`` per node
    (getRiccatiCostToGo, :400-455). No stage-0 reconstruction is needed here
    because the recursion keeps stage 0 explicit.
    """

    K: jnp.ndarray  # (N, nu, nx)
    k: jnp.ndarray  # (N, nu)
    P: jnp.ndarray  # (N+1, nx, nx)
    p: jnp.ndarray  # (N+1, nx)


@struct.dataclass
class OcpQpSolution:
    """Primal/dual solution of an OCP-QP plus solver diagnostics."""

    dx: jnp.ndarray  # (N+1, nx)
    du: jnp.ndarray  # (N, nu)
    gains: RiccatiGains
    # Inequality duals/slacks (zeros when the problem has no constraints):
    lam_l: jnp.ndarray  # (N+1, ng)
    lam_u: jnp.ndarray  # (N+1, ng)
    s_l: jnp.ndarray  # (N+1, ng)
    s_u: jnp.ndarray  # (N+1, ng)
    # Diagnostics (scalars; under vmap they become per-batch-element):
    iterations: jnp.ndarray
    mu: jnp.ndarray  # final complementarity measure
    stat_res: jnp.ndarray  # stationarity residual inf-norm
    ineq_res: jnp.ndarray  # inequality violation inf-norm
    eq_res: jnp.ndarray  # dynamics defect inf-norm (post-step)


@struct.dataclass
class PerformanceIndex:
    """Merit-function components, the reference's ``PerformanceIndex``
    (logged per SQP iteration, MultipleShootingSolver.cpp:190-191)."""

    merit: jnp.ndarray
    cost: jnp.ndarray
    dyn_violation_sse: jnp.ndarray
    eq_constraint_sse: jnp.ndarray
    ineq_constraint_sse: jnp.ndarray

    @classmethod
    def zeros(cls, dtype=jnp.float32) -> "PerformanceIndex":
        z = jnp.zeros((), dtype)
        return cls(merit=z, cost=z, dyn_violation_sse=z,
                   eq_constraint_sse=z, ineq_constraint_sse=z)


def symmetrize(M: jnp.ndarray) -> jnp.ndarray:
    """Numerical symmetrization of (batched) square matrices."""
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))
