"""cheeta_mpc — an accelerator-resident MPC framework.

A from-scratch JAX/XLA re-design of the capability surface of
HuNingHe/Cheeta-MPC (a CasADi/IPOPT centroidal MPC + an OCS2-based SQP
legged-robot MPC stack, reference at /root/reference):

- ``core``     : pytree problem/solution types (LQ approximations, OCP-QP data,
                 performance indices, target trajectories) — the analogue of the
                 external ``ocs2_core``/``ocs2_oc`` structs the reference leans on.
- ``models``   : robot dynamics models (centroidal, SRBD legged robot) with
                 analytic/jacfwd derivatives replacing CasADi and CppAD codegen.
- ``ops``      : the numeric kernels — Riccati scans, the structured interior-point
                 OCP-QP solver (the HPIPM/BLASFEO equivalent), constraint
                 projection, condensing. Batched via vmap, sharded via pjit.
- ``solvers``  : SQP multiple-shooting layer (the ``ocs2_sqp`` equivalent).
- ``mpc``      : MPC/MRT runtime (the ``ocs2_mpc`` equivalent) + CentroidalMPC.
- ``gait``     : gait schedule / mode sequence / swing trajectory planning
                 (the ``ocs2_legged_robot`` gait layer).
- ``parallel`` : device mesh + sharding helpers for multi-chip scenario batches.
- ``utils``    : timing, config ingestion (.info property-tree files).

Everything on the compute path is functional, statically shaped, and jit/vmap/
pjit-compatible. Scenario batching (thousands of MPC instances per chip) is the
first-class scaling axis; the horizon lives on-chip.
"""

__version__ = "0.1.0"

from cheeta_mpc.core import types  # noqa: F401
