from cheeta_mpc.core.types import (  # noqa: F401
    CostApprox,
    DynamicsLin,
    OcpQpData,
    OcpQpSolution,
    PerformanceIndex,
    StageConstraint,
)
