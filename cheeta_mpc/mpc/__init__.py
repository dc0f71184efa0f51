from cheeta_mpc.mpc.centroidal_mpc import (  # noqa: F401
    CentroidalMPC,
    CentroidalMpcConfig,
    CentroidalSolution,
    build_centroidal_solver,
)
