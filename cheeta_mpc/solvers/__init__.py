from cheeta_mpc.solvers.scp import (ScpResult, ScpSettings,  # noqa: F401
                                    StepInfo, make_performance,
                                    solve_nonlinear_ocp)
