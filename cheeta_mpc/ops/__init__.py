from cheeta_mpc.ops.riccati import (  # noqa: F401
    lqr_forward,
    riccati_factorize,
    riccati_vector,
    solve_lqr,
)
