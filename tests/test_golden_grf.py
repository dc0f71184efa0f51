"""Golden GRF match vs an independent NLP solve (BASELINE.json acceptance).

The reference's CentoidMPCTest (/root/reference/CentoidMPCTest.cpp:11-116)
prints its IPOPT solution without asserting. BASELINE.json's acceptance
criterion is per-solve GRF trajectories matching within 1e-3 at the same
horizon. Since IPOPT itself is not in the image, the independent solution
comes from :mod:`tests.oracle_nlp` — scipy ``trust-constr`` in f64 on the
raw dense formulation (fresh transcription, unrelated solution method). Both
solvers must land on the same KKT point of the same smooth NLP, so GRFs and
foot trajectories agree to solver tolerance.

Runs at N=6 (the committed reference test) and N=10 (the BASELINE.json
horizon) per BASELINE.md's discrepancy note.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # NLP-oracle/subprocess tier: run with --runslow

from cheeta_mpc.mpc.centroidal_mpc import (CentroidalMpcConfig,
                                           build_centroidal_solver)
from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.solvers.scp import ScpSettings

from tests.oracle_nlp import solve_oracle_nlp
from tests.test_centroidal_mpc import (DT, MASS, NUM_LEGS, WEIGHTS,
                                       reference_test_inputs)

SCP = ScpSettings(iterations=8, ipm=IpmSettings(iters=30))


def _match_case(horizon, state, des_state, des_input):
    cfg = CentroidalMpcConfig(mass=MASS, num_legs=NUM_LEGS, horizon=horizon,
                              dt=DT, weights=tuple(WEIGHTS), mu=(0.8,) * 4,
                              dtype=jnp.float64)
    solve = jax.jit(build_centroidal_solver(cfg, SCP))
    sol = solve(jnp.asarray(state), jnp.asarray(des_state),
                jnp.asarray(des_input))
    grf = np.asarray(sol.contact_force)  # (nl, 3, N)
    feet = np.asarray(sol.foot_pos)  # (nl, 3, N+1)

    o_grf, o_feet, res = solve_oracle_nlp(
        horizon, NUM_LEGS, MASS, DT, 0.8, WEIGHTS,
        state, des_state, des_input)
    assert res.constr_violation < 1e-8, (
        f"oracle infeasible: {res.status} {res.message}")
    assert res.optimality < 1e-6, (
        f"oracle did not converge: optimality {res.optimality:.2e} "
        f"({res.status} {res.message})")

    err_grf = np.abs(grf - o_grf).max()
    err_feet = np.abs(feet - o_feet).max()
    assert err_grf < 1e-3, f"GRF mismatch vs oracle: {err_grf:.2e}"
    assert err_feet < 1e-3, f"foot-pos mismatch vs oracle: {err_feet:.2e}"
    return err_grf, err_feet


def test_golden_grf_match_n6():
    """The exact CentoidMPCTest scenario (N=6)."""
    state, des_state, des_input, _ = reference_test_inputs()
    err_grf, err_feet = _match_case(6, state, des_state, des_input)
    # Report the achieved agreement for the record.
    print(f"N=6 GRF err {err_grf:.2e}, foot err {err_feet:.2e}")


def test_golden_grf_match_n10():
    """The BASELINE.json N=10 horizon on the extended scenario."""
    from cheeta_mpc.examples import make_example_inputs
    cfg = CentroidalMpcConfig(mass=MASS, num_legs=NUM_LEGS, horizon=10,
                              dt=DT, weights=tuple(WEIGHTS), mu=(0.8,) * 4,
                              dtype=jnp.float64)
    state, des_state, des_input = make_example_inputs(cfg)
    err_grf, err_feet = _match_case(10, state, des_state, des_input)
    print(f"N=10 GRF err {err_grf:.2e}, foot err {err_feet:.2e}")
