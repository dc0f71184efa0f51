"""On-device n-tick MPC loop (dispatch-amortization path).

The loop (mpc/centroidal_mpc.build_centroidal_mpc_loop) runs
{warm-started RTI solve -> apply u0 -> plant step} under lax.scan entirely
on device, so ONE host dispatch covers n replans — the mitigation for
transport-dominated environments where a per-solve round trip would cap the
wall-clock replanning rate (reference target: 50 Hz, task.info:108).
Plant == model, the reference dummy-loop semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.examples import TEST_WEIGHTS, make_example_inputs
from cheeta_mpc.mpc.centroidal_mpc import (CentroidalMpcConfig,
                                           build_centroidal_mpc_loop,
                                           build_centroidal_solver)
from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.solvers.scp import ScpSettings


def _stance_inputs(cfg):
    state, des, dins = make_example_inputs(cfg)
    dins = np.asarray(dins).copy()
    N = cfg.horizon
    for i in range(4):  # all-stance contact table (hold command)
        dins[i * (4 * N + 3):i * (4 * N + 3) + N] = 1.0
    return (jnp.asarray(state), jnp.asarray(des), jnp.asarray(dins))


def test_loop_regulates_and_supports_weight():
    cfg = CentroidalMpcConfig(mass=8.0, num_legs=4, horizon=6, dt=0.01,
                              weights=tuple(TEST_WEIGHTS), mu=(0.8,) * 4,
                              dtype=jnp.float32)
    n_ticks = 8
    scp = ScpSettings(iterations=1, ipm=IpmSettings(iters=6))
    loop = jax.jit(build_centroidal_mpc_loop(cfg, scp, n_ticks=n_ticks))
    args = _stance_inputs(cfg)
    xs, fs = loop(*args)
    xs, fs = np.asarray(xs), np.asarray(fs)
    assert xs.shape == (n_ticks, 33) and fs.shape == (n_ticks, 4, 3)
    assert np.isfinite(xs).all() and np.isfinite(fs).all()
    # Every tick's total Fz supports the weight (m g = 78.48 N) within 5%.
    fz = fs[:, :, 2].sum(axis=1)
    assert (np.abs(fz - 78.48) < 0.05 * 78.48).all(), fz
    # The state stays regulated: CoM height change across the loop is tiny.
    assert np.abs(xs[-1, 2] - xs[0, 2]) < 0.01


def test_loop_first_tick_matches_single_solve():
    """Tick 0 of the loop == a cold solve followed by one plant step (the
    loop is the same controller, just fused on device)."""
    cfg = CentroidalMpcConfig(mass=8.0, num_legs=4, horizon=5, dt=0.01,
                              weights=tuple(TEST_WEIGHTS), mu=(0.8,) * 4,
                              dtype=jnp.float32)
    scp = ScpSettings(iterations=1, ipm=IpmSettings(iters=6))
    args = _stance_inputs(cfg)
    loop = jax.jit(build_centroidal_mpc_loop(cfg, scp, n_ticks=2))
    _, fs = loop(*args)
    solve = jax.jit(build_centroidal_solver(cfg, scp))
    # The loop's tick 0 re-solves from the same state with the cold solve's
    # own trajectory as warm start; its u0 equals the warm re-solve's u0.
    sol = solve(*args)
    sol_w = solve(*args, warm=(sol.x_traj, sol.u_traj))
    f_direct = np.asarray(sol_w.contact_force)[:, :, 0]  # (legs, 3) at k=0
    np.testing.assert_allclose(np.asarray(fs)[0], f_direct, atol=1e-4)
