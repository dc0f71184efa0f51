"""Contact-timing variation sweep: BASELINE.json config 3.

"CentroidalMPC with contact-timing variation (bound/pace/gallop gait table
sweep)" — one vmapped solve over a batch whose only varying axis is the
contact-enable table (the ``mpc_table`` of reference
CentroidalMPC.cpp:326-335). Certifies that the structural force gating,
weight distribution and dynamics hold for every gait timing, not just the
CentoidMPCTest trot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cheeta_mpc.examples import (TEST_WEIGHTS, gait_table,
                                 make_example_inputs, trot_table)
from cheeta_mpc.mpc.centroidal_mpc import CentroidalMpcConfig, \
    build_centroidal_solver
from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.solvers.scp import ScpSettings

GAITS = ("trot", "bound", "pace", "gallop")
N = 10
CFG = CentroidalMpcConfig(mass=8.0, num_legs=4, horizon=N, dt=0.01,
                          weights=tuple(TEST_WEIGHTS), mu=(0.8,) * 4,
                          dtype=jnp.float64)


def test_gait_table_generator_properties():
    # Pair gaits: exactly two legs in stance at every step; the two phases
    # cover all four legs.
    for kind in ("trot", "bound", "pace", "gallop"):
        t = gait_table(kind, 12)
        assert t.shape == (12, 4)
        assert (t.sum(axis=1) == 2.0).all(), kind
        assert (t.sum(axis=0) == 6.0).all(), kind  # 50% duty per leg
    assert (gait_table("stance", 5) == 1.0).all()
    # trot_table and gait_table('trot') agree (same diagonal pairs).
    assert np.array_equal(gait_table("trot", 10), trot_table(10))
    # The four dynamic gaits are pairwise distinct timings.
    tables = [gait_table(k, 12) for k in GAITS]
    for i in range(len(tables)):
        for j in range(i + 1, len(tables)):
            assert not np.array_equal(tables[i], tables[j])
    with pytest.raises(ValueError):
        gait_table("moonwalk", 10)


@pytest.fixture(scope="module")
def sweep_solution():
    solve = jax.jit(jax.vmap(build_centroidal_solver(
        CFG, ScpSettings(iterations=3, ipm=IpmSettings(iters=15)))))
    packed = [make_example_inputs(CFG, seed=0, gait=g) for g in GAITS]
    args = tuple(jnp.asarray(np.stack([p[k] for p in packed]), CFG.dtype)
                 for k in range(3))
    tables = np.stack([gait_table(g, N) for g in GAITS])  # (G, N, 4)
    return solve(*args), tables


def test_sweep_finite(sweep_solution):
    sol, _ = sweep_solution
    for leaf in jax.tree_util.tree_leaves(sol):
        assert np.isfinite(np.asarray(leaf)).all()


def test_sweep_swing_forces_zero(sweep_solution):
    sol, tables = sweep_solution
    force = np.asarray(sol.contact_force)  # (G, legs, 3, N)
    swing = tables.transpose(0, 2, 1)[:, :, None, :] < 0.5  # (G, legs, 1, N)
    leak = np.abs(force[np.broadcast_to(swing, force.shape)]).max()
    assert leak == 0.0


def test_sweep_weight_support(sweep_solution):
    sol, _ = sweep_solution
    force = np.asarray(sol.contact_force)
    fz_tot = force[:, :, 2, :].sum(axis=1)  # (G, N)
    weight = 8.0 * 9.81
    # Per-step: transient dips at contact-pair switches are part of the
    # optimal tradeoff (force-rate + CoM tracking terms), so the per-step
    # band is wide; the horizon mean must sit close to the weight.
    assert (np.abs(fz_tot - weight) < 0.5 * weight).all()
    assert (np.abs(fz_tot.mean(axis=1) - weight) < 0.25 * weight).all()


def test_sweep_friction_cones(sweep_solution):
    sol, tables = sweep_solution
    force = np.asarray(sol.contact_force)
    fx, fy, fz = force[:, :, 0, :], force[:, :, 1, :], force[:, :, 2, :]
    stance = tables.transpose(0, 2, 1) > 0.5
    tol = 1e-6
    assert (fz[stance] >= -tol).all()
    assert (np.abs(fx[stance]) <= 0.8 * fz[stance] + tol).all()
    assert (np.abs(fy[stance]) <= 0.8 * fz[stance] + tol).all()
