"""Multi-chip scaling path: batch sharding over a virtual 8-device mesh.

CI stand-in for real multi-chip hardware (conftest forces
xla_force_host_platform_device_count=8); the driver separately dry-runs
__graft_entry__.dryrun_multichip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cheeta_mpc.examples import NOMINAL_FEET, trot_table
from cheeta_mpc.models.srb import SrbParams
from cheeta_mpc.mpc.convex_mpc import ConvexMpcConfig, build_convex_mpc
from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.parallel.mesh import (make_mesh, shard_batch,
                                      sharded_batch_solver)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_convex_mpc_batch():
    params = SrbParams(mass=9.0, inertia=(0.07, 0.26, 0.24), mu=0.5,
                       fz_max=250.0)
    cfg = ConvexMpcConfig(params=params, horizon=6, dt=0.03,
                          dtype=jnp.float64)
    mesh = make_mesh()
    solve_one = build_convex_mpc(cfg, IpmSettings(iters=15))
    solve = sharded_batch_solver(solve_one, mesh)

    B = 16  # 2 per device
    x0 = np.zeros((B, 13))
    x0[:, 5] = 0.3 + 0.005 * np.arange(B)
    x0[:, 12] = 1.0
    ref = np.tile(x0[:, None, :], (1, cfg.horizon + 1, 1))
    feet = np.tile(NOMINAL_FEET[None], (B, 1, 1))
    enable = np.tile(trot_table(cfg.horizon)[None], (B, 1, 1))

    args = shard_batch(mesh, tuple(jnp.asarray(a) for a in
                                   (x0, ref, feet, enable)))
    with mesh:
        forces, sols = solve(*args)
        jax.block_until_ready(forces)
    forces = np.asarray(forces)
    assert forces.shape == (B, cfg.horizon, 4, 3)
    assert np.isfinite(forces).all()
    # Each element's solution matches its unsharded single solve.
    f_single, _ = jax.jit(solve_one)(jnp.asarray(x0[3]), jnp.asarray(ref[3]),
                                     jnp.asarray(feet[3]),
                                     jnp.asarray(enable[3]))
    np.testing.assert_allclose(forces[3], np.asarray(f_single), atol=1e-6)
    # Output really is sharded over the mesh.
    shard_devs = {s.device for s in forces_device_shards(sols.mu)}
    assert len(shard_devs) == 8


def forces_device_shards(arr):
    return arr.addressable_shards


def test_psum_metric_reduction():
    """Cross-device metric reduction across the batch axis (solver health
    counters aggregated with a collective, SURVEY.md §2.8)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = make_mesh()
    xs = jnp.arange(16.0)
    xs = jax.device_put(xs, NamedSharding(mesh, P("batch")))

    @jax.jit
    def total(v):
        return jnp.sum(v)  # XLA inserts the cross-device reduction

    assert float(total(xs)) == sum(range(16))


def test_aggregate_fleet_health():
    """The framework's explicit shard_map+psum health reduction: correct
    counts/moments, replicated result, O(1)-per-device collectives."""
    from cheeta_mpc.parallel.mesh import aggregate_fleet_health
    from cheeta_mpc.solvers.scp import (CONV_FALSE, CONV_ITERATIONS,
                                        CONV_METRICS, CONV_STEPSIZE)
    mesh = make_mesh()
    B = 16
    rng = np.random.default_rng(7)
    mu = jnp.asarray(rng.uniform(1e-6, 1e-4, B))
    conv = np.full(B, CONV_STEPSIZE, np.int32)
    conv[3] = CONV_FALSE
    conv[5] = CONV_ITERATIONS
    conv[9] = CONV_METRICS
    merit = rng.uniform(10.0, 20.0, B)
    merit[7] = np.nan  # one failed element: masked, not thrown
    args = shard_batch(mesh, (mu, jnp.asarray(conv), jnp.asarray(merit)))
    with mesh:
        h = aggregate_fleet_health(mesh, *args)
    assert int(h.n_solves) == B
    assert int(h.n_converged) == B - 2  # CONV_FALSE + CONV_ITERATIONS
    assert int(h.n_nonfinite) == 1
    finite = np.isfinite(merit)
    np.testing.assert_allclose(float(h.merit_mean), merit[finite].mean(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(h.mu_mean),
                               np.asarray(mu)[finite].mean(), rtol=1e-6)
    np.testing.assert_allclose(float(h.mu_max),
                               np.asarray(mu)[finite].max(), rtol=1e-6)
    # Replicated output: every device holds the same scalar.
    assert len({s.device for s in h.mu_mean.addressable_shards}) == 8
