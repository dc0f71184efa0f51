"""Device mesh + sharding helpers for multi-chip scenario batches.

The reference has no data/model parallelism — its concurrency is a thread
pool inside one solver plus a ROS process split (SURVEY.md §2.8). This
framework's headline scaling axis is the *scenario batch*: thousands of MPC
instances (gait x terrain x command grids) solved simultaneously, sharded
over a ``jax.sharding.Mesh`` so each device holds batch/n_devices solves.
The horizon and stage loops stay on the device; no cross-device
communication is needed inside a solve, so scaling is embarrassingly
parallel, with collectives only for metric reductions (psum of solve
counters / residuals).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "batch") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Multi-host runtime init (`jax.distributed.initialize`): hosts meet at
    the coordinator over DCN, after which ``jax.devices()`` is the *global*
    device list and a mesh built from it spans hosts. The role the reference
    fills with ROS networking (SURVEY.md §2.8) for its process split; here it
    is the scaling fabric for the scenario batch. Returns the process index.

    No-op (returns 0) when called without arguments in a single-process
    setting — callers can use it unconditionally."""
    if coordinator_address is None and num_processes is None:
        return 0
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index()


def make_global_mesh(axis_name: str = "batch") -> Mesh:
    """1-D mesh over ALL devices of ALL processes (multi-host: requires
    initialize_distributed first). Identical to make_mesh on one host."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def host_local_batch_to_global(mesh: Mesh, tree, axis_name: str = "batch"):
    """Assemble a global batch-sharded array from per-process local shards
    (each process supplies batch/num_processes rows) — the multi-host feed
    path: observations are produced host-locally, solved globally."""
    sharding = NamedSharding(mesh, P(axis_name))

    def one(x):
        global_shape = (x.shape[0] * jax.process_count(),) + x.shape[1:]
        return jax.make_array_from_process_local_data(sharding, x,
                                                      global_shape)

    return jax.tree.map(one, tree)


def shard_batch(mesh: Mesh, tree, axis_name: str = "batch"):
    """Place a batched pytree with its leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.device_put(tree, sharding)


def sharded_batch_solver(solve_one: Callable, mesh: Mesh,
                         axis_name: str = "batch",
                         static_argnums: Sequence[int] = ()) -> Callable:
    """vmap + jit a per-instance solver with batch-axis sharding constraints.

    ``solve_one(*args)`` is the single-scenario solver; the returned function
    takes leading-batch-axis args (batch divisible by mesh size), constrains
    inputs and outputs to be batch-sharded, and lets XLA run each shard's
    solves locally — cross-device traffic only at the caller's reductions.
    """
    batched = jax.vmap(solve_one)
    sharding = NamedSharding(mesh, P(axis_name))

    def fn(*args):
        args = jax.tree.map(lambda a: jax.lax.with_sharding_constraint(
            a, sharding), args)
        out = batched(*args)
        return jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(a, sharding), out)

    return jax.jit(fn, static_argnums=tuple(static_argnums))


class FleetHealth(NamedTuple):
    """Mesh-global solver-health aggregate (one record for the whole fleet).

    The multi-device analogue of the per-solve health surface the reference
    prints per robot (PerformanceIndex logging MultipleShootingSolver.cpp:
    190-191, HPIPM status/NaN guard HpipmInterface.cpp:303-328): counts and
    moments of the batch's solver outcomes, reduced across every device of
    the mesh with explicit collectives."""

    n_solves: jnp.ndarray  # total batch elements across the mesh
    n_converged: jnp.ndarray  # convergence code != CONV_FALSE/ITERATIONS
    n_nonfinite: jnp.ndarray  # failed elements (NaN/Inf merit) — failure
    #                           detection stays per-element, never throws
    mu_mean: jnp.ndarray  # mean final IPM complementarity
    mu_max: jnp.ndarray  # worst-case complementarity on any device
    merit_mean: jnp.ndarray  # mean merit (fleet objective health)


def aggregate_fleet_health(mesh: Mesh, qp_mu, convergence, merit,
                           axis_name: str = "batch") -> FleetHealth:
    """Reduce per-element solver health across the WHOLE mesh with explicit
    ``jax.shard_map`` + ``psum``/``pmax`` collectives.

    Args are batch-leading arrays (the corresponding ``ScpResult`` /
    ``CentroidalSolution`` fields, batch sharded over ``axis_name``).
    Returns a replicated :class:`FleetHealth`. This is the framework's
    cross-device reduction path — each device reduces its local shard to
    scalars first, so the cross-device traffic is O(1) per device regardless of
    batch size.
    """
    from cheeta_mpc.solvers.scp import CONV_METRICS, CONV_PRIMAL, \
        CONV_STEPSIZE

    def local_reduce(mu, conv, mer):
        # Per-device partial aggregates over the local shard...
        finite = jnp.isfinite(mer)
        conv_ok = ((conv == CONV_STEPSIZE) | (conv == CONV_METRICS)
                   | (conv == CONV_PRIMAL))
        n = jnp.asarray(mu.shape[0], jnp.float32)
        partial = (n,
                   jnp.sum(conv_ok.astype(jnp.float32)),
                   jnp.sum((~finite).astype(jnp.float32)),
                   jnp.sum(jnp.where(finite, mu, 0.0)),
                   jnp.sum(jnp.where(finite, mer, 0.0)))
        # ...then one explicit O(1) collective each across the mesh.
        n_g, c_g, bad_g, mu_sum, mer_sum = (
            jax.lax.psum(p, axis_name) for p in partial)
        mu_max = jax.lax.pmax(jnp.max(jnp.where(finite, mu, 0.0)), axis_name)
        denom = jnp.maximum(n_g - bad_g, 1.0)
        return FleetHealth(
            n_solves=n_g.astype(jnp.int32),
            n_converged=c_g.astype(jnp.int32),
            n_nonfinite=bad_g.astype(jnp.int32),
            mu_mean=mu_sum / denom, mu_max=mu_max,
            merit_mean=mer_sum / denom)

    fn = jax.shard_map(local_reduce, mesh=mesh,
                       in_specs=(P(axis_name), P(axis_name), P(axis_name)),
                       out_specs=P())  # replicated scalars
    return jax.jit(fn)(qp_mu, convergence, merit)
